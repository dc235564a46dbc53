// K8's backward: the AfterstateNetwork evaluator's gradients under
// recompute -- bbx's nn.remat -- for the PPO update.  Given the scores'
// gradient ds, the inputs (K4's planes and features, the [B, 3, D]
// context) and the eight float32 parameters, it returns the parameters'
// gradients (float32) and the context's (compute type); the planes and
// features carry none.
//
// Replaces bbx/models/afterstate.py: _Evaluator (:106-127) under nn.remat
// (:185), whose backward XLA recomputes and differentiates layer by layer,
// and the port's plain version under torch.utils.checkpoint: cuDNN's data-
// and weight-gradient convolutions, a concatenation and cuBLAS GEMMs over
// [M, C, 8, 8] activations in device memory.
//
// Bound by operations: 1.35 M multiply-adds an afterstate in K8b at run9's
// widths (the recompute 507 K, dense0's data gradient 147.5 K, conv2's
// weight and data gradients 331.8 K each, conv1's weight gradient 27.6 K),
// 1.06 TFLOP at M = 2048 x 192 (1.07 ms at the bf16 tensor-core peak);
// K8w's 151 K (dense0's weight gradient) is bound by its 1.2 GB of x0
// (0.40 ms at 3.35 TB/s).  Per afterstate, with a1 and a2 the convolutions'
// activations, z0 dense0's pre-activation, h = relu(z0) and x0 = [flat(a2),
// feats, ctx] dense0's input:
//   dz0 = ds w1 (z0 > 0);  da2 = (W0[:, flat]^T dz0) (a2 > 0);
//   da1 = conv2^T(da2) (a1 > 0);  dW1 = sum da1 x patches(planes);
//   dW2 = sum da2 x patches(a1);  dW0 = sum dz0 x x0;  dctx = sum dz0 . W0[:, ctx].
// dz0, da2 and da1 round to the compute type before the next product, and
// every parameter's gradient is a float32 sum rounded once to the compute
// type (then widened), where the plain version rounds them.
//
// Three entry points, run in this order (each launches its kernels on the
// stream it is given; no float atomics, so two runs give the same bits):
//  * bbx_evaluator_grad_tiles (K8b): the weight layout with the backward's
//    operands (evaluator.cuh), then a grid of G blocks (SMs x resident
//    blocks), block i taking tiles i, i + G, ... of T afterstates of one
//    (lane, slot): T = 32 in bf16, 16 in float32, whose shared memory is
//    twice as wide.  A block is two groups of warps, 8 each in bf16 (16 an
//    SM: its products wait on shared memory and L2, and one group of 8 had
//    too few warps to hide that), 4 in float32.  The data group recomputes
//    K8's forward (ev_forward_tile) and writes x0 ([tile][kx][T], afterstate
//    innermost) and dz0 ([tile][hk][T]) for K8w, 16 bytes a thread, the
//    bf16 rows' 16-byte chunks permuted (evb_at) so that K8w's ldmatrix
//    rows fall in distinct banks; dz0's sum over the tile for the context;
//    and keeps in shared memory a2 > 0 as bits (a byte for each 8
//    afterstates, no vote) and dz0.  Then it walks the image rows back, r
//    = 7 .. 0, with rings of three rows in shared memory: conv1's row r - 1
//    again (channel-major, afterstate innermost); da2's row r = dz0 . W0t_r
//    on the tensor cores (W0t_r: W0's columns of row r, transposed by the
//    layout kernel, read from L2), masked; da1's row r + 1 as the SAME
//    convolution of da2's rows r .. r + 2 with the flipped, transposed
//    weights (ev_conv3_row, as conv2's forward), masked, into [c1p][8][T].
//    The weight group follows a row behind, its sums in registers for the
//    block's life: dW2 += da2_r^T . patches(a1) on the tensor cores (k =
//    the row's pixels, afterstate innermost, so each column's 8 k values
//    are contiguous; a table gives each column's offset a row; a column of
//    ones gives conv2's bias), and dW1 += da1_r . patches(planes), on the
//    tensor cores in bf16 (k = the row's pixels, afterstate innermost; the
//    tile's planes staged once, afterstate innermost, with strides that put
//    an n8 tile's 8 columns in 8 banks; a column of ones gives conv1's
//    bias), on the CUDA cores in float32.  The groups hand each other rows
//    through named barriers.  The block writes one record of float32
//    partial sums.  The forward's sums run in float64 in the float32
//    instantiation, as in K8's (evaluator.cuh), so the recompute rounds
//    each activation once and K8b's ReLU masks are K8's.
//  * bbx_evaluator_grad_dense0 (K8w): dW0 = dz0^T . x0, bound by reading x0
//    once.  A persistent grid: block (column tile of 128 x0 columns, split)
//    for enough splits to fill every SM, each split a contiguous run of
//    tiles.  One producer warp keeps a ring of EVB_K8W_STAGES stages in
//    flight with bulk asynchronous copies (bulk.cuh: cp.async.bulk and
//    mbarriers, no tensor map): a stage is one tile's dz0 [hk][T] and its
//    128 x0 columns [128][T], each one contiguous run of device memory as
//    K8b wrote it.  Sixteen consumer warps multiply the landed stages on the
//    tensor cores (mma.sync through ldmatrix; the scalar contract in
//    float32) while the next stages land, and release each stage to the
//    producer.  Each consumer sums 16 tiles' products in registers, then
//    adds that into its total in shared memory (a split is thousands of
//    tiles: one float32 sum of them all strays 3e-5 from float64, and
//    ptxas caps a thread of this block at 96 registers).  One float32
//    partial a split.  dW0 is 96 x 1,571 float32 at run9 (603 KB): it
//    cannot be one block's accumulator.
//  * bbx_evaluator_grad_reduce: every gradient element summed over the
//    records or splits in a fixed order, rounded once; and dctx, one
//    product of the (lane, slot)s' dz0 sums by W0's context columns.
#include "bulk.cuh"
#include "evaluator.cuh"

#define EVB_K8W_COLS 128      // x0 columns a K8w block
#define EVB_K8W_STAGES 5      // K8w's ring: tiles in flight a block
#define EVB_K8W_RUN 16        // tiles K8w sums before it adds the sum into its total
#define EVB_K8W_CWARPS 16     // K8w's consumer warps (and one producer warp)
#define EVB_K8W_THREADS (32 * EVB_K8W_CWARPS + 32)
// Shared memory a block can have on the H100 (a test builds the emulated
// library with less, to reach the layout of the width limits).
#ifndef EVB_SMEM_LIMIT
#define EVB_SMEM_LIMIT 232448
#endif
// dW1's B operand in bf16: the tile's planes [channel][10 rows][10 columns]
// [T = 32] (zero halo), element strides with 16-byte units of 5 a column,
// 55 (7 mod 8) a row and 556 (4 mod 8) a channel, so that the 8 columns
// (tap, channel) of each n8 tile start in 8 different bank groups.
#define EVB_PT_XS 40
#define EVB_PT_YS 440
#define EVB_PT_CS 4448

template <typename S>
struct EvbTile;
template <>
struct EvbTile<unsigned short> { static constexpr int T = 32, G = 8; };
template <>
struct EvbTile<float> { static constexpr int T = 16, G = 4; };

// Element (row, afterstate a) of a tile's [rows][T] block of x0 or dz0.  In
// bf16 the row's four 16-byte chunks (8 afterstates each) are permuted by
// the row, chunk q stored at q ^ ((row / 2) % 4), so that ldmatrix's 8 rows
// of one chunk lie in 8 different bank groups; float32 keeps the order.
// `_GradWork.x0_matrix` / `dz0_matrix` (models/afterstate.py) undo it.
template <typename S, int T>
__device__ __forceinline__ int evb_at(int row, int a) {
    if constexpr (sizeof(S) == 2) {
        return row * T + (a ^ (((row >> 1) & 3) << 3));
    } else {
        return row * T + a;
    }
}

// 8 consecutive elements to dst: one 16-byte store in bf16 (dst 16-byte
// aligned).
template <typename S>
__device__ __forceinline__ void store8(S* dst, const S (&v)[8]) {
    if constexpr (sizeof(S) == 2) {
        uint4 w;
        w.x = (unsigned)v[0] | (unsigned)v[1] << 16;
        w.y = (unsigned)v[2] | (unsigned)v[3] << 16;
        w.z = (unsigned)v[4] | (unsigned)v[5] << 16;
        w.w = (unsigned)v[6] | (unsigned)v[7] << 16;
        *(uint4*)dst = w;
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) dst[u] = v[u];
    }
}

__host__ __device__ inline int evb_min(int x, int y) { return x < y ? x : y; }
__host__ __device__ inline int evb_max(int x, int y) { return x > y ? x : y; }

// Byte offsets of K8b's shared memory: the forward's regions (f), and the
// backward's, which reuse the forward's ring and stage once the tile's
// forward is done.
struct EvbSmem {
    EvSmem f;
    int one, a1t, da2, da2t, da1, dz0, mask, ds, cols, pt, total;
};

template <typename S, int T>
static EvbSmem evb_smem(const EvDims& e) {
    const int es = (int)sizeof(S);
    EvbSmem s;
    const EvSizes<S, T> z = ev_sizes<S, T>(e, s.f);
    EvTake take;
    s.f.in = take(z.in);
    s.f.zero = take(32 * es);
    s.one = take(32 * es);  // a row of ones: the bias columns' B operand
    s.f.w1a = take(z.w1a);
    s.f.w2 = take(z.w2);  // conv2's weights, then the transposed ones (as large)
    s.f.f32 = take(z.f32);
    // The forward's ring and dense0's output; then a1 [c1p][3 rows][10][T] (+8).
    s.f.ring = s.a1t = take(evb_max(z.ring, e.c1p * (30 * T + 8) * es));
    // The forward's stage; then da2 [3 rows][T][10][c2p].
    s.f.stage = s.da2 = take(evb_max(z.stage, 3 * T * 10 * e.c2p * es));
    // da2's row channel-major [c2p][8][T] (+8).
    const int d1 = e.c1p * (8 * T + 8) * es;
    s.da2t = take(evb_max(e.c2p * (8 * T + 8) * es, d1));
    s.dz0 = take(T * (e.hk + 8) * es);
    s.mask = take(64 * e.c2p * 4);
    s.ds = take(T * 4);
    s.cols = take(8 * 9 * e.c1p * 4);
    s.pt = sizeof(S) == 2 ? take(2 * EVB_PT_CS * es) : 0;
    // da1's row [c1p][8][T] (+8) on its own where it fits, else over da2t,
    // where the data group waits for the weight group's reads twice more a
    // row (K8b 6% slower at run9 widths on an H100: torch_k8b_parts.py's
    // k8b_da1_shared).
    EvTake apart = take;
    s.da1 = apart(d1);
    if (apart.at <= EVB_SMEM_LIMIT) {
        take = apart;
    } else {
        s.da1 = s.da2t;
    }
    s.f.total = s.total = take.at;
    return s;
}

// The block record's offsets (floats): conv1 weight [c1][2][3][3] and
// bias, conv2 weight [c2][c1][3][3] and bias, dense0 bias, dense1 weight
// and bias; its size, and the records' stride (size to a multiple of 4, so
// that the reduction reads them 16 bytes a thread).
struct EvbRecord {
    int w1, b1, w2, b2, b0, wd1, bd1, size, stride;
};

// Floats of the eight parameters' gradients.
static int evb_grad_total(const EvDims& e) {
    return e.c1 * 19 + e.c2 * (e.c1 * 9 + 1) + e.h * (64 * e.c2 + 3 + e.d + 2) + 1;
}

static EvbRecord evb_record(const EvDims& e) {
    EvbRecord r;
    int at = 0;
    r.w1 = at;
    at += e.c1 * 18;
    r.b1 = at;
    at += e.c1;
    r.w2 = at;
    at += e.c2 * e.c1 * 9;
    r.b2 = at;
    at += e.c2;
    r.b0 = at;
    at += e.h;
    r.wd1 = at;
    at += e.h;
    r.bd1 = at;
    r.size = at + 1;
    r.stride = (r.size + 3) / 4 * 4;
    return r;
}

// ---------------------------------------------------------------------------
// K8b: a tile's forward again, and its backward row by row.
// ---------------------------------------------------------------------------

// The named barriers between K8b's two warp groups (and within each).
enum : int {
    EVB_BAR_DATA = 1,      // the data group's own barrier
    EVB_BAR_WEIGHTS = 2,   // the weight group's own
    EVB_BAR_WALK = 3,      // the tile's walk is set up
    EVB_BAR_ROW = 4,       // a1's row r - 1 and da2's row r are in shared memory
    EVB_BAR_ROW_READ = 5,  // dW2 has read them
    EVB_BAR_DA1 = 6,       // da1's row y is in shared memory
    EVB_BAR_DA1_READ = 7,  // dW1 has read it
    EVB_BAR_TILE = 8,      // the weight group is done with the tile
};

// A block is two groups of G warps.  The data group (warps 0 .. G - 1)
// recomputes the tile's forward, writes x0 and dz0, and walks the data
// gradients back row by row: conv1's row r - 1 again, da2's row r, da1's
// row r + 1.  The weight group (warps G .. 2G - 1) follows a step behind
// with the weight gradients of the rows the data group has finished, dW2's
// of row r and dW1's of row r + 1, holding their sums in its registers for
// the block's life.  Each hands the other its rows through named barriers
// (one arrives, the other waits), so that the two groups' products overlap.
template <typename S, int T, int G>
__global__ void __launch_bounds__(64 * G)
evaluator_grad_tiles_kernel(const S* __restrict__ planes, const S* __restrict__ feats,
                            const S* __restrict__ ctx, const S* __restrict__ lay,
                            const S* __restrict__ dscores, S* __restrict__ x0,
                            S* __restrict__ dz0g, float* __restrict__ stile,
                            float* __restrict__ part, EvDims e, EvbSmem sm, EvbRecord rec,
                            int ntiles) {
    constexpr int NTH = 32 * G, BOTH = 2 * NTH, Q = T / 8;
    // conv1's weight gradient on the tensor cores (bf16): warp w of the
    // weight group takes m-tile w % 2 and k-steps w / 2, w / 2 + G / 2, ...
    // of each row's 16.
    constexpr bool TC1 = sizeof(S) == 2;
    static_assert(!TC1 || T == 32, "bf16 K8b: tiles of 32 afterstates");
    static_assert(G == T / 4, "the data group runs the forward's 8T threads (evaluator.cuh)");
    BBX_DYNAMIC_SHARED(smem);
    const S* s_in = (const S*)(smem + sm.f.in);
    const S* s_zero = (const S*)(smem + sm.f.zero);
    S* s_one = (S*)(smem + sm.one);
    const S* s_w1a = (const S*)(smem + sm.f.w1a);
    S* s_w = (S*)(smem + sm.f.w2);
    const float* s_f = (const float*)(smem + sm.f.f32);
    const float* s_hid = (const float*)(smem + sm.f.ring);
    S* s_a1t = (S*)(smem + sm.a1t);
    S* s_da2 = (S*)(smem + sm.da2);
    S* s_da2t = (S*)(smem + sm.da2t);
    S* s_da1 = (S*)(smem + sm.da1);
    S* s_dz0 = (S*)(smem + sm.dz0);
    unsigned* s_mask = (unsigned*)(smem + sm.mask);
    float* s_ds = (float*)(smem + sm.ds);
    int* s_cols = (int*)(smem + sm.cols);
    S* s_pt = (S*)(smem + sm.pt);

    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int c1p = e.c1p, c2p = e.c2p;
    const int A1S = 30 * T + 8, D2S = 8 * T + 8, DZS = e.hk + 8;
    // da1 over da2t (at the width limits): each row's da1 waits for dW2's
    // reads of da2t, and the next da2 for dW1's reads of da1.
    const bool da1_apart = sm.da1 != sm.da2t;
    float* out = part + (size_t)blockIdx.x * rec.stride;

    if (threadIdx.x < NTH) {
        // The data group.
        const int tid = threadIdx.x, warp = tid >> 5;
        auto sync = [] { bbx_bar_sync(EVB_BAR_DATA, NTH); };
        if (tid < 32) s_one[tid] = from_f<S>(1.0f);
        float acc_db0 = 0.0f, acc_dwd1 = 0.0f, acc_dbd1 = 0.0f;
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
            const size_t first = (size_t)tile * T;
            const int ls = (int)(first / 64);  // lane * 3 + slot
            S* xt = x0 + (size_t)tile * e.kx * T;
            for (int i = tid; i < T; i += NTH) s_ds[i] = to_f(dscores[first + i]);
            // x0's feature and context columns (and the zero columns to kx),
            // 8 afterstates a thread.
            for (int i = tid; i < (e.kx - 64 * c2p) * Q; i += NTH) {
                const int j = i / Q, q = i % Q;
                S v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const size_t a = first + 8 * q + u;
                    v[u] = j < 3 ? feats[a * 3 + j]
                                 : (j < 3 + e.d ? ctx[(size_t)ls * e.d + j - 3] : (S)0);
                }
                store8(xt + evb_at<S, T>(64 * c2p + j, 8 * q), v);
            }

            // The forward, storing each row of a2 into x0 and its signs as
            // bits, 8 afterstates a thread.
            ev_forward_tile<S, T>(
                planes, feats, ctx, lay, e, sm.f, smem, first,
                [&](int r, const S* stage, int sstr) {
                    for (int i = tid; i < 8 * c2p * Q; i += NTH) {
                        const int k = i / Q, q = i % Q;  // k = x c2p + c
                        const int col = r * 8 * c2p + k;
                        S v[8];
                        unsigned bits = 0;
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            v[u] = stage[(8 * q + u) * sstr + k];
                            bits |= (to_f(v[u]) > 0.0f ? 1u : 0u) << u;
                        }
                        store8(xt + evb_at<S, T>(col, 8 * q), v);
                        ((unsigned char*)s_mask)[col * 4 + q] = (unsigned char)bits;
                    }
                },
                sync);

            // dz0 = ds w1 where h > 0, rounded: [T][hk + 8] here, [hk][T] for K8w.
            for (int i = tid; i < e.hk * Q; i += NTH) {
                const int hh = i / Q, q = i % Q;
                S v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int a = 8 * q + u;
                    S x = 0;
                    if (hh < e.hp && s_hid[a * (e.hp + 1) + hh] > 0.0f)
                        x = from_f<S>(s_ds[a] * s_f[sm.f.w1 + hh]);
                    v[u] = x;
                    s_dz0[a * DZS + hh] = x;
                }
                store8(dz0g + (size_t)tile * e.hk * T + evb_at<S, T>(hh, 8 * q), v);
            }
            sync();
            // dense1's gradients, dense0's bias and the tile's dz0 sum (the
            // context's gradient), float32 in the afterstates' order.
            if (tid < e.hp) {
                float sh = 0.0f, sz = 0.0f;
                for (int a = 0; a < T; ++a) {
                    sh += s_ds[a] * s_hid[a * (e.hp + 1) + tid];
                    sz += to_f(s_dz0[a * DZS + tid]);
                }
                acc_dwd1 += sh;
                acc_db0 += sz;
                stile[(size_t)tile * e.hp + tid] = sz;
            }
            if (tid == 0) {
                float s = 0.0f;
                for (int a = 0; a < T; ++a) s += s_ds[a];
                acc_dbd1 += s;
            }
            sync();  // the walk overwrites dense0's output

            // The walk's set-up: conv2's transposed weights over conv2's,
            // the rings' zero columns, dW2's B column table for rows 0-7,
            // the planes as dW1's B operand (bf16), conv1's row 7.
            {
                const uint4* src = (const uint4*)(lay + e.w2t);
                uint4* dst = (uint4*)s_w;
                for (int i = tid; i < 5 * e.cg2 * e.cg1 * 128 * (int)sizeof(S) / 16; i += NTH)
                    dst[i] = src[i];
            }
            for (int i = tid; i < c1p * 6 * T; i += NTH) {
                const int c = i / (6 * T), rem = i % (6 * T);
                const int slot = rem / (2 * T), side = (rem / T) & 1;
                s_a1t[c * A1S + (slot * 10 + side * 9) * T + rem % T] = 0;
            }
            for (int i = tid; i < 3 * T * 2 * c2p; i += NTH) {
                const int row = i / (2 * c2p), side = (i / c2p) & 1;
                s_da2[(row * 10 + side * 9) * c2p + i % c2p] = 0;
            }
            // dW2's B column n = (tap, c1) of row r: its offset in the a1
            // ring (its pixels k follow), or -1 where the tap's input row
            // lies outside the image.
            for (int i = tid; i < 8 * 9 * c1p; i += NTH) {
                const int r = i / (9 * c1p), n = i % (9 * c1p);
                const int tap = n / c1p, c = n % c1p, yy = r + tap / 3 - 1;
                s_cols[i] = yy < 0 || yy > 7 ? -1 : c * A1S + ((yy % 3) * 10 + tap % 3) * T;
            }
            if constexpr (TC1) {
                // s_in [a][10][10][2] -> s_pt [ci][10][10][a], 8 afterstates a thread.
                for (int i = tid; i < 200 * Q; i += NTH) {
                    const int p = i / Q, q = i % Q;  // p = (row * 10 + column) * 2 + ci
                    const int yx = p >> 1;
                    S v[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) v[u] = s_in[(8 * q + u) * 200 + p];
                    store8(s_pt + (p & 1) * EVB_PT_CS + (yx / 10) * EVB_PT_YS +
                               (yx % 10) * EVB_PT_XS + 8 * q,
                           v);
                }
            }
            bbx_bar_arrive(EVB_BAR_WALK, BOTH);
            auto conv1_row = [&](int y) {
                ev_conv1_row<S, T>(s_in, s_w1a, s_zero, s_f + sm.f.b1c, e, y,
                                      [&](int ch, int x, int a, S v) {
                                          s_a1t[ch * A1S + ((y % 3) * 10 + x + 1) * T + a] = v;
                                      });
            };
            conv1_row(7);

            // The weight group's reads this group waits for before
            // overwriting what they read: dW2 of rows 7 .. 0, dW1 of rows 7
            // .. 1, each once, in order.  Each wait is a barrier of this
            // whole group too.
            int row_read = 7, da1_read = 7;
            auto wait_row_read = [&](int upto) {
                bool waited = false;
                for (; row_read >= upto && row_read >= 0; --row_read, waited = true)
                    bbx_bar_sync(EVB_BAR_ROW_READ, BOTH);
                return waited;
            };
            auto wait_da1_read = [&](int upto) {
                bool waited = false;
                for (; da1_read >= upto && da1_read >= 1; --da1_read, waited = true)
                    bbx_bar_sync(EVB_BAR_DA1_READ, BOTH);
                return waited;
            };
            for (int r = 7; r >= -1; --r) {
                const int y = r + 1;
                // a1's ring slot of row r + 2 and da2t (and, over it, da1)
                // are overwritten next; the last row's da1 has read the
                // rings.
                bool met = wait_row_read(r + 1);
                if (!da1_apart) met = wait_da1_read(r + 2) || met;
                if (!met && r < 7) sync();
                if (r >= 1) conv1_row(r - 1);
                if (r >= 0) {
                    // da2's row r: [T] x [8 c2p] = dz0 [T x hk] . W0t_r [hk x
                    // 8 c2p], this warp's n8 tiles warp, warp + G, ...; masked,
                    // rounded, into the ring (pixel-major) and channel-major.
                    constexpr int MTB = T / 16, NTB = 32 / G;
                    const int ntb = warp < c2p ? (c2p - warp + G - 1) / G : 0;
                    float cb[MTB][NTB][4];
                    zero(cb);
                    for (int ks = 0; ks < e.hk / 16; ++ks) {
                        auto a = [&](int i, int row, int half) -> const S* {
                            return s_dz0 + (i * 16 + row) * DZS + ks * 16 + half * 8;
                        };
                        auto b = [&](int j, int half, int col) -> const S* {
                            return lay + e.w0t +
                                (((size_t)r * (e.hk / 16) + ks) * c2p + warp + G * j) * 128 +
                                half * 64 + col * 8;
                        };
                        tile_k16<MTB, NTB, false, S>(cb, a, b, MTB, ntb);
                    }
#pragma unroll
                    for (int i = 0; i < MTB; ++i) {
#pragma unroll
                        for (int j = 0; j < NTB; ++j) {
                            if (j < ntb) {
#pragma unroll
                                for (int k = 0; k < 4; ++k) {
                                    const int a = i * 16 + g + (k >> 1) * 8;
                                    const int n = (warp + G * j) * 8 + 2 * t + (k & 1);
                                    const int x = n / c2p, c = n % c2p;
                                    const bool on = (s_mask[(r * 8 + x) * c2p + c] >> a) & 1u;
                                    const S v = on ? from_f<S>(cb[i][j][k]) : (S)0;
                                    s_da2[(((r % 3) * T + a) * 10 + x + 1) * c2p + c] = v;
                                    s_da2t[c * D2S + x * T + a] = v;
                                }
                            }
                        }
                    }
                    bbx_bar_arrive(EVB_BAR_ROW, BOTH);
                }
                if (y <= 7) {
                    // da1's row y: the transposed convolution of da2's rows r
                    // .. r + 2, masked by a1 > 0, rounded, into [c1p][8][T].
                    sync();  // da2's row r is in the ring
                    float cd[2][4][4];
                    ev_conv3_row<S, T>(cd, s_da2, c2p, e.cg2, s_w, e.cg1, s_zero, y);
                    wait_da1_read(y + 1);
                    if (!da1_apart) wait_row_read(r);
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            if (j < e.cg1) {
#pragma unroll
                                for (int k = 0; k < 4; ++k) {
                                    const int a = 2 * (warp + G * i) + (k >> 1), x = g;
                                    const int c = j * 8 + 2 * t + (k & 1);
                                    const bool on =
                                        to_f(s_a1t[c * A1S + ((y % 3) * 10 + x + 1) * T + a]) >
                                        0.0f;
                                    s_da1[c * D2S + x * T + a] =
                                        on ? from_f<S>(cd[i][j][k]) : (S)0;
                                }
                            }
                        }
                    }
                    bbx_bar_arrive(EVB_BAR_DA1, BOTH);
                }
            }
            bbx_bar_sync(EVB_BAR_TILE, BOTH);  // the weight group is done with the tile
        }
        if (tid < e.h) {
            out[rec.b0 + tid] = acc_db0;
            out[rec.wd1 + tid] = acc_dwd1;
        }
        if (tid == 0) out[rec.bd1] = acc_dbd1;
        return;
    }

    // The weight group.
    const int tid = threadIdx.x - NTH, warp = tid >> 5;
    // dW2 and conv2's bias: the tensor-core accumulators, m = c2 (two m16
    // tiles), n = (tap, c1) in 9 cg1 n8 tiles and one of ones, this warp's
    // n-tiles warp, warp + G, ...
    constexpr int NTW = (9 * EV_MAX_C / 8 + 1 + G - 1) / G;
    const int n2 = 9 * e.cg1 + 1;
    const int ntw = warp < n2 ? (n2 - warp + G - 1) / G : 0;
    const int mt2 = (c2p + 15) / 16;
    float acc2[2][NTW][4];
    zero(acc2);
    // dW1 and conv1's bias.  bf16: n = (tap, input channel) 18 and one of
    // ones in 3 n8 tiles.  float32: items it = tid + NTH u of [c1][ci 2][x
    // 8], each the 9 taps' sums over its column x (and, for ci 0, the
    // bias's).
    constexpr int U1 = TC1 ? 1 : (16 * EV_MAX_C + NTH - 1) / NTH;
    float acc1[1][3][4];
    float acc1s[U1][10];
    zero(acc1);
    for (int u = 0; u < U1; ++u)
        for (int q = 0; q < 10; ++q) acc1s[u][q] = 0.0f;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        bbx_bar_sync(EVB_BAR_WALK, BOTH);
        for (int r = 7; r >= -1; --r) {
            const int y = r + 1;
            if (r >= 0) {
                // dW2 += da2_r^T [c2 x (8 T pixels)] . patches(a1) [(8 T) x
                // (9 c1p)], and conv2's bias: the n-tile 9 cg1 of ones.
                bbx_bar_sync(EVB_BAR_ROW, BOTH);
                const int* cols = s_cols + r * 9 * c1p;
                for (int ks = 0; ks < T / 2; ++ks) {
                    auto a = [&](int i, int row, int half) -> const S* {
                        const int c = i * 16 + row;
                        return c < c2p ? s_da2t + c * D2S + ks * 16 + half * 8 : s_zero;
                    };
                    auto b = [&](int j, int half, int col) -> const S* {
                        const int jn = warp + G * j;
                        if (jn == 9 * e.cg1) return s_one;
                        const int at = cols[jn * 8 + col];
                        return at < 0 ? s_zero : s_a1t + at + ks * 16 + half * 8;
                    };
                    tile_k16<2, NTW, true, S>(acc2, a, b, mt2, ntw);
                }
                bbx_bar_arrive(EVB_BAR_ROW_READ, BOTH);
            }
            if (y <= 7) {
                bbx_bar_sync(EVB_BAR_DA1, BOTH);
                if constexpr (TC1) {
                    // dW1 [c1][(tap, ci)] += da1_y [c1 x (8 T pixels)] .
                    // patches(planes) [(8 T) x (tap, ci)]: k = x T + a.
                    const int mi = warp & 1;
                    for (int ks = warp >> 1; ks < T / 2; ks += G / 2) {
                        const int x = ks >> 1, a0 = (ks & 1) * 16;
                        auto a = [&](int, int row, int half) -> const S* {
                            const int c = mi * 16 + row;
                            return c < c1p ? s_da1 + c * D2S + ks * 16 + half * 8 : s_zero;
                        };
                        auto b = [&](int j, int half, int col) -> const S* {
                            const int n = j * 8 + col;  // tap n / 2, channel n % 2; 18: ones
                            if (n < 18) {
                                const int tap = n >> 1;
                                return s_pt + (n & 1) * EVB_PT_CS + (y + tap / 3) * EVB_PT_YS +
                                    (x + tap % 3) * EVB_PT_XS + a0 + half * 8;
                            }
                            return n == 18 ? s_one : s_zero;
                        };
                        tile_k16<1, 3, true, S>(acc1, a, b, mi < e.c1m / 16 ? 1 : 0, 3);
                    }
                } else {
                    // dW1 [c1][ci][dy][dx] += sum over the row's pixels of da1
                    // x planes(y + dy - 1, x + dx - 1, ci): item (c, ci, x)
                    // keeps the 9 taps' sums over its column's afterstates,
                    // ci 0 also the bias's.
                    for (int u = 0; u < U1; ++u) {
                        const int it = tid + NTH * u;
                        if (it < 16 * e.c1) {
                            const int c = it / 16, ci = (it / 8) % 2, x = it % 8;
                            const S* dr = s_da1 + c * D2S + x * T;
                            const S* in = s_in + y * 20 + x * 2 + ci;
                            for (int a = 0; a < T; ++a) {
                                const float d = to_f(dr[a]);
                                const S* w = in + a * 200;
#pragma unroll
                                for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                                    for (int dx = 0; dx < 3; ++dx)
                                        acc1s[u][dy * 3 + dx] += d * to_f(w[dy * 20 + dx * 2]);
                                acc1s[u][9] += ci == 0 ? d : 0.0f;
                            }
                        }
                    }
                }
                if (y >= 1) bbx_bar_arrive(EVB_BAR_DA1_READ, BOTH);
            }
        }
        bbx_bar_arrive(EVB_BAR_TILE, BOTH);
    }

    // The weight group's part of the record.  dW1's parts join in a fixed
    // order through shared memory (the a1 ring, which the data group no
    // longer reads).
    float* s_items = (float*)(smem + sm.a1t);
    if constexpr (TC1) {
        // Warp w's [c1][19] (18 (tap, ci) columns, then the bias) at row
        // block w / 2: each (w / 2, c) is one warp's (m-tile c / 16).
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int c = (warp & 1) * 16 + g + (k >> 1) * 8, n = j * 8 + 2 * t + (k & 1);
                if (c < e.c1 && n < 19) s_items[((warp >> 1) * e.c1 + c) * 19 + n] = acc1[0][j][k];
            }
        }
        bbx_bar_sync(EVB_BAR_WEIGHTS, NTH);
        for (int o = tid; o < 19 * e.c1; o += NTH) {
            const int c = o / 19, q = o % 19;  // q: 2 tap + ci, or 18 for the bias
            float s = 0.0f;
            for (int p = 0; p < G / 2; ++p) s += s_items[(p * e.c1 + c) * 19 + q];
            out[q < 18 ? rec.w1 + c * 18 + (q & 1) * 9 + (q >> 1) : rec.b1 + c] = s;
        }
    } else {
        for (int u = 0; u < U1; ++u) {
            const int it = tid + NTH * u;
            if (it < 16 * e.c1)
                for (int q = 0; q < 10; ++q) s_items[it * 10 + q] = acc1s[u][q];
        }
        bbx_bar_sync(EVB_BAR_WEIGHTS, NTH);
        for (int o = tid; o < 19 * e.c1; o += NTH) {
            const int c = o / 19, q = o % 19;  // q: ci 9 + tap, or 18 for the bias
            const int ci = q < 18 ? q / 9 : 0, k = q < 18 ? q % 9 : 9;
            float s = 0.0f;
            for (int x = 0; x < 8; ++x) s += s_items[((c * 2 + ci) * 8 + x) * 10 + k];
            out[q < 18 ? rec.w1 + c * 18 + q : rec.b1 + c] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
            if (j < ntw) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int c = i * 16 + g + (k >> 1) * 8;
                    const int jn = warp + G * j, n = jn * 8 + 2 * t + (k & 1);
                    if (c >= e.c2) continue;
                    if (jn == 9 * e.cg1) {
                        if ((n & 7) == 0) out[rec.b2 + c] = acc2[i][j][k];
                    } else {
                        const int tap = n / c1p, ci = n % c1p;
                        if (ci < e.c1) out[rec.w2 + (c * e.c1 + ci) * 9 + tap] = acc2[i][j][k];
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K8w: dW0 = dz0^T . x0 over a ring of bulk copies.
// ---------------------------------------------------------------------------

// K8w's consumers' accumulators a thread: m-tiles mh, mh + 2, ... of at
// most 8, n-tiles of their columns.
#define EVB_K8W_ACC (EV_MAX_H / 32 * (32 / EVB_K8W_CWARPS) * 4)

// Bytes of K8w's shared memory: the stages' barriers (full, then empty),
// the stages, each dz0 [hk][T] and x0 [128 columns][T], then the
// consumers' totals [EVB_K8W_ACC][consumer thread] (float32).
template <typename S, int T>
static int evb_k8w_smem(const EvDims& e) {
    return 128 + EVB_K8W_STAGES * (e.hk + EVB_K8W_COLS) * T * (int)sizeof(S) +
        EVB_K8W_ACC * 32 * EVB_K8W_CWARPS * 4;
}

template <typename S, int T>
__global__ void __launch_bounds__(EVB_K8W_THREADS)
evaluator_grad_dense0_kernel(const S* __restrict__ x0, const S* __restrict__ dz0g,
                             float* __restrict__ partw, EvDims e, int ntiles, int splits,
                             int cols) {
    BBX_DYNAMIC_SHARED(smem);
    unsigned long long* full = (unsigned long long*)smem;
    unsigned long long* empty = full + EVB_K8W_STAGES;
    S* ring = (S*)(smem + 128);
    const int stage = (e.hk + EVB_K8W_COLS) * T;
    float* s_total = (float*)(ring + EVB_K8W_STAGES * stage);
    const int tid = threadIdx.x, warp = tid >> 5;
    // Block (column tile, split) = (blockIdx.x % cols, blockIdx.x / cols);
    // the split's tiles [t0, t1).
    const int split = blockIdx.x / cols;
    const int c0 = (blockIdx.x % cols) * EVB_K8W_COLS;
    const int ncols = e.kx - c0 < EVB_K8W_COLS ? e.kx - c0 : EVB_K8W_COLS;
    const int t0 = (int)((long long)ntiles * split / splits);
    const int n = (int)((long long)ntiles * (split + 1) / splits) - t0;
    if (tid == 0) {
        for (int s = 0; s < EVB_K8W_STAGES; ++s) {
            bbx_mbar_init(full + s, 1);
            bbx_mbar_init(empty + s, EVB_K8W_CWARPS);
        }
        bbx_mbar_fence_init();
    }
    __syncthreads();

    if (warp == EVB_K8W_CWARPS) {
        // The producer: tile it into stage it % STAGES once its readers of
        // the tile STAGES before have released it.
        if (tid == 32 * EVB_K8W_CWARPS) {
            const unsigned bz = e.hk * T * sizeof(S), bx = ncols * T * sizeof(S);
            for (int it = 0; it < n; ++it) {
                const int s = it % EVB_K8W_STAGES;
                if (it >= EVB_K8W_STAGES) bbx_mbar_wait(empty + s, (it / EVB_K8W_STAGES - 1) & 1);
                const size_t tile = (size_t)(t0 + it);
                S* st = ring + s * stage;
                bbx_mbar_expect_tx(full + s, bz + bx);
                bbx_bulk_copy(st, dz0g + tile * e.hk * T, bz, full + s);
                bbx_bulk_copy(st + e.hk * T, x0 + (tile * e.kx + c0) * T, bx, full + s);
            }
        }
        return;
    }

    // The consumers: warp (mh, nq) = (warp / Q, warp % Q), Q = CWARPS / 2,
    // takes m-tiles mh, mh + 2, ... of dz0's rows and n-tiles NQ nq .. NQ
    // nq + NQ - 1 of the columns (NQ = 16 / Q).
    constexpr int Q = EVB_K8W_CWARPS / 2, NQ = 16 / Q;
    const int g = (tid & 31) >> 2, t = tid & 3;
    const int mh = warp / Q, nq = warp % Q;
    const int mt = e.hk / 16;
    const int mtw = mt > mh ? (mt - mh + 1) / 2 : 0;
    const int ntw = evb_max(evb_min((ncols - 8 * NQ * nq + 7) / 8, NQ), 0);
    // Two-level float32 sums, so that a split's thousands of tiles keep
    // dense0's weight gradient within 1e-5 of its float64 value: the
    // products of EVB_K8W_RUN tiles in registers, then their sum added
    // into the thread's total in shared memory.
    float acc[EV_MAX_H / 32][NQ][4];
    zero(acc);
    float* total = s_total + tid;  // element q at total[q * 32 CWARPS]
    for (int q = 0; q < EVB_K8W_ACC; ++q) total[q * 32 * EVB_K8W_CWARPS] = 0.0f;
    auto add_run = [&] {
#pragma unroll
        for (int i = 0; i < EV_MAX_H / 32; ++i)
#pragma unroll
            for (int j = 0; j < NQ; ++j)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    total[((i * NQ + j) * 4 + k) * 32 * EVB_K8W_CWARPS] +=
                        acc[i][j][k];
                    acc[i][j][k] = 0.0f;
                }
    };
    for (int it = 0; it < n; ++it) {
        if (it % EVB_K8W_RUN == 0) add_run();
        const int s = it % EVB_K8W_STAGES;
        bbx_mbar_wait(full + s, (it / EVB_K8W_STAGES) & 1);
        const S* sa = ring + s * stage;
        const S* sb = sa + e.hk * T;
        if (ntw > 0) {
#pragma unroll
            for (int ks = 0; ks < T / 16; ++ks) {
                auto a = [&](int i, int row, int half) -> const S* {
                    return sa + evb_at<S, T>((mh + 2 * i) * 16 + row, ks * 16 + half * 8);
                };
                auto b = [&](int j, int half, int col) -> const S* {
                    return sb + evb_at<S, T>((NQ * nq + j) * 8 + col, ks * 16 + half * 8);
                };
                tile_k16<EV_MAX_H / 32, NQ, true, S>(acc, a, b, mtw, ntw);
            }
        }
        __syncwarp();
        if ((tid & 31) == 0) bbx_mbar_arrive(empty + s);
    }
    add_run();
    float* out = partw + (size_t)split * e.hp * e.kx;
#pragma unroll
    for (int i = 0; i < EV_MAX_H / 32; ++i) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int hh = (mh + 2 * i) * 16 + g + (k >> 1) * 8;
                const int col = c0 + (NQ * nq + j) * 8 + 2 * t + (k & 1);
                if (i < mtw && j < ntw && hh < e.hp && col < e.kx)
                    out[(size_t)hh * e.kx + col] =
                        total[((i * NQ + j) * 4 + k) * 32 * EVB_K8W_CWARPS];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The reduction and the context's gradient.
// ---------------------------------------------------------------------------

// One kernel, three kinds of block (the block's kind by its index v, from
// `v0` on, in the order below; launched twice, the sums' blocks and then
// dctx's), each reading its inputs once, 16 bytes a thread, neighbouring
// threads on neighbouring addresses:
//  * the records' sums: a block takes 64 record elements (16 columns of 4)
//    and 16 groups of records, group u summing records u, u + 16, ... in
//    order; the 16 group sums join in a fixed pairwise tree (((u0 + u1) +
//    (u2 + u3)) + ...), so that no sum is a chain of all the records;
//  * dW0's sums: a thread takes 4 neighbouring x0 columns of one hidden
//    unit and sums K8w's splits in order;
//  * dctx: a block takes EVB_CTX_SLOTS (lane, slot)s; each one's dz0 sum
//    (its 64 / T tiles' sums, in order) into shared memory, W0's context
//    columns too, 32 at a time, then dctx = the slot sums [slots x h] .
//    W0[:, ctx] [h x d], each output's sum over the hidden units in
//    order.
// Every gradient element is a float32 sum rounded once to the compute
// type (then widened), and the order is fixed, so two runs give the same
// bits.
#define EVB_REC_COLS 64   // record elements a block of the records' sums
#define EVB_REC_GROUPS 16 // groups of records
#define EVB_CTX_SLOTS 32  // (lane, slot)s a block of dctx
#define EVB_CTX_COLS 32   // context columns a pass of dctx

// The blocks of each kind at b lanes.
struct EvbReduceGrid {
    int rec, w0, ctx;
};

static EvbReduceGrid evb_reduce_grid(int b, const EvDims& e, const EvbRecord& rec) {
    EvbReduceGrid g;
    g.rec = (rec.stride + EVB_REC_COLS - 1) / EVB_REC_COLS;
    g.w0 = (e.h * (e.kx / 4) + 255) / 256;
    g.ctx = (b * 3 + EVB_CTX_SLOTS - 1) / EVB_CTX_SLOTS;
    return g;
}

// grads: the eight parameters' gradients, flat, in the module's order;
// dctx [b * 3][d] in the compute type.
template <typename S, int T>
__global__ void __launch_bounds__(256)
evaluator_grad_reduce_kernel(const float* __restrict__ part, int blocks, EvbRecord rec,
                             const float* __restrict__ partw, int splits,
                             const float* __restrict__ stile, const S* __restrict__ lay,
                             EvDims e, float* __restrict__ grads, S* __restrict__ dctx,
                             int nslots, EvbReduceGrid grid, int v0) {
    __shared__ float s_a[EVB_CTX_SLOTS * (EV_MAX_H + 1)];
    __shared__ float s_b[EV_MAX_H * (EVB_CTX_COLS + 1)];
    const int tid = threadIdx.x;
    int v = v0 + (int)blockIdx.x;
    const int nw1 = e.c1 * 18, nw2 = e.c2 * e.c1 * 9, f = 64 * e.c2 + 3 + e.d;
    if (v < grid.rec) {
        // s_a [group][64 columns].
        const int u = tid / 16, c4 = tid % 16, col = v * EVB_REC_COLS + 4 * c4;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col < rec.stride) {
            for (int b = u; b < blocks; b += EVB_REC_GROUPS) {
                const float4 x = *(const float4*)(part + (size_t)b * rec.stride + col);
                s.x += x.x;
                s.y += x.y;
                s.z += x.z;
                s.w += x.w;
            }
        }
        float* o = s_a + u * EVB_REC_COLS + 4 * c4;
        o[0] = s.x;
        o[1] = s.y;
        o[2] = s.z;
        o[3] = s.w;
        __syncthreads();
        for (int w = 1; w < EVB_REC_GROUPS; w *= 2) {
            for (int i = tid; i < EVB_REC_COLS * EVB_REC_GROUPS / (2 * w); i += 256) {
                float* lo = s_a + 2 * w * (i / EVB_REC_COLS) * EVB_REC_COLS + i % EVB_REC_COLS;
                *lo = *lo + lo[w * EVB_REC_COLS];
            }
            __syncthreads();
        }
        const int j = v * EVB_REC_COLS + tid;  // the record element
        if (tid < EVB_REC_COLS && j < rec.size)
            grads[j < rec.b0 ? j : j + e.h * f] = to_f(from_f<S>(s_a[tid]));
        return;
    }
    if ((v -= grid.rec) < grid.w0) {
        const int i = v * 256 + tid, kq = e.kx / 4;
        if (i >= e.h * kq) return;
        const int hh = i / kq, col = (i % kq) * 4;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int c = 0; c < splits; ++c) {
            const float4 x = *(const float4*)(partw + ((size_t)c * e.hp + hh) * e.kx + col);
            s.x += x.x;
            s.y += x.y;
            s.z += x.z;
            s.w += x.w;
        }
        const float sv[4] = {s.x, s.y, s.z, s.w};
        float* out = grads + nw1 + e.c1 + nw2 + e.c2 + (size_t)hh * f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int cc = col + q;  // x0's column: (pixel, channel to c2p), then the rest
            int ff = -1;
            if (cc < 64 * e.c2p) {
                if (cc % e.c2p < e.c2) ff = cc / e.c2p * e.c2 + cc % e.c2p;
            } else if (cc - 64 * e.c2p < 3 + e.d) {
                ff = 64 * e.c2 + cc - 64 * e.c2p;
            }
            if (ff >= 0) out[ff] = to_f(from_f<S>(sv[q]));
        }
        return;
    }
    v -= grid.w0;
    // dctx for (lane, slot)s ls0 .. ls0 + EVB_CTX_SLOTS - 1: their dz0 sums
    // into s_a [slot][hp + 1].
    constexpr int TPSLOT = 64 / T;
    const int ls0 = v * EVB_CTX_SLOTS, hs = e.hp + 1;
    const int ns = nslots - ls0 < EVB_CTX_SLOTS ? nslots - ls0 : EVB_CTX_SLOTS;
    for (int i = tid; i < ns * e.hp; i += 256) {
        const int sl = i / e.hp, hh = i % e.hp;
        const float* at = stile + (size_t)(ls0 + sl) * TPSLOT * e.hp + hh;
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < TPSLOT; ++q) s += at[q * e.hp];
        s_a[sl * hs + hh] = s;
    }
    const int dd = tid % EVB_CTX_COLS, sl0 = tid / EVB_CTX_COLS;
    for (int d0 = 0; d0 < e.d; d0 += EVB_CTX_COLS) {
        __syncthreads();  // s_a is in; the last pass has read s_b
        // W0's context columns d0 .. d0 + 31 into s_b [hh][32 + 1].
        for (int i = tid; i < e.h * EVB_CTX_COLS; i += 256) {
            const int hh = i / EVB_CTX_COLS, c = i % EVB_CTX_COLS;
            s_b[hh * (EVB_CTX_COLS + 1) + c] =
                d0 + c < e.d ? to_f(lay[e.w0x + (d0 + c) * e.hp + hh]) : 0.0f;
        }
        __syncthreads();
        if (d0 + dd < e.d) {
            for (int sl = sl0; sl < ns; sl += 256 / EVB_CTX_COLS) {
                const float* a = s_a + sl * hs;
                float acc = 0.0f;
                for (int hh = 0; hh < e.h; ++hh) acc += a[hh] * s_b[hh * (EVB_CTX_COLS + 1) + dd];
                dctx[(size_t)(ls0 + sl) * e.d + d0 + dd] = from_f<S>(acc);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

// The launch geometry at these widths: K8b's threads a block, resident
// blocks an SM and grid (SMs x resident blocks, at most the tiles); K8w's
// column tiles, resident blocks an SM and splits (as many as fill the SMs'
// resident blocks with every column tile, at most the tiles).
struct EvbPlan {
    int ntiles, threads, resident, blocks, cols, resident_w, splits;
};

template <typename S>
static int evb_plan(int b, const EvDims& e, EvbPlan& p) {
    constexpr int T = EvbTile<S>::T, G = EvbTile<S>::G;
    static int smem_set[64], smem_set_w[64], carveout_set[64];
    auto* const kernel = &evaluator_grad_tiles_kernel<S, T, G>;
    auto* const kernel_w = &evaluator_grad_dense0_kernel<S, T>;
    const int smem = evb_smem<S, T>(e).total, smem_w = evb_k8w_smem<S, T>(e);
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    int err = ev_allow_smem(kernel, smem, smem_set);
    if (!err) err = ev_allow_smem(kernel_w, smem_w, smem_set_w);
    // As much of the SM's unified memory as shared memory (once a device):
    // K8w holds its ring there, and more blocks an SM keep more bytes in
    // flight.
    if (!err && !carveout_set[dev % 64]) {
        err = (int)cudaFuncSetAttribute(kernel_w, cudaFuncAttributePreferredSharedMemoryCarveout,
                                        cudaSharedmemCarveoutMaxShared);
        carveout_set[dev % 64] = !err;
    }
    if (err) {
        cudaGetLastError();  // reported here, not again by the next call
        return err;
    }
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    p.threads = 64 * G;
    p.resident = p.resident_w = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.resident, kernel, p.threads, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.resident_w, kernel_w, EVB_K8W_THREADS,
                                                  smem_w);
    p.ntiles = b * (EV_ACTIONS / T);
    p.blocks = evb_min(sms * evb_max(p.resident, 1), p.ntiles);
    p.cols = (e.kx + EVB_K8W_COLS - 1) / EVB_K8W_COLS;
    p.splits = evb_min(evb_max(sms * evb_max(p.resident_w, 1) / p.cols, 1), p.ntiles);
    return 0;
}

static const float* const* evb_params(const void* const* p) { return (const float* const*)p; }

// Sizes of the backward's buffers at b lanes: out[0] the weight layout's
// elements (compute type), [1] x0's and [2] dz0's elements (compute type),
// [3] the tiles' dz0 sums, [4] the records, [5] K8w's partials (float32),
// [6] the gradients' floats; and the plan: [7] K8b's threads a block, [8]
// its resident blocks an SM, [9] its grid, [10] K8w's ring stages, [11] its
// resident blocks an SM, [12] its splits, [13] K8b's shared memory bytes,
// [14] 1 where da1 has its own shared memory.  Returns an error beyond the
// limits.
extern "C" int bbx_evaluator_grad_sizes(int b, int c1, int c2, int h, int d, int elem,
                                        long long* out) {
    if ((elem != 2 && elem != 4) || !ev_widths_ok(c1, c2, h, d) || b < 0)
        return (int)cudaErrorInvalidValue;
    const EvDims e = ev_dims(c1, c2, h, d);
    EvbPlan p;
    const int err = elem == 2 ? evb_plan<unsigned short>(b, e, p) : evb_plan<float>(b, e, p);
    if (err) return err;
    const long long m = (long long)b * EV_ACTIONS;
    out[0] = e.total;
    out[1] = m * e.kx;
    out[2] = m * e.hk;
    out[3] = (long long)p.ntiles * e.hp;
    out[4] = (long long)p.blocks * evb_record(e).stride;
    out[5] = (long long)p.splits * e.hp * e.kx;
    out[6] = evb_grad_total(e);
    out[7] = p.threads;
    out[8] = p.resident;
    out[9] = p.blocks;
    out[10] = EVB_K8W_STAGES;
    out[11] = p.resident_w;
    out[12] = p.splits;
    const EvbSmem sm = elem == 2 ? evb_smem<unsigned short, EvbTile<unsigned short>::T>(e)
                                 : evb_smem<float, EvbTile<float>::T>(e);
    out[13] = sm.total;
    out[14] = sm.da1 != sm.da2t;
    return (int)cudaGetLastError();
}

template <typename S>
static int evb_tiles(const void* planes, const void* feats, const void* ctx, const void* ds,
                     const void* const* params, void* layout, void* x0, void* dz0, void* stile,
                     void* part, int b, const EvDims& e, void* stream) {
    constexpr int T = EvbTile<S>::T, G = EvbTile<S>::G;
    EvbPlan p;
    const int err = evb_plan<S>(b, e, p);
    if (err) return err;
    ev_launch_layout<S>(evb_params(params), layout, e, e.total, stream);
    const EvbSmem sm = evb_smem<S, T>(e);
    auto* const kernel = &evaluator_grad_tiles_kernel<S, T, G>;
    BBX_LAUNCH_SMEM(kernel, p.blocks, p.threads, sm.total, stream,
                    (const S*)planes, (const S*)feats, (const S*)ctx, (const S*)layout,
                    (const S*)ds, (S*)x0, (S*)dz0, (float*)stile, (float*)part, e, sm,
                    evb_record(e), p.ntiles);
    return 0;
}

// K8b: planes [b, 192, 8, 8, 2] (16-byte aligned), feats [b, 192, 3], ctx
// [b, 3, d], ds [b * 192] in the compute type (elem 2: bf16, 4: float32);
// the eight float32 parameters (as bbx_evaluator takes them); scratch:
// layout, x0, dz0 (compute type, 16-byte aligned), stile and the records
// (float32), sized by bbx_evaluator_grad_sizes.
extern "C" int bbx_evaluator_grad_tiles(const void* planes, const void* feats, const void* ctx,
                                        const void* ds, const void* wc1, const void* bc1,
                                        const void* wc2, const void* bc2, const void* wd0,
                                        const void* bd0, const void* wd1, const void* bd1,
                                        void* layout, void* x0, void* dz0, void* stile,
                                        void* part, int b, int c1, int c2, int h, int d,
                                        int elem, void* stream) {
    if ((elem != 2 && elem != 4) || !ev_widths_ok(c1, c2, h, d))
        return (int)cudaErrorInvalidValue;
    if (b <= 0) return (int)cudaGetLastError();
    const void* params[8] = {wc1, bc1, wc2, bc2, wd0, bd0, wd1, bd1};
    const EvDims e = ev_dims(c1, c2, h, d);
    const int err = elem == 2
        ? evb_tiles<unsigned short>(planes, feats, ctx, ds, params, layout, x0, dz0, stile, part,
                                    b, e, stream)
        : evb_tiles<float>(planes, feats, ctx, ds, params, layout, x0, dz0, stile, part, b, e,
                           stream);
    return err ? err : (int)cudaGetLastError();
}

template <typename S>
static int evb_dense0(const void* x0, const void* dz0, void* partw, int b, const EvDims& e,
                      void* stream) {
    constexpr int T = EvbTile<S>::T;
    EvbPlan p;
    const int err = evb_plan<S>(b, e, p);
    if (err) return err;
    auto* const kernel = &evaluator_grad_dense0_kernel<S, T>;
    const int smem = evb_k8w_smem<S, T>(e);
    BBX_LAUNCH_SMEM(kernel, p.cols * p.splits, EVB_K8W_THREADS, smem, stream, (const S*)x0,
                    (const S*)dz0, (float*)partw, e, p.ntiles, p.splits, p.cols);
    return 0;
}

// K8w: x0 and dz0 as K8b wrote them (16-byte aligned); partw: the splits'
// partials [splits][hp][kx].
extern "C" int bbx_evaluator_grad_dense0(const void* x0, const void* dz0, void* partw, int b,
                                         int c1, int c2, int h, int d, int elem, void* stream) {
    if ((elem != 2 && elem != 4) || !ev_widths_ok(c1, c2, h, d))
        return (int)cudaErrorInvalidValue;
    if (b <= 0) return (int)cudaGetLastError();
    const EvDims e = ev_dims(c1, c2, h, d);
    const int err = elem == 2 ? evb_dense0<unsigned short>(x0, dz0, partw, b, e, stream)
                              : evb_dense0<float>(x0, dz0, partw, b, e, stream);
    return err ? err : (int)cudaGetLastError();
}

template <typename S>
static int evb_reduce(const void* part, const void* partw, const void* stile, const void* layout,
                      void* grads, void* dctx, int b, const EvDims& e, void* stream) {
    constexpr int T = EvbTile<S>::T;
    EvbPlan p;
    const int err = evb_plan<S>(b, e, p);
    if (err) return err;
    const EvbRecord rec = evb_record(e);
    const EvbReduceGrid g = evb_reduce_grid(b, e, rec);
    // Two launches, the sums' blocks and dctx's (at B = 2048 on an H100 2%
    // faster than one launch of all: torch_k8b_parts.py's reduce_fused).
    auto* const kernel = &evaluator_grad_reduce_kernel<S, T>;
    BBX_LAUNCH(kernel, g.rec + g.w0, 256, stream,
               (const float*)part, p.blocks, rec, (const float*)partw, p.splits,
               (const float*)stile, (const S*)layout, e, (float*)grads, (S*)dctx, b * 3, g, 0);
    BBX_LAUNCH(kernel, g.ctx, 256, stream,
               (const float*)part, p.blocks, rec, (const float*)partw, p.splits,
               (const float*)stile, (const S*)layout, e, (float*)grads, (S*)dctx, b * 3, g,
               g.rec + g.w0);
    return 0;
}

// The reduction: the records and K8w's partials into grads (float32, the
// eight parameters flat in order, bbx_evaluator_grad_sizes out[6]), and the
// context's gradient dctx [b, 3, d] in the compute type from the tiles' dz0
// sums and the layout K8b wrote.
extern "C" int bbx_evaluator_grad_reduce(const void* part, const void* partw, const void* stile,
                                         const void* layout, void* grads, void* dctx, int b,
                                         int c1, int c2, int h, int d, int elem, void* stream) {
    if ((elem != 2 && elem != 4) || !ev_widths_ok(c1, c2, h, d))
        return (int)cudaErrorInvalidValue;
    if (b <= 0) return (int)cudaGetLastError();
    const EvDims e = ev_dims(c1, c2, h, d);
    const int err = elem == 2
        ? evb_reduce<unsigned short>(part, partw, stile, layout, grads, dctx, b, e, stream)
        : evb_reduce<float>(part, partw, stile, layout, grads, dctx, b, e, stream);
    return err ? err : (int)cudaGetLastError();
}
