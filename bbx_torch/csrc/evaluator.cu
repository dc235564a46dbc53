// K8: the AfterstateNetwork evaluator's forward, fused -- per afterstate,
// conv 3x3 2 -> C1 (SAME) + bias, ReLU; conv 3x3 C1 -> C2 + bias, ReLU;
// flatten in (h, w, c) order; Dense [flat, 3 features, ctx] -> H + bias,
// ReLU; Dense H -> 1 + bias -- reading K4's planes and features and the
// set-sum context, writing only the scores.
//
// Replaces bbx/models/afterstate.py: _Evaluator (:106-127, under nn.remat at
// :185), which XLA -- and the port's plain version, cuDNN convolutions, a
// concatenation and cuBLAS GEMMs -- runs layer by layer through [M, C, 8, 8]
// activations in device memory (302 MB each at M = 512 x 192 in bf16).
//
// Bound by operations: about 0.51 M multiply-adds an afterstate at run9's
// widths (conv1 27.6 K, conv2 331.8 K, dense0 147.5 K), 100 GFLOP at
// M = 512 x 192 (0.10 ms at the bf16 tensor-core peak), against 26 MB of
// input.  A tile of T afterstates lies in one (lane, slot), because T
// divides a slot's 64 anchors: T = 64 in bf16, the whole (lane, slot), and
// 16 in float32, whose activations are twice as wide (at 32 channels and
// a hidden width of 128 a float32 tile of 32 needs more shared memory than
// the H100's 232,448 bytes).  A persistent grid (SMs x resident blocks) of
// 8T-thread blocks walks the tiles, block i taking tiles i, i + G, ...; a
// block stages conv1's and conv2's weights, the biases and dense0's
// feature rows once for its life, and keeps every activation in shared
// memory.  One thread keeps the next tile's planes and features landing
// (cp.async.bulk into a buffer, bulk.cuh) while the current tile computes.
// A tile's planes go into [T][10][10][2] with a zero halo, the context's
// part of dense0 is one [D] . [D, H] product a tile -- a (lane, slot) in
// bf16 -- and the block walks the 8 image rows (evaluator.cuh):
//   conv1, on the tensor cores as W1 [C1 x 32] . patches [32 x 8T] (k =
//     dy * 8 + dx * 2 + channel: one dy's 8 k values are contiguous
//     padded pixels), into a ring of three rows [T][10][C1] whose columns
//     0 and 9 stay zero;
//   conv2, an implicit GEMM (rows: T afterstates x 8 columns; each k16
//     step two taps of one 8-channel group, whose addresses come from a
//     table of the row's taps), A by ldmatrix from the ring, B (its
//     weights) by ldmatrix from shared memory, writing one output row
//     [T][8 C2] -- dense0's k-slice of that row in the flatten order;
//   dense0, accumulating that slice into [T][H] float32 accumulators held
//     in registers across the rows, its k-steps split between the two
//     halves of the warps.  In bf16 its B operand, W0's blocks of that
//     image row (36.9 KB at run9), lands in shared memory by one bulk copy
//     while the row's convolutions run, in two buffers where they fit
//     beside the rest and one otherwise (the widest), and is read there by
//     ldmatrix; every W0 element is read from L2 once a 64-afterstate tile
//     (0.45 GB at M = 512 x 192; once a tile of 32 before).  Where even one
//     row's does not fit, and in float32 (73.7 KB at run9), every warp
//     reads its B from L2 at the product.
// The float32 instantiation runs the same walk with a scalar product on
// the CUDA cores.  The feature columns' part of dense0 is 3 multiply-adds
// an output; it and the context's part stay in the accumulator type until
// they join the main sum.  Each layer rounds to the compute type after its
// bias and ReLU, as the plain version does, and every sum is formed in the
// order the backward's recompute forms it (evaluator.cuh), so that its
// ReLU decisions are K8's.  At run9 widths on the H100 conv2's operand
// loads through shared memory take most of the time (PERF.md).
//
// The weights are laid out on the card at every call by a second, small
// kernel from the module's float32 parameters (never stale; evaluator.cuh,
// which also holds the tile's forward up to dense0, shared with the
// backward in evaluator_backward.cu).
// Limits: C1, C2 <= 32, H <= 128, D <= 256.
#include "bulk.cuh"
#include "evaluator.cuh"

// K8's shared memory: the forward's regions, then the next tile's planes
// [T][8][8][2] and features [T][3] as they land, three mbarriers and, with
// W0S, dense0's B blocks of two image rows (c2p / 2 k16 steps each), or of
// one where two do not fit (at the widest).
template <typename S, int T, bool W0S>
static EvSmem ev_smem(const EvDims& e) {
    EvSmem s;
    const EvSizes<S, T> z = ev_sizes<S, T>(e, s);
    const int es = (int)sizeof(S);
    EvTake take;
    s.in = take(z.in);
    s.zero = take(32 * es);  // a row of zeros for A or B
    s.w1a = take(z.w1a);
    s.w2 = take(z.w2);
    s.f32 = take(z.f32);
    s.ring = take(z.ring);
    s.stage = take(z.stage);
    s.raw = take(T * 131 * es);
    s.bars = take(32);
    if (W0S) {
        s.w0b = e.c2p / 2 * e.nt0 * 128 * es;
        s.w0n = take.at + 2 * s.w0b <= EV_SMEM_LIMIT ? 2 : 1;
        s.w0s = take(s.w0n * s.w0b);
    }
    s.total = take.at;
    return s;
}

// What stays the same from tile to tile: the row of zeros (and the zeros
// after the planes), conv1's A and conv2's B blocks (16 bytes a thread a
// pass), and as float32 the biases, dense0's feature rows and dense1's
// weights, staged once a block (the backward's ev_forward_tile, in
// evaluator.cuh, stages the same once a tile).
template <typename S, int T>
__device__ __forceinline__ void ev_stage_weights(const S* __restrict__ lay, const EvDims& e,
                                                 const EvSmem& sm, unsigned char* smem) {
    constexpr int NTH = 8 * T;
    S* s_in = (S*)(smem + sm.in);
    S* s_zero = (S*)(smem + sm.zero);
    float* s_f = (float*)(smem + sm.f32);
    const int tid = threadIdx.x;
    if (tid < 32) {
        s_zero[tid] = 0;
        if (tid < 16) s_in[T * 200 + tid] = 0;
    }
    {
        const uint4* src = (const uint4*)(lay + e.w1a);
        uint4* dst = (uint4*)(smem + sm.w1a);
        for (int i = tid; i < e.c1m * EV_W1_STRIDE * (int)sizeof(S) / 16; i += NTH)
            dst[i] = src[i];
        src = (const uint4*)(lay + e.w2);
        dst = (uint4*)(smem + sm.w2);
        for (int i = tid; i < e.ks2 * e.nt2 * 128 * (int)sizeof(S) / 16; i += NTH)
            dst[i] = src[i];
    }
    for (int i = tid; i < e.c1p; i += NTH) s_f[sm.b1c + i] = to_f(lay[e.b1c + i]);
    for (int i = tid; i < e.c2p; i += NTH) s_f[sm.b2 + i] = to_f(lay[e.b2 + i]);
    for (int i = tid; i < e.hp; i += NTH) {
        s_f[sm.b0 + i] = to_f(lay[e.b0 + i]);
        s_f[sm.w1 + i] = to_f(lay[e.w1 + i]);
    }
    for (int i = tid; i < 3 * e.hp; i += NTH) s_f[sm.w0f + i] = to_f(lay[e.w0f + i]);
}

// A tile's own inputs, from `first` (one lane and slot): its planes into
// [T][10][10][2] with a zero halo (thread (a, y) copies image row y of
// afterstate a from `planes`, the tile's [T][8][8][2], 16-byte aligned, in
// device or shared memory), the ring's zero columns, its features
// (`feats`, [T][3]) as float32, and the context's part of dense0, one [d]
// . [d, hp] product for the tile's (lane, slot) in the accumulator type.
template <typename S, int T>
__device__ __forceinline__ void ev_tile_inputs(const S* planes, const S* feats,
                                               const S* __restrict__ ctx,
                                               const S* __restrict__ lay, const EvDims& e,
                                               const EvSmem& sm, unsigned char* smem,
                                               size_t first) {
    constexpr int NTH = 8 * T;
    using Acc = typename EvAccT<S>::type;
    S* s_in = (S*)(smem + sm.in);
    S* s_ring = (S*)(smem + sm.ring);
    float* s_f = (float*)(smem + sm.f32);
    Acc* s_ctx = (Acc*)(s_f + sm.ctx);
    const int tid = threadIdx.x, c1p = e.c1p;
    {
        const int a = tid >> 3, y = tid & 7;
        const uint4* src = (const uint4*)(planes + a * 128 + y * 16);
        S* row = s_in + (a * 10 + y + 1) * 20;
        if constexpr (sizeof(S) == 2) {
            unsigned* d = (unsigned*)row;
            const uint4 v0 = src[0], v1 = src[1];
            d[0] = 0;
            d[1] = v0.x;
            d[2] = v0.y;
            d[3] = v0.z;
            d[4] = v0.w;
            d[5] = v1.x;
            d[6] = v1.y;
            d[7] = v1.z;
            d[8] = v1.w;
            d[9] = 0;
        } else {
            row[0] = row[1] = row[18] = row[19] = 0.0f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint4 v = src[q];
                row[2 + 4 * q] = __uint_as_float(v.x);
                row[3 + 4 * q] = __uint_as_float(v.y);
                row[4 + 4 * q] = __uint_as_float(v.z);
                row[5 + 4 * q] = __uint_as_float(v.w);
            }
        }
        if (y == 0 || y == 7) {
            S* edge = s_in + (a * 10 + (y == 0 ? 0 : 9)) * 20;
            for (int i = 0; i < 20; ++i) edge[i] = 0;
        }
    }
    for (int i = tid; i < 3 * T * 2 * c1p; i += NTH) {
        const int row = i / (2 * c1p), side = (i / c1p) & 1;
        s_ring[(row * 10 + side * 9) * c1p + i % c1p] = 0;
    }
    for (int i = tid; i < 3 * T; i += NTH) s_f[sm.feats + i] = to_f(feats[i]);
    const int lane = (int)(first / EV_ACTIONS), slot = (int)(first % EV_ACTIONS) / 64;
    const S* crow = ctx + ((size_t)lane * 3 + slot) * e.d;
    for (int hh = tid; hh < e.hp; hh += NTH) {
        Acc s4[4] = {0, 0, 0, 0};
        int dd = 0;
        for (; dd + 4 <= e.d; dd += 4) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                s4[q] += (Acc)to_f(crow[dd + q]) * to_f(lay[e.w0x + (dd + q) * e.hp + hh]);
        }
        for (; dd < e.d; ++dd) s4[0] += (Acc)to_f(crow[dd]) * to_f(lay[e.w0x + dd * e.hp + hh]);
        s_ctx[hh] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
}

// The tile's walk over its 8 image rows, up to dense0's output (after
// ev_tile_inputs and a barrier): leaves h = relu(dense0) rounded, as
// float, in [T][hp + 1] at sm.ring.  conv1 and conv2 row by row through
// the ring and the stage; dense0 accumulated across the rows, each sum in
// the order of the backward's ev_forward_tile (evaluator.cuh), its B
// operand from `w0(r, s)`: where k16 step s of image row r's B
// blocks lies (nt0 n8 tiles from there; in shared memory with B_LDM,
// anywhere otherwise).  Every thread of the block calls it.  `ready(r)`
// runs on every thread before dense0's product of row r and `done(r)`
// after the barrier that ends row r (the kernel waits there for W0's
// slices and fetches the next).  conv2 runs with its channel-group loop
// unrolled (evaluator.cuh's ev_conv3_row).
template <typename S, int T, bool B_LDM, class W0, class Ready, class Done>
__device__ __forceinline__ void ev_tile_rows(const EvDims& e, const EvSmem& sm,
                                             unsigned char* smem, const W0& w0,
                                             const Ready& ready, const Done& done) {
    constexpr int W = T / 4;
    using Acc = typename EvAccT<S>::type;
    const S* s_in = (const S*)(smem + sm.in);
    const S* s_zero = (const S*)(smem + sm.zero);
    const S* s_w1a = (const S*)(smem + sm.w1a);
    const S* s_w2 = (const S*)(smem + sm.w2);
    const float* s_f = (const float*)(smem + sm.f32);
    const Acc* s_ctx = (const Acc*)(s_f + sm.ctx);
    S* s_ring = (S*)(smem + sm.ring);
    Acc* s_odd = (Acc*)(smem + sm.ring);
    float* s_hid = (float*)(smem + sm.ring);
    S* s_stage = (S*)(smem + sm.stage);

    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int c1p = e.c1p, sstr = 8 * e.c2p + 8;
    auto sync = [] { __syncthreads(); };

    // conv1 row y into ring row y % 3, columns 1-8.
    auto conv1_row = [&](int y) {
        S* out = s_ring + (y % 3) * T * 10 * c1p;
        ev_conv1_row<S, T>(s_in, s_w1a, s_zero, s_f + sm.b1c, e, y,
                           [&](int ch, int x, int a, S v) { out[(a * 10 + x + 1) * c1p + ch] = v; });
    };
    conv1_row(0);
    conv1_row(1);
    sync();

    // dense0's accumulators: every m-tile (afterstates 16 i .. + 15, i <
    // T / 16) by n-tiles n0, n0 + W / 2, ... (those below nt0, at most
    // NT0 of the 16), over the k-steps of parity kq: the two halves of the
    // warps split dense0's k, and their sums meet at the end, so that each
    // k-step's activation rows are read by half the warps.
    constexpr int NT0 = 32 / W;
    const int kq = warp / (W / 2), n0 = warp % (W / 2);
    const int nt0w = e.nt0 > n0 ? (e.nt0 - n0 + W / 2 - 1) / (W / 2) : 0;
    Acc acc[T / 16][NT0][4];
    zero(acc);

    for (int r = 0; r < 8; ++r) {
        // conv2, output row r, into the stage: dense0's k-slice of that row
        // in the flatten order.
        Acc c[2][4][4];
        ev_conv3_row<S, T, Acc, true>(c, s_ring, c1p, e.cg1, s_w2, e.nt2, s_zero, r);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < e.nt2) {
                    const int col = j * 8 + 2 * t;
                    const float b0 = s_f[sm.b2 + col], b1 = s_f[sm.b2 + col + 1];
                    S* o = s_stage + 2 * (warp + W * i) * sstr + g * e.c2p + col;
                    store2(o, relu_to<S>(c[i][j][0] + b0), relu_to<S>(c[i][j][1] + b1));
                    store2(o + sstr, relu_to<S>(c[i][j][2] + b0), relu_to<S>(c[i][j][3] + b1));
                }
            }
        }
        sync();

        // dense0 over row r's k-slice (8 c2p columns of the flatten order),
        // then conv1 for row r + 2 into the ring row conv2 just finished.
        ready(r);
#pragma unroll 2
        for (int s = kq; s < e.c2p / 2; s += 2) {
            const S* wb = w0(r, s);
            auto a = [&](int i, int row, int half) -> const S* {
                return s_stage + (i * 16 + row) * sstr + s * 16 + half * 8;
            };
            auto b = [&](int j, int half, int col) -> const S* {
                return wb + (n0 + (W / 2) * j) * 128 + half * 64 + col * 8;
            };
            tile_k16<T / 16, NT0, B_LDM, S>(acc, a, b, T / 16, nt0w);
        }
        if (r + 2 < 8) conv1_row(r + 2);
        sync();
        done(r);
    }

    // dense0's epilogue: the odd k-steps' sums, in [T][hp + 1] over the
    // ring, join the even ones'; + features' part + context's part + bias
    // (all in the accumulator type), ReLU, rounded once, into [T][hp + 1]
    // float32 there.
    auto each_acc = [&](auto&& fn) {
#pragma unroll
        for (int i = 0; i < T / 16; ++i) {
#pragma unroll
            for (int j = 0; j < NT0; ++j) {
                if (j < nt0w) {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        fn(acc[i][j][k], i * 16 + g + (k >> 1) * 8,
                           (n0 + (W / 2) * j) * 8 + 2 * t + (k & 1));
                }
            }
        }
    };
    if (kq == 1) each_acc([&](Acc& v, int a, int hh) { s_odd[a * (e.hp + 1) + hh] = v; });
    sync();
    if (kq == 0) {
        each_acc([&](Acc& v, int a, int hh) {
            const float* fa = s_f + sm.feats + a * 3;
            const float* wf = s_f + sm.w0f + hh;
            const Acc fsum = (Acc)fa[0] * wf[0] + (Acc)fa[1] * wf[e.hp] + (Acc)fa[2] * wf[2 * e.hp];
            v = (v + s_odd[a * (e.hp + 1) + hh]) + (fsum + s_ctx[hh]) + (Acc)s_f[sm.b0 + hh];
        });
    }
    sync();
    if (kq == 0)
        each_acc([&](Acc& v, int a, int hh) { s_hid[a * (e.hp + 1) + hh] = to_f(relu_to<S>(v)); });
    sync();
}


// planes [B*192][8][8][2], feats [B*192][3], ctx [B][3][d], all S; lay the
// weight layout; scores [B*192] S.  A persistent grid of blocks of 8T
// threads (T / 4 warps) over the ntiles tiles of T afterstates; T divides
// 64.  With W0S dense0's B blocks come through shared memory, an image
// row's at a time, in sm.w0n buffers.
template <typename S, int T, bool W0S>
__global__ void __launch_bounds__(8 * T)
evaluator_kernel(const S* __restrict__ planes, const S* __restrict__ feats,
                 const S* __restrict__ ctx, const S* __restrict__ lay,
                 S* __restrict__ scores, EvDims e, EvSmem sm, int ntiles) {
    BBX_DYNAMIC_SHARED(smem);
    // bar_in: the tile's planes and features; bar_w0[u]: W0's slice in
    // buffer u, which holds image rows u, u + w0n, ...
    unsigned long long* bar_in = (unsigned long long*)(smem + sm.bars);
    unsigned long long* bar_w0 = bar_in + 1;
    S* s_raw = (S*)(smem + sm.raw);
    unsigned char* s_w0 = smem + sm.w0s;
    const float* s_f = (const float*)(smem + sm.f32);
    const float* s_hid = (const float*)(smem + sm.ring);
    float* s_part = (float*)(smem + sm.stage);
    const int tid = threadIdx.x, ks = e.c2p / 2, w0n = sm.w0n;
    const unsigned in_bytes = T * 128 * sizeof(S), f_bytes = T * 3 * sizeof(S);
    // One thread: a tile's planes and features into s_raw, image row r's B
    // blocks of W0 into its buffer, each counted off its barrier.
    auto fetch_inputs = [&](int tile) {
        bbx_mbar_expect_tx(bar_in, in_bytes + f_bytes);
        bbx_bulk_copy(s_raw, planes + (size_t)tile * T * 128, in_bytes, bar_in);
        bbx_bulk_copy(s_raw + T * 128, feats + (size_t)tile * T * 3, f_bytes, bar_in);
    };
    auto fetch_w0 = [&](int r) {
        const int u = r % w0n;
        bbx_mbar_expect_tx(bar_w0 + u, sm.w0b);
        bbx_bulk_copy(s_w0 + u * sm.w0b, lay + e.w0 + (size_t)r * ks * e.nt0 * 128, sm.w0b,
                      bar_w0 + u);
    };
    if (tid == 0) {
        bbx_mbar_init(bar_in, 1);
        bbx_mbar_init(bar_w0, 1);
        bbx_mbar_init(bar_w0 + 1, 1);
        bbx_mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
        fetch_inputs(blockIdx.x);
        if constexpr (W0S)
            for (int r = 0; r < w0n; ++r) fetch_w0(r);
    }
    ev_stage_weights<S, T>(lay, e, sm, smem);
    // A barrier's k-th use completes its phase k, of parity k & 1: bar_in's
    // k-th is this block's k-th tile; a tile uses bar_w0[u] 8 / w0n times, an
    // even number, so row r's use has the parity of r / w0n.
    unsigned n_in = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const size_t first = (size_t)tile * T;
        const bool more = tile + (int)gridDim.x < ntiles;
        bbx_mbar_wait(bar_in, n_in++ & 1);
        ev_tile_inputs<S, T>(s_raw, s_raw + T * 128, ctx, lay, e, sm, smem, first);
        __syncthreads();
        if (tid == 0 && more) fetch_inputs(tile + gridDim.x);
        ev_tile_rows<S, T, W0S>(
            e, sm, smem,
            [&](int r, int s) -> const S* {
                if constexpr (W0S) {
                    return (const S*)(s_w0 + r % w0n * sm.w0b) + s * e.nt0 * 128;
                } else {
                    return lay + e.w0 + ((size_t)r * ks + s) * e.nt0 * 128;
                }
            },
            [&](int r) {
                if constexpr (W0S) bbx_mbar_wait(bar_w0 + r % w0n, (r / w0n) & 1);
            },
            [&](int r) {
                // Row r's buffer is free: the row w0n on (of the next tile
                // past row 7).
                if constexpr (W0S) {
                    if (tid == 0 && (r + w0n < 8 || more)) fetch_w0((r + w0n) % 8);
                }
            });

        // dense1: 8 threads an afterstate, then one.
        {
            const int a = tid >> 3, part = tid & 7;
            float s = 0.0f;
            for (int hh = part; hh < e.h; hh += 8) s += s_hid[a * (e.hp + 1) + hh] * s_f[sm.w1 + hh];
            s_part[tid] = s;
        }
        __syncthreads();
        if (tid < T) {
            const float* q = s_part + 8 * tid;
            const float s = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]));
            scores[first + tid] = from_f<S>(s + to_f(lay[e.b1]));
        }
        __syncthreads();  // the next tile writes the ring and the stage
    }
}

template <typename S, int T, bool W0S>
static int evaluator_launch(const void* planes, const void* feats, const void* ctx,
                            const float* const* params, void* layout, void* scores,
                            int b, const EvDims& e, void* stream) {
    ev_launch_layout<S>(params, layout, e, e.fwd_total, stream);
    const EvSmem sm = ev_smem<S, T, W0S>(e);
    auto* const kernel = &evaluator_kernel<S, T, W0S>;
    static int smem_set[64];
    const int err = ev_allow_smem(kernel, sm.total, smem_set);
    if (err) return err;
    int dev = 0, sms = 1, resident = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 8 * T, sm.total);
    const int ntiles = b * (EV_ACTIONS / T);
    const int grid = sms * (resident > 1 ? resident : 1);
    BBX_LAUNCH_SMEM(kernel, grid < ntiles ? grid : ntiles, 8 * T, sm.total, stream,
                    (const S*)planes, (const S*)feats, (const S*)ctx, (const S*)layout,
                    (S*)scores, e, sm, ntiles);
    return 0;
}

// Elements of the forward's weight layout at these widths (0 beyond the
// limits).
extern "C" int bbx_evaluator_layout_size(int c1, int c2, int h, int d) {
    return ev_widths_ok(c1, c2, h, d) ? ev_dims(c1, c2, h, d).fwd_total : 0;
}

// planes [b, 192, 8, 8, 2] (16-byte aligned), feats [b, 192, 3], ctx [b, 3,
// d] in the compute type (elem 2: bf16, 4: float32); the eight float32
// parameters (conv1 weight [c1, 2, 3, 3] and bias, conv2 weight [c2, c1, 3,
// 3] and bias, dense0 weight [h, 64 c2 + 3 + d] and bias, dense1 weight
// [1, h] and bias); layout: bbx_evaluator_layout_size elements of scratch;
// scores [b * 192] out.
extern "C" int bbx_evaluator(const void* planes, const void* feats, const void* ctx,
                             const void* wc1, const void* bc1, const void* wc2,
                             const void* bc2, const void* wd0, const void* bd0,
                             const void* wd1, const void* bd1, void* layout, void* scores,
                             int b, int c1, int c2, int h, int d, int elem, void* stream) {
    if ((elem != 2 && elem != 4) || bbx_evaluator_layout_size(c1, c2, h, d) == 0)
        return (int)cudaErrorInvalidValue;
    if (b <= 0) return (int)cudaGetLastError();
    const float* params[8] = {(const float*)wc1, (const float*)bc1, (const float*)wc2,
                              (const float*)bc2, (const float*)wd0, (const float*)bd0,
                              (const float*)wd1, (const float*)bd1};
    const EvDims e = ev_dims(c1, c2, h, d);
    // bf16: tiles of TB afterstates (64: one (lane, slot) whole, 16 warps a
    // block), dense0's B through shared memory where an image row's fits
    // beside the rest.
    constexpr int TB = 64;
    const bool w0s = ev_smem<unsigned short, TB, true>(e).total <= EV_SMEM_LIMIT;
    const int err = elem == 4
        ? evaluator_launch<float, 16, false>(planes, feats, ctx, params, layout, scores, b, e,
                                             stream)
        : w0s ? evaluator_launch<unsigned short, TB, true>(planes, feats, ctx, params, layout,
                                                          scores, b, e, stream)
              : evaluator_launch<unsigned short, TB, false>(planes, feats, ctx, params, layout,
                                                           scores, b, e, stream);
    return err ? err : (int)cudaGetLastError();
}
