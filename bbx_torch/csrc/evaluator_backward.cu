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
//    (lane, slot) -- T = 32 in bf16, 16 in float32, whose shared memory is
//    twice as wide.  A tile recomputes K8's forward (ev_forward_tile) and
//    writes x0 ([tile][kx][T], afterstate innermost) and dz0 ([tile][hk]
//    [T]) for K8w, dz0's sum over the tile for the context, and keeps in
//    shared memory a2 > 0 as bits and dz0.  Then it walks the image rows
//    back, r = 7 .. 0, with rings of three rows in shared memory: conv1's
//    row r - 1 again (channel-major, afterstate innermost: the B operand
//    of dW2, whose k is the pixels); da2's row r = dz0 . W0t_r on the
//    tensor cores (W0t_r: W0's columns of row r, transposed by the layout
//    kernel, read from L2), masked; dW2 += da2_r^T . patches(a1) on the
//    tensor cores (k = the row's pixels, afterstate innermost, so each
//    column's 8 k values are contiguous; a per-row table gives each
//    column's offset), its accumulators in registers for the block's
//    life; da1's row r + 1 as the SAME convolution of da2's rows r .. r + 2
//    with the flipped, transposed weights (ev_conv3_row, as conv2's
//    forward), masked; dW1 and the biases' sums on the CUDA cores, dW1 by
//    items (channel, input channel, image column) that read each da1 value
//    once for their 9 taps.  The block writes one record of float32
//    partial sums.  The forward's sums run in float64 in the float32
//    instantiation, as in K8's (evaluator.cuh), so the recompute rounds
//    each activation once and K8b's ReLU masks are K8's.
//  * bbx_evaluator_grad_dense0 (K8w): dW0 = dz0^T . x0, split over the
//    afterstates into chunks of tiles: a block a (128 columns of x0, chunk),
//    128 afterstates staged in shared memory a pass, mma.sync products
//    (mma.cuh), one float32 partial a chunk.  dW0 is 96 x 1,571 float32 at
//    run9 (603 KB): it cannot be one block's accumulator.
//  * bbx_evaluator_grad_reduce: every gradient element summed over the
//    records or chunks in a fixed order, rounded once; and dctx, each
//    (lane, slot)'s dz0 sum times W0's context columns.
#include "evaluator.cuh"

#define EVB_K8W_COLS 128  // x0 columns a K8w block
#define EVB_K8W_STAGE 128  // afterstates a K8w pass
#define EVB_K8W_MAX_CHUNKS 64

template <typename S>
struct EvbTile;
template <>
struct EvbTile<unsigned short> { static constexpr int T = 32; };
template <>
struct EvbTile<float> { static constexpr int T = 16; };

// Byte offsets of K8b's shared memory: the forward's regions (f), and the
// backward's, which reuse the forward's ring and stage once the tile's
// forward is done.
struct EvbSmem {
    EvSmem f;
    int a1t, da2, da2t, dz0, mask, bsum, ds, cols, total;
};

template <typename S, int T>
static EvbSmem evb_smem(const EvDims& e) {
    const int es = (int)sizeof(S);
    EvbSmem s;
    const EvSizes<S, T> z = ev_sizes<S, T>(e, s.f);
    auto larger = [](int x, int y) { return x > y ? x : y; };
    EvTake take;
    s.f.in = take(z.in);
    s.f.zero = take(32 * es);
    s.f.w1a = take(z.w1a);
    s.f.w2 = take(z.w2);  // conv2's weights, then the transposed ones (as large)
    s.f.f32 = take(z.f32);
    // The forward's ring and dense0's output; then a1 [c1p][3 rows][10][T] (+8).
    s.f.ring = s.a1t = take(larger(z.ring, e.c1p * (30 * T + 8) * es));
    // The forward's stage; then da2 [3 rows][T][10][c2p].
    s.f.stage = s.da2 = take(larger(z.stage, 3 * T * 10 * e.c2p * es));
    // da2's row channel-major [c2p][8][T] (+8); then da1's row [c1p][8][T].
    s.da2t = take(larger(e.c2p * (8 * T + 8), e.c1p * 8 * T) * es);
    s.dz0 = take(T * (e.hk + 8) * es);
    s.mask = take(64 * e.c2p * 4);
    s.bsum = take(8 * EV_MAX_C * 4);
    s.ds = take(T * 4);
    s.cols = take(9 * EV_MAX_C * 4);
    s.f.total = s.total = take.at;
    return s;
}

// The block record's offsets (floats): conv1 weight [c1][2][3][3] and
// bias, conv2 weight [c2][c1][3][3] and bias, dense0 bias, dense1 weight
// and bias.
struct EvbRecord {
    int w1, b1, w2, b2, b0, wd1, bd1, size;
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
    return r;
}

// ---------------------------------------------------------------------------
// K8b: a tile's forward again, and its backward row by row.
// ---------------------------------------------------------------------------

template <typename S, int T>
__global__ void __launch_bounds__(8 * T)
evaluator_grad_tiles_kernel(const S* __restrict__ planes, const S* __restrict__ feats,
                            const S* __restrict__ ctx, const S* __restrict__ lay,
                            const S* __restrict__ dscores, S* __restrict__ x0,
                            S* __restrict__ dz0g, float* __restrict__ stile,
                            float* __restrict__ part, EvDims e, EvbSmem sm, EvbRecord rec,
                            int ntiles) {
    constexpr int NTH = 8 * T, NW = T / 4;
    BBX_DYNAMIC_SHARED(smem);
    const S* s_in = (const S*)(smem + sm.f.in);
    const S* s_zero = (const S*)(smem + sm.f.zero);
    const S* s_w1a = (const S*)(smem + sm.f.w1a);
    S* s_w = (S*)(smem + sm.f.w2);
    const float* s_f = (const float*)(smem + sm.f.f32);
    const float* s_hid = (const float*)(smem + sm.f.ring);
    S* s_a1t = (S*)(smem + sm.a1t);
    S* s_da2 = (S*)(smem + sm.da2);
    S* s_da2t = (S*)(smem + sm.da2t);
    S* s_da1 = (S*)(smem + sm.da2t);
    S* s_dz0 = (S*)(smem + sm.dz0);
    unsigned* s_mask = (unsigned*)(smem + sm.mask);
    float* s_bsum = (float*)(smem + sm.bsum);
    float* s_ds = (float*)(smem + sm.ds);
    int* s_cols = (int*)(smem + sm.cols);

    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int c1p = e.c1p, c2p = e.c2p;
    const int A1S = 30 * T + 8, D2S = 8 * T + 8, DZS = e.hk + 8;

    // The block's sums over its tiles.  dW2: the tensor-core accumulators,
    // m = c2 (two m16 tiles), n = (tap, c1) in 9 cg1 n8 tiles, this warp's
    // n-tiles warp, warp + NW, ...
    constexpr int NTW = (9 * EV_MAX_C / 8 + NW - 1) / NW;
    const int n2 = 9 * e.cg1;
    const int ntw = warp < n2 ? (n2 - warp + NW - 1) / NW : 0;
    const int mt2 = (c2p + 15) / 16;
    float acc2[2][NTW][4];
    zero(acc2);
    // dW1 and conv1's bias: items it = tid + NTH u of [c1][ci 2][x 8], each
    // the 9 taps' sums over its column x (and, for ci 0, the bias's).
    constexpr int U1 = (16 * EV_MAX_C + NTH - 1) / NTH;
    float acc1[U1][10];
    // conv2's bias: partial sums o = tid + NTH u of [c2p][8 columns].
    constexpr int U2 = (8 * EV_MAX_C + NTH - 1) / NTH;
    float accb2[U2];
    for (int u = 0; u < U1; ++u)
        for (int q = 0; q < 10; ++q) acc1[u][q] = 0.0f;
    for (int u = 0; u < U2; ++u) accb2[u] = 0.0f;
    float acc_db0 = 0.0f, acc_dwd1 = 0.0f, acc_dbd1 = 0.0f;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const size_t first = (size_t)tile * T;
        const int ls = (int)(first / 64);  // lane * 3 + slot
        S* xt = x0 + (size_t)tile * e.kx * T;
        __syncthreads();  // the previous tile's reads are done
        for (int i = tid; i < T; i += NTH) s_ds[i] = to_f(dscores[first + i]);
        // x0's feature and context columns (and the zero columns to kx).
        for (int i = tid; i < (e.kx - 64 * c2p) * T; i += NTH) {
            const int j = i / T, a = i % T;
            S v = 0;
            if (j < 3) {
                v = feats[(first + a) * 3 + j];
            } else if (j < 3 + e.d) {
                v = ctx[(size_t)ls * e.d + j - 3];
            }
            xt[(size_t)(64 * c2p + j) * T + a] = v;
        }

        // The forward, storing each row of a2 into x0 and its signs as bits.
        ev_forward_tile<S, T>(
            planes, feats, ctx, lay, e, sm.f, smem, first, [&](int r, const S* stage, int sstr) {
                for (int i = tid; i < 8 * c2p * T; i += NTH) {
                    const int k = i / T, a = i % T;  // k = x c2p + c
                    const S v = stage[a * sstr + k];
                    xt[(size_t)(r * 8 * c2p + k) * T + a] = v;
                    const unsigned bits = __ballot_sync(0xFFFFFFFFu, to_f(v) > 0.0f);
                    if (a == 0) {
                        if constexpr (T == 32) {
                            s_mask[r * 8 * c2p + k] = bits;
                        } else {
                            s_mask[r * 8 * c2p + k] = (bits >> (tid & 16)) & 0xFFFFu;
                        }
                    }
                }
            });

        // dz0 = ds w1 where h > 0, rounded: [T][hk + 8] here, [hk][T] for K8w.
        for (int i = tid; i < T * e.hk; i += NTH) {
            const int hh = i / T, a = i % T;
            S v = 0;
            if (hh < e.hp && s_hid[a * (e.hp + 1) + hh] > 0.0f)
                v = from_f<S>(s_ds[a] * s_f[sm.f.w1 + hh]);
            s_dz0[a * DZS + hh] = v;
            dz0g[((size_t)tile * e.hk + hh) * T + a] = v;
        }
        __syncthreads();
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
        __syncthreads();  // the walk overwrites dense0's output

        // The walk's set-up: conv2's transposed weights over conv2's, the
        // rings' zero columns, conv1's row 7.
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
        auto conv1_row = [&](int y) {
            ev_conv1_row<S, T>(s_in, s_w1a, s_zero, s_f + sm.f.b1c, e, y,
                               [&](int ch, int x, int a, S v) {
                                   s_a1t[ch * A1S + ((y % 3) * 10 + x + 1) * T + a] = v;
                               });
        };
        conv1_row(7);

        for (int r = 7; r >= -1; --r) {
            if (r >= 1) conv1_row(r - 1);
            // dW2's B column n = (tap, c1) of this row: its offset in the a1
            // ring (its pixels k follow), or -1 where the tap's input row
            // lies outside the image.
            for (int n = tid; n < 9 * c1p; n += NTH) {
                const int tap = n / c1p, c = n % c1p, yy = r + tap / 3 - 1;
                s_cols[n] = yy < 0 || yy > 7 ? -1 : c * A1S + ((yy % 3) * 10 + tap % 3) * T;
            }
            if (r >= 0) {
                // da2's row r: [T] x [8 c2p] = dz0 [T x hk] . W0t_r [hk x 8 c2p],
                // this warp's n8 tiles warp, warp + NW, ...; masked, rounded,
                // into the ring (pixel-major) and channel-major.
                constexpr int MTB = T / 16, NTB = 32 / NW;
                const int ntb = warp < c2p ? (c2p - warp + NW - 1) / NW : 0;
                float cb[MTB][NTB][4];
                zero(cb);
                for (int ks = 0; ks < e.hk / 16; ++ks) {
                    auto a = [&](int i, int row, int half) -> const S* {
                        return s_dz0 + (i * 16 + row) * DZS + ks * 16 + half * 8;
                    };
                    auto b = [&](int j, int half, int col) -> const S* {
                        return lay + e.w0t +
                            (((size_t)r * (e.hk / 16) + ks) * c2p + warp + NW * j) * 128 +
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
                                const int n = (warp + NW * j) * 8 + 2 * t + (k & 1);
                                const int x = n / c2p, c = n % c2p;
                                const bool on = (s_mask[(r * 8 + x) * c2p + c] >> a) & 1u;
                                const S v = on ? from_f<S>(cb[i][j][k]) : (S)0;
                                s_da2[(((r % 3) * T + a) * 10 + x + 1) * c2p + c] = v;
                                s_da2t[c * D2S + x * T + a] = v;
                            }
                        }
                    }
                }
            }
            __syncthreads();
            if (r >= 0) {
                // dW2 += da2_r^T [c2 x (8 T pixels)] . patches(a1) [(8 T) x (9 c1p)].
                for (int ks = 0; ks < T / 2; ++ks) {
                    auto a = [&](int i, int row, int half) -> const S* {
                        const int c = i * 16 + row;
                        return c < c2p ? s_da2t + c * D2S + ks * 16 + half * 8 : s_zero;
                    };
                    auto b = [&](int j, int half, int col) -> const S* {
                        const int at = s_cols[(warp + NW * j) * 8 + col];
                        return at < 0 ? s_zero : s_a1t + at + ks * 16 + half * 8;
                    };
                    tile_k16<2, NTW, true, S>(acc2, a, b, mt2, ntw);
                }
                for (int u = 0; u < U2; ++u) {
                    const int o = tid + NTH * u;
                    if (o < 8 * c2p) {
                        const S* p = s_da2t + (o / 8) * D2S + (o % 8) * T;
                        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                        for (int a = 0; a < T; a += 4) {
#pragma unroll
                            for (int k = 0; k < 4; ++k) s4[k] += to_f(p[a + k]);
                        }
                        accb2[u] += (s4[0] + s4[1]) + (s4[2] + s4[3]);
                    }
                }
            }
            // da1's row r + 1: the transposed convolution of da2's rows r ..
            // r + 2, masked by a1 > 0, rounded, into [c1p][T][8] over da2t.
            const int y = r + 1;
            float cd[2][4][4];
            if (y <= 7) ev_conv3_row<S, T>(cd, s_da2, c2p, e.cg2, s_w, e.cg1, s_zero, y);
            __syncthreads();
            if (y <= 7) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (j < e.cg1) {
#pragma unroll
                            for (int k = 0; k < 4; ++k) {
                                const int a = 2 * (warp + NW * i) + (k >> 1), x = g;
                                const int c = j * 8 + 2 * t + (k & 1);
                                const bool on =
                                    to_f(s_a1t[c * A1S + ((y % 3) * 10 + x + 1) * T + a]) > 0.0f;
                                s_da1[(c * T + a) * 8 + x] = on ? from_f<S>(cd[i][j][k]) : (S)0;
                            }
                        }
                    }
                }
            }
            __syncthreads();
            if (y <= 7) {
                // dW1 [c1][ci][dy][dx] += sum over the row's pixels of da1 x
                // planes(y + dy - 1, x + dx - 1, ci): item (c, ci, x) keeps the 9
                // taps' sums over its column's afterstates, ci 0 also the bias's.
                for (int u = 0; u < U1; ++u) {
                    const int it = tid + NTH * u;
                    if (it < 16 * e.c1) {
                        const int c = it / 16, ci = (it / 8) % 2, x = it % 8;
                        const S* dr = s_da1 + c * T * 8 + x;
                        const S* in = s_in + y * 20 + x * 2 + ci;
                        for (int a = 0; a < T; ++a) {
                            const float d = to_f(dr[a * 8]);
                            const S* w = in + a * 200;
#pragma unroll
                            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                                for (int dx = 0; dx < 3; ++dx)
                                    acc1[u][dy * 3 + dx] += d * to_f(w[dy * 20 + dx * 2]);
                            acc1[u][9] += ci == 0 ? d : 0.0f;
                        }
                    }
                }
            }
            __syncthreads();
        }
    }

    // The block's record.  dW1's items join over their 8 columns in order,
    // through shared memory (the a1 ring, free now).
    float* out = part + (size_t)blockIdx.x * rec.size;
    float* s_items = (float*)(smem + sm.a1t);
    __syncthreads();
    for (int u = 0; u < U1; ++u) {
        const int it = tid + NTH * u;
        if (it < 16 * e.c1)
            for (int q = 0; q < 10; ++q) s_items[it * 10 + q] = acc1[u][q];
    }
    __syncthreads();
    for (int o = tid; o < 19 * e.c1; o += NTH) {
        const int c = o / 19, q = o % 19;  // q: ci 9 + tap, or 18 for the bias
        const int ci = q < 18 ? q / 9 : 0, k = q < 18 ? q % 9 : 9;
        float s = 0.0f;
        for (int x = 0; x < 8; ++x) s += s_items[((c * 2 + ci) * 8 + x) * 10 + k];
        out[q < 18 ? rec.w1 + c * 18 + q : rec.b1 + c] = s;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
            if (j < ntw) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int c = i * 16 + g + (k >> 1) * 8;
                    const int n = (warp + NW * j) * 8 + 2 * t + (k & 1);
                    const int tap = n / c1p, ci = n % c1p;
                    if (c < e.c2 && ci < e.c1) out[rec.w2 + (c * e.c1 + ci) * 9 + tap] = acc2[i][j][k];
                }
            }
        }
    }
    for (int u = 0; u < U2; ++u) {
        const int o = tid + NTH * u;
        if (o < 8 * c2p) s_bsum[o] = accb2[u];
    }
    __syncthreads();
    if (tid < e.c2) {
        float s = 0.0f;
        for (int x = 0; x < 8; ++x) s += s_bsum[tid * 8 + x];
        out[rec.b2 + tid] = s;
    }
    if (tid < e.h) {
        out[rec.b0 + tid] = acc_db0;
        out[rec.wd1 + tid] = acc_dwd1;
    }
    if (tid == 0) out[rec.bd1] = acc_dbd1;
}

// ---------------------------------------------------------------------------
// K8w: dW0 = dz0^T . x0, split over chunks of tiles.
// ---------------------------------------------------------------------------

// 8 elements (16 bytes in bf16, 32 in float32) from src, or zeros.
template <typename S>
__device__ __forceinline__ void copy8(S* dst, const S* src, bool on) {
    uint4* d = (uint4*)dst;
    const uint4* s = (const uint4*)src;
#pragma unroll
    for (int q = 0; q < (int)sizeof(S) / 2; ++q) d[q] = on ? s[q] : make_uint4(0, 0, 0, 0);
}

template <typename S, int T>
__global__ void __launch_bounds__(256)
evaluator_grad_dense0_kernel(const S* __restrict__ x0, const S* __restrict__ dz0g,
                             float* __restrict__ partw, EvDims e, int ntiles, int per_chunk,
                             int cols) {
    constexpr int TPS = EVB_K8W_STAGE / T, KS = EVB_K8W_STAGE + 8;
    BBX_DYNAMIC_SHARED(smem);
    S* s_a = (S*)smem;             // dz0 [hk][KS]: m = h, k = afterstates
    S* s_b = s_a + e.hk * KS;      // x0 [128 columns][KS]: n = column, k = afterstates
    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    // Block (column tile, chunk) = (blockIdx.x % cols, blockIdx.x / cols).
    const int chunk = blockIdx.x / cols;
    const int c0 = (blockIdx.x % cols) * EVB_K8W_COLS;
    const int t0 = chunk * per_chunk;
    const int t1 = t0 + per_chunk < ntiles ? t0 + per_chunk : ntiles;
    const int mt = e.hk / 16;
    float acc[EV_MAX_H / 16][2][4];
    zero(acc);
    for (int ts = t0; ts < t1; ts += TPS) {
        __syncthreads();
        for (int i = tid; i < e.hk * (EVB_K8W_STAGE / 8); i += 256) {
            const int hh = i / (EVB_K8W_STAGE / 8), m = (i % (EVB_K8W_STAGE / 8)) * 8;
            const int tile = ts + m / T;
            copy8(s_a + hh * KS + m, dz0g + ((size_t)tile * e.hk + hh) * T + m % T, tile < t1);
        }
        for (int i = tid; i < EVB_K8W_COLS * (EVB_K8W_STAGE / 8); i += 256) {
            const int cc = i / (EVB_K8W_STAGE / 8), m = (i % (EVB_K8W_STAGE / 8)) * 8;
            const int tile = ts + m / T, col = c0 + cc;
            copy8(s_b + cc * KS + m, x0 + ((size_t)tile * e.kx + col) * T + m % T,
                  tile < t1 && col < e.kx);
        }
        __syncthreads();
#pragma unroll 2
        for (int ks = 0; ks < EVB_K8W_STAGE / 16; ++ks) {
            auto a = [&](int i, int row, int half) -> const S* {
                return s_a + (i * 16 + row) * KS + ks * 16 + half * 8;
            };
            auto b = [&](int j, int half, int col) -> const S* {
                return s_b + ((2 * warp + j) * 8 + col) * KS + ks * 16 + half * 8;
            };
            tile_k16<EV_MAX_H / 16, 2, true, S>(acc, a, b, mt, 2);
        }
    }
    float* out = partw + (size_t)chunk * e.hp * e.kx;
#pragma unroll
    for (int i = 0; i < EV_MAX_H / 16; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int hh = i * 16 + g + (k >> 1) * 8;
                const int col = c0 + (2 * warp + j) * 8 + 2 * t + (k & 1);
                if (i < mt && hh < e.hp && col < e.kx) out[(size_t)hh * e.kx + col] = acc[i][j][k];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The reduction and the context's gradient.
// ---------------------------------------------------------------------------

// grads: the eight parameters' gradients, flat, in the module's order.
template <typename S>
__global__ void __launch_bounds__(256)
evaluator_grad_reduce_kernel(const float* __restrict__ part, int blocks, EvbRecord rec,
                             const float* __restrict__ partw, int chunks, EvDims e,
                             float* __restrict__ grads, int total) {
    const int f = 64 * e.c2 + 3 + e.d;
    const int nw1 = e.c1 * 18, nw2 = e.c2 * e.c1 * 9, nw0 = e.h * f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
        int j = i, at = -1;
        float s = 0.0f;
        if (j < nw1) {
            at = rec.w1 + j;
        } else if ((j -= nw1) < e.c1) {
            at = rec.b1 + j;
        } else if ((j -= e.c1) < nw2) {
            at = rec.w2 + j;
        } else if ((j -= nw2) < e.c2) {
            at = rec.b2 + j;
        } else if ((j -= e.c2) < nw0) {
            const int hh = j / f, ff = j % f;
            const int col = ff < 64 * e.c2 ? (ff / e.c2) * e.c2p + ff % e.c2 : 64 * e.c2p + ff - 64 * e.c2;
            for (int c = 0; c < chunks; ++c) s += partw[((size_t)c * e.hp + hh) * e.kx + col];
        } else if ((j -= nw0) < e.h) {
            at = rec.b0 + j;
        } else if ((j -= e.h) < e.h) {
            at = rec.wd1 + j;
        } else {
            at = rec.bd1;
        }
        if (at >= 0)
            for (int b = 0; b < blocks; ++b) s += part[(size_t)b * rec.size + at];
        grads[i] = to_f(from_f<S>(s));
    }
}

// dctx [lane][slot][d] = (sum of the slot's tiles' dz0 sums) . W0[:, ctx], rounded.
template <typename S, int T>
__global__ void __launch_bounds__(256)
evaluator_grad_ctx_kernel(const float* __restrict__ stile, const S* __restrict__ lay, EvDims e,
                          S* __restrict__ dctx, int n) {
    constexpr int TPSLOT = 64 / T;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        const int ls = i / e.d, dd = i % e.d;
        float acc = 0.0f;
        for (int hh = 0; hh < e.h; ++hh) {
            float s = 0.0f;
            for (int q = 0; q < TPSLOT; ++q) s += stile[(size_t)(ls * TPSLOT + q) * e.hp + hh];
            acc += s * to_f(lay[e.w0x + dd * e.hp + hh]);
        }
        dctx[i] = from_f<S>(acc);
    }
}

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

// The launch geometry at these widths: K8b's grid (SMs x resident blocks,
// at most the tiles), K8w's tiles a chunk and chunks.
struct EvbPlan {
    int ntiles, blocks, per_chunk, chunks;
};

template <typename S>
static int evb_plan(int b, const EvDims& e, EvbPlan& p) {
    constexpr int T = EvbTile<S>::T;
    static int smem_set[64];
    auto* const kernel = &evaluator_grad_tiles_kernel<S, T>;
    const int smem = evb_smem<S, T>(e).total;
    int err = ev_allow_smem(kernel, smem, smem_set);
    if (err) return err;
    int dev = 0, sms = 1, resident = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, 8 * T, smem);
    p.ntiles = b * (EV_ACTIONS / T);
    p.blocks = sms * (resident > 0 ? resident : 1);
    if (p.blocks > p.ntiles) p.blocks = p.ntiles;
    p.per_chunk = (p.ntiles + EVB_K8W_MAX_CHUNKS - 1) / EVB_K8W_MAX_CHUNKS;
    if (p.per_chunk < 1) p.per_chunk = 1;
    p.chunks = p.ntiles > 0 ? (p.ntiles + p.per_chunk - 1) / p.per_chunk : 0;
    return 0;
}

static const float* const* evb_params(const void* const* p) { return (const float* const*)p; }

// Sizes of the backward's buffers at b lanes: out[0] the weight layout's
// elements (compute type), [1] x0's and [2] dz0's elements (compute type),
// [3] the tiles' dz0 sums, [4] the records, [5] K8w's partials (float32),
// [6] the gradients' floats.  Returns an error beyond the limits.
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
    out[4] = (long long)p.blocks * evb_record(e).size;
    out[5] = (long long)p.chunks * e.hp * e.kx;
    out[6] = evb_grad_total(e);
    return (int)cudaGetLastError();
}

template <typename S>
static int evb_tiles(const void* planes, const void* feats, const void* ctx, const void* ds,
                     const void* const* params, void* layout, void* x0, void* dz0, void* stile,
                     void* part, int b, const EvDims& e, void* stream) {
    constexpr int T = EvbTile<S>::T;
    EvbPlan p;
    const int err = evb_plan<S>(b, e, p);
    if (err) return err;
    ev_launch_layout<S>(evb_params(params), layout, e, e.total, stream);
    const EvbSmem sm = evb_smem<S, T>(e);
    auto* const kernel = &evaluator_grad_tiles_kernel<S, T>;
    BBX_LAUNCH_SMEM(kernel, p.blocks, 8 * T, sm.total, stream,
                    (const S*)planes, (const S*)feats, (const S*)ctx, (const S*)layout,
                    (const S*)ds, (S*)x0, (S*)dz0, (float*)stile, (float*)part, e, sm,
                    evb_record(e), p.ntiles);
    return 0;
}

// K8b: planes [b, 192, 8, 8, 2] (16-byte aligned), feats [b, 192, 3], ctx
// [b, 3, d], ds [b * 192] in the compute type (elem 2: bf16, 4: float32);
// the eight float32 parameters (as bbx_evaluator takes them); scratch:
// layout, x0, dz0 (compute type), stile and the records (float32), sized by
// bbx_evaluator_grad_sizes.
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
    int err = evb_plan<S>(b, e, p);
    if (err) return err;
    static int smem_set[64];
    auto* const kernel = &evaluator_grad_dense0_kernel<S, T>;
    const int smem = (e.hk + EVB_K8W_COLS) * (EVB_K8W_STAGE + 8) * (int)sizeof(S);
    err = ev_allow_smem(kernel, smem, smem_set);
    if (err) return err;
    const int cols = (e.kx + EVB_K8W_COLS - 1) / EVB_K8W_COLS;
    BBX_LAUNCH_SMEM(kernel, cols * p.chunks, 256, smem, stream, (const S*)x0, (const S*)dz0,
                    (float*)partw, e, p.ntiles, p.per_chunk, cols);
    return 0;
}

// K8w: x0 and dz0 as K8b wrote them; partw: the chunks' partials.
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
    const int total = evb_grad_total(e);
    const int grid = total / 256 + 1;
    BBX_LAUNCH(evaluator_grad_reduce_kernel<S>, grid < 2048 ? grid : 2048, 256, stream,
               (const float*)part, p.blocks, evb_record(e), (const float*)partw, p.chunks, e,
               (float*)grads, total);
    const int n = b * 3 * e.d;
    const int cgrid = n / 256 + 1;
    auto* const ctx_kernel = &evaluator_grad_ctx_kernel<S, T>;
    BBX_LAUNCH(ctx_kernel, cgrid < 2048 ? cgrid : 2048, 256, stream,
               (const float*)stile, (const S*)layout, e, (S*)dctx, n);
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
