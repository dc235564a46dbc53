// What K8 (evaluator.cu, the evaluator's forward) and its backward
// (evaluator_backward.cu) share: the widths and the weight layout, the
// kernel that lays the weights out, the product of one k16 step, and
// conv1's and conv2's rows, from which K8 and the backward's recompute of
// a tile (bbx's nn.remat) build the same sums in the same order, so that
// the backward's ReLU decisions are K8's.
//
// The weight layout is written on the card at every call, from the
// module's float32 parameters (never stale): cast to the compute type,
// channels padded to multiples of 8, conv2's and dense0's B operands in
// mma's [k16 step][n8 tile][half][column][k] blocks.  The backward appends
// its own operands to it: conv2's weights transposed (taps flipped,
// channels swapped) for the data gradient, and dense0's conv columns
// transposed for the product dz0 . W0[:, flat].
#pragma once

#include <cuda_runtime.h>
#ifndef BBX_EMULATE
#include <cuda_bf16.h>
#endif

#include "launch.cuh"
#include "mma.cuh"

#define EV_ACTIONS 192
#define EV_MAX_C 32
#define EV_MAX_H 128
#define EV_MAX_D 256
#define EV_W1_STRIDE 40  // conv1's A rows: 32 k + 8 (ldmatrix without bank conflicts)
#define EV_SMEM_LIMIT 232448  // shared memory a block can have on the H100

// Widths, padded widths and the weight layout's offsets (elements).
struct EvDims {
    int c1, c2, h, d;
    int c1p, c2p, hp;  // padded to multiples of 8
    int c1m;           // conv1's output channels padded to m16 tiles
    int hk;            // hp padded to k16 steps (the backward's dz0 rows)
    int cg1, cg2;      // c1p / 8, c2p / 8: channel groups
    int ks2, nt2;      // conv2's k16 steps (5 tap pairs x cg1) and n8 tiles
    int nt0;           // dense0's n8 tiles (its k16 steps: 4 c2p)
    int kx;            // dense0's input as the backward stores it: 64 c2p + 3 + d, to 8
    int w1a, b1c, w2, b2, w0, w0f, w0x, b0, w1, b1, fwd_total;
    int w2t, w0t, total;  // the backward's operands
};

static int ev_round16(int n) { return (n + 15) / 16 * 16; }

static EvDims ev_dims(int c1, int c2, int h, int d) {
    EvDims e;
    e.c1 = c1;
    e.c2 = c2;
    e.h = h;
    e.d = d;
    e.c1p = (c1 + 7) / 8 * 8;
    e.c2p = (c2 + 7) / 8 * 8;
    e.hp = (h + 7) / 8 * 8;
    e.c1m = ev_round16(c1);
    e.hk = ev_round16(e.hp);
    e.cg1 = e.c1p / 8;
    e.cg2 = e.c2p / 8;
    e.ks2 = 5 * e.cg1;
    e.nt2 = e.c2p / 8;
    e.nt0 = e.hp / 8;
    e.kx = 64 * e.c2p + (3 + d + 7) / 8 * 8;
    int at = 0;
    e.w1a = at;  // conv1's A: [c1m][EV_W1_STRIDE], k = dy * 8 + dx * 2 + channel
    at += ev_round16(e.c1m * EV_W1_STRIDE);
    e.b1c = at;
    at += ev_round16(e.c1p);
    e.w2 = at;  // conv2's B blocks; step (tap pair p, channel group cg): k = (tap 2p + half, cg * 8 + k8)
    at += e.ks2 * e.nt2 * 128;
    e.b2 = at;
    at += ev_round16(e.c2p);
    e.w0 = at;  // dense0's B blocks, k = (y * 8 + x) * c2p + c
    at += 4 * e.c2p * e.nt0 * 128;
    e.w0f = at;  // [feature 3][hp]
    at += ev_round16(3 * e.hp);
    e.w0x = at;  // [ctx d][hp]
    at += ev_round16(d * e.hp);
    e.b0 = at;
    at += ev_round16(e.hp);
    e.w1 = at;
    at += ev_round16(e.hp);
    e.b1 = at;
    at += 16;
    e.fwd_total = at;
    // conv2 transposed: B blocks of the SAME convolution C2 -> C1 whose
    // weights are W2t[c1][c2][ey][ex] = W2[c2][c1][2 - ey][2 - ex]; step
    // (tap pair p, group cg of c2), n = c1.
    e.w2t = at;
    at += 5 * e.cg2 * e.cg1 * 128;
    // dense0's conv columns transposed, image row by image row: B blocks
    // [row 8][k16 step over h][n8 tile over (x, c2)], k = h, n = x c2p + c.
    e.w0t = at;
    at += 8 * (e.hk / 16) * e.c2p * 128;
    e.total = at;
    return e;
}

static bool ev_widths_ok(int c1, int c2, int h, int d) {
    return c1 >= 1 && c2 >= 1 && h >= 1 && d >= 1 && c1 <= EV_MAX_C && c2 <= EV_MAX_C
        && h <= EV_MAX_H && d <= EV_MAX_D;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(unsigned short x) {
    return __uint_as_float((unsigned)x << 16);
}

template <typename S>
__device__ __forceinline__ S from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ unsigned short from_f<unsigned short>(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// ReLU then the compute type's rounding (a NaN stays a NaN, as in torch).
// A float64 sum passed in rounds once, to float32, on the way.
template <typename S>
__device__ __forceinline__ S relu_to(float x) { return from_f<S>(x < 0.0f ? 0.0f : x); }

// The accumulator of the forward's sums: float32 for bf16 (the tensor
// cores' accumulator), float64 for float32, so that each float32
// activation is its exact sum rounded once (the CUDA cores' float32
// path; a float32 sum's own rounding can flip a ReLU whose exact
// pre-activation lies within it of 0).
template <typename S>
struct EvAccT { using type = float; };
template <>
struct EvAccT<float> { using type = double; };

// p[0] = x, p[1] = y; one 4-byte store in bf16 (p 4-byte aligned).
template <typename S>
__device__ __forceinline__ void store2(S* p, S x, S y) {
    if constexpr (sizeof(S) == 2) {
        *(unsigned*)p = (unsigned)x | (unsigned)y << 16;
    } else {
        p[0] = x;
        p[1] = y;
    }
}

// One k16 step of a warp's tile: `bbx_mma_k16` (mma.cuh; DEF: its skipped
// fragments set to 0) in bf16; in float32 the same contract as a scalar sum
// over k on the CUDA cores, into float32 or float64 accumulators (A).
template <int MT, int NT, bool B_LDM, typename S, bool DEF = false, typename A, class AF,
          class BF>
__device__ __forceinline__ void tile_k16(A (&c)[MT][NT][4], const AF& a, const BF& b,
                                         int mt, int nt) {
    if constexpr (sizeof(S) == 2) {
        bbx_mma_k16<MT, NT, B_LDM, DEF>(c, a, b, mt, nt);
    } else {
        const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (i < mt && j < nt) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float* lo = a(i, g, h);
                        const float* hi = a(i, g + 8, h);
                        const float* b0 = b(j, h, 2 * t);
                        const float* b1 = b(j, h, 2 * t + 1);
#pragma unroll
                        for (int k = 0; k < 8; ++k) {
                            c[i][j][0] += (A)lo[k] * b0[k];
                            c[i][j][1] += (A)lo[k] * b1[k];
                            c[i][j][2] += (A)hi[k] * b0[k];
                            c[i][j][3] += (A)hi[k] * b1[k];
                        }
                    }
                }
            }
        }
    }
}

template <typename A, int MT, int NT>
__device__ __forceinline__ void zero(A (&c)[MT][NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) c[i][j][k] = 0;
}

// ---------------------------------------------------------------------------
// The weight layout.
// ---------------------------------------------------------------------------

// Element (step, kk, n) of a B operand stored as [k16 step][n8 tile][half]
// [column 8][k 8] blocks, for the block element index j (nt tiles a step).
__device__ __forceinline__ void b_block_at(int j, int nt, int& step, int& kk, int& n) {
    const int blk = j >> 7, el = j & 127;
    step = blk / nt;
    kk = (el >> 6) * 8 + (el & 7);
    n = (blk % nt) * 8 + ((el >> 3) & 7);
}

// Elements [0, count) of the layout: e.fwd_total for the forward, e.total
// with the backward's operands.
template <typename S>
__global__ void __launch_bounds__(256)
evaluator_layout_kernel(const float* __restrict__ wc1, const float* __restrict__ bc1,
                        const float* __restrict__ wc2, const float* __restrict__ bc2,
                        const float* __restrict__ wd0, const float* __restrict__ bd0,
                        const float* __restrict__ wd1, const float* __restrict__ bd1,
                        S* __restrict__ out, EvDims e, int count) {
    const int flat = 64 * e.c2;    // dense0's conv columns
    const int f = flat + 3 + e.d;  // dense0's input width
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
         i += gridDim.x * blockDim.x) {
        float v = 0.0f;
        int step, kk, n;
        if (i >= e.w0t) {
            b_block_at(i - e.w0t, e.c2p, step, kk, n);
            const int r = step / (e.hk / 16), hh = (step % (e.hk / 16)) * 16 + kk;
            const int x = n / e.c2p, c = n % e.c2p;
            if (hh < e.h && c < e.c2) v = wd0[(size_t)hh * f + (r * 8 + x) * e.c2 + c];
        } else if (i >= e.w2t) {
            b_block_at(i - e.w2t, e.cg1, step, kk, n);
            const int tap = 2 * (step / e.cg2) + kk / 8, c = (step % e.cg2) * 8 + kk % 8;
            if (tap < 9 && c < e.c2 && n < e.c1) v = wc2[(c * e.c1 + n) * 9 + 8 - tap];
        } else if (i >= e.b1) {
            if (i == e.b1) v = bd1[0];
        } else if (i >= e.w1) {
            const int j = i - e.w1;
            if (j < e.h) v = wd1[j];
        } else if (i >= e.b0) {
            const int j = i - e.b0;
            if (j < e.h) v = bd0[j];
        } else if (i >= e.w0x) {
            const int j = i - e.w0x, dd = j / e.hp, hh = j % e.hp;
            if (dd < e.d && hh < e.h) v = wd0[(size_t)hh * f + flat + 3 + dd];
        } else if (i >= e.w0f) {
            const int j = i - e.w0f, ff = j / e.hp, hh = j % e.hp;
            if (ff < 3 && hh < e.h) v = wd0[(size_t)hh * f + flat + ff];
        } else if (i >= e.w0) {
            b_block_at(i - e.w0, e.nt0, step, kk, n);
            const int k = step * 16 + kk, p = k / e.c2p, c = k % e.c2p;
            if (c < e.c2 && n < e.h) v = wd0[(size_t)n * f + p * e.c2 + c];
        } else if (i >= e.b2) {
            const int j = i - e.b2;
            if (j < e.c2) v = bc2[j];
        } else if (i >= e.w2) {
            b_block_at(i - e.w2, e.nt2, step, kk, n);
            const int tap = 2 * (step / e.cg1) + kk / 8, c = (step % e.cg1) * 8 + kk % 8;
            if (tap < 9 && c < e.c1 && n < e.c2) v = wc2[(n * e.c1 + c) * 9 + tap];
        } else if (i >= e.b1c) {
            const int j = i - e.b1c;
            if (j < e.c1) v = bc1[j];
        } else {
            const int j = i - e.w1a, c = j / EV_W1_STRIDE, k = j % EV_W1_STRIDE;
            const int dy = k / 8, dx = (k % 8) / 2, ch = k % 2;
            if (c < e.c1 && dy < 3 && dx < 3) v = wc1[(c * 2 + ch) * 9 + dy * 3 + dx];
        }
        out[i] = from_f<S>(v);
    }
}

template <typename S>
static void ev_launch_layout(const float* const* params, void* layout, const EvDims& e,
                             int count, void* stream) {
    const int grid = count / 256 + 1;
    BBX_LAUNCH(evaluator_layout_kernel<S>, grid < 1024 ? grid : 1024, 256, stream,
               params[0], params[1], params[2], params[3], params[4], params[5],
               params[6], params[7], (S*)layout, e, count);
}

// Raise a kernel's dynamic shared memory limit above 48 KB, once a device.
template <class K>
static int ev_allow_smem(K* kernel, int smem, int (&set)[64]) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (smem > 48 * 1024 && smem > set[dev % 64]) {
        const int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err) {
            // Cleared from the runtime's record: the caller reports it, and
            // this library's next call must not report it again.
            cudaGetLastError();
            return err;
        }
        set[dev % 64] = smem;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// The forward of one tile.
// ---------------------------------------------------------------------------

// Byte offsets of the forward's regions of dynamic shared memory, each
// 16-aligned; K8 (evaluator.cu) and the backward (evaluator_backward.cu)
// place them inside their own.
struct EvSmem {
    int in, zero, w1a, w2, f32, ring, stage, total;
    // K8's own (0 in the backward's): the next tile's planes and features
    // as they land, the mbarriers they and W0's slices report to, and
    // dense0's B blocks of w0n image rows (w0b bytes each).
    int raw = 0, bars = 0, w0s = 0, w0b = 0, w0n = 0;
    // float32 arrays inside f32, in floats
    int b1c, b2, b0, w1, w0f, ctx, feats;
};

// Bytes of the regions (their sizes, before placement).
template <typename S, int T>
struct EvSizes {
    int in, w1a, w2, f32, ring, stage;
};

template <typename S, int T>
static EvSizes<S, T> ev_sizes(const EvDims& e, EvSmem& f) {
    const int es = (int)sizeof(S);
    const int acc = (int)sizeof(typename EvAccT<S>::type);
    EvSizes<S, T> z;
    z.in = (T * 200 + 16) * es;  // [T][10][10][2] with a zero halo
    z.w1a = e.c1m * EV_W1_STRIDE * es;
    z.w2 = e.ks2 * e.nt2 * 128 * es;
    int n = 0;
    f.b1c = n;
    n += e.c1p;
    f.b2 = n;
    n += e.c2p;
    f.b0 = n;
    n += e.hp;
    f.w1 = n;
    n += e.hp;
    f.w0f = n;
    n += 3 * e.hp;
    n = (n + 1) / 2 * 2;  // 8-aligned for a float64 context part
    f.ctx = n;
    n += e.hp * acc / 4;
    f.feats = n;
    n += 3 * T;
    z.f32 = n * 4;
    // conv1's ring of three rows [3][T][10][c1p] (columns 0 and 9 zero);
    // after the rows, dense0's partial sums [T][hp + 1] in the accumulator
    // type, then its output [T][hp + 1] float32.
    const int ring = 3 * T * 10 * e.c1p * es;
    const int hid = T * (e.hp + 1) * acc;
    z.ring = ring > hid ? ring : hid;
    // conv2's output row [T][8 c2p + 8] (+8: ldmatrix without bank
    // conflicts); after the rows, dense1's partial sums [T][8] float32.
    const int stage = T * (8 * e.c2p + 8) * es;
    z.stage = stage > 8 * T * 4 ? stage : 8 * T * 4;
    return z;
}

// 16-aligned bump allocation of shared memory.
struct EvTake {
    int at = 0;
    int operator()(int bytes) {
        const int here = at;
        at += (bytes + 15) / 16 * 16;
        return here;
    }
};

// conv1 for image row y, transposed: out^T [channel][pixel] = W1 [c1m x
// 32] . patches [32 x 8T]; k = dy * 8 + dx * 2 + channel, whose 8 values
// for one dy are the contiguous padded pixels (y + dy, x .. x + 3) (the
// fourth's pair meets zero weights).  Warp `warp`'s n-tiles are afterstates
// 4 warp .. + 3 (8 columns each), its m-tiles the c1m / 16 channel blocks.
// `put(ch, x, a, v)` stores relu(sum + bias) rounded, for ch < c1p.  DEF:
// tile_k16's.
template <typename S, int T, bool DEF = false, class Put>
__device__ __forceinline__ void ev_conv1_row(const S* s_in, const S* s_w1a, const S* s_zero,
                                             const float* bias, const EvDims& e, int y,
                                             const Put& put) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    typename EvAccT<S>::type c[2][4][4];
    zero(c);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        auto a = [&](int i, int row, int half) -> const S* {
            return s_w1a + (i * 16 + row) * EV_W1_STRIDE + s * 16 + half * 8;
        };
        auto b = [&](int j, int half, int col) -> const S* {
            const int dy = 2 * s + half;
            return dy < 3 ? s_in + ((4 * warp + j) * 10 + y + dy) * 20 + col * 2 : s_zero;
        };
        tile_k16<2, 4, false, S, DEF>(c, a, b, e.c1m / 16, 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int ch = i * 16 + g + (k >> 1) * 8, x = 2 * t + (k & 1);
            if (i < e.c1m / 16 && ch < e.c1p) {
                const float bb = bias[ch];
#pragma unroll
                for (int j = 0; j < 4; ++j) put(ch, x, 4 * warp + j, relu_to<S>(c[i][j][k] + bb));
            }
        }
    }
}

// A 3x3 SAME convolution's output row r as an implicit GEMM (rows: T
// afterstates x 8 columns; each k16 step two taps of one 8-channel group,
// whose addresses come from a table of the row's taps): A by ldmatrix from
// `ring` ([3][T][10][cinp], input row yy in slot yy % 3, columns 0 and 9
// zero), B (the weights, `nt` n8 tiles a step) by ldmatrix from shared
// memory.  Warp `warp`'s m-tile i is afterstates 2 (warp + W i) (rows
// 0-7: columns 0-7) and that + 1 (rows 8-15).  With Q_UNROLLED the loop
// over channel groups is unrolled 4 times (K8: 5% faster on an H100;
// the backward's kernel, at its register limit, 2% slower: PERF.md).
// DEF: tile_k16's.
template <typename S, int T, typename A, bool Q_UNROLLED = false, bool DEF = false>
__device__ __forceinline__ void ev_conv3_row(A (&c)[2][4][4], const S* ring, int cinp,
                                             int cg, const S* w, int nt, const S* s_zero,
                                             int r) {
    constexpr int W = T / 4;
    const int warp = threadIdx.x >> 5;
    // tap_at[tap]: the ring offset of the input row of `tap` (dy, dx), -1
    // where it lies outside the image (and for the padding tap 9).
    int tap_at[10];
#pragma unroll
    for (int tap = 0; tap < 10; ++tap) {
        const int yy = r + tap / 3 - 1;
        tap_at[tap] = tap < 9 && yy >= 0 && yy < 8 ? ((yy % 3) * T * 10 + tap % 3) * cinp : -1;
    }
    zero(c);
#pragma unroll
    for (int p = 0; p < 5; ++p) {
        if constexpr (Q_UNROLLED) {
#pragma unroll 4
            for (int q = 0; q < cg; ++q) {
                auto a = [&](int i, int row, int half) -> const S* {
                    const int at = half ? tap_at[2 * p + 1] : tap_at[2 * p];
                    if (at < 0) return s_zero;
                    const int as = 2 * (warp + W * i) + (row >> 3);
                    return ring + at + (as * 10 + (row & 7)) * cinp + q * 8;
                };
                auto b = [&](int j, int half, int col) -> const S* {
                    return w + ((p * cg + q) * nt + j) * 128 + half * 64 + col * 8;
                };
                tile_k16<2, 4, true, S, DEF>(c, a, b, 2, nt);
            }
        } else {
            for (int q = 0; q < cg; ++q) {
                auto a = [&](int i, int row, int half) -> const S* {
                    const int at = half ? tap_at[2 * p + 1] : tap_at[2 * p];
                    if (at < 0) return s_zero;
                    const int as = 2 * (warp + W * i) + (row >> 3);
                    return ring + at + (as * 10 + (row & 7)) * cinp + q * 8;
                };
                auto b = [&](int j, int half, int col) -> const S* {
                    return w + ((p * cg + q) * nt + j) * 128 + half * 64 + col * 8;
                };
                tile_k16<2, 4, true, S, DEF>(c, a, b, 2, nt);
            }
        }
    }
}
