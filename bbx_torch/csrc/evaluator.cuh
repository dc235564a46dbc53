// What K8 (evaluator.cu, the evaluator's forward) and its backward
// (evaluator_backward.cu) share: the widths and the weight layout, the
// kernel that lays the weights out, the product of one k16 step, and the
// forward of one tile of afterstates -- planes into shared memory, conv1
// and conv2 row by row, dense0 accumulated across the rows -- which K8
// finishes with dense1 and the backward recomputes (bbx's nn.remat).
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

// One k16 step of a warp's tile: `bbx_mma_k16` (mma.cuh) in bf16; in
// float32 the same contract as a scalar sum over k on the CUDA cores, into
// float32 or float64 accumulators (A).
template <int MT, int NT, bool B_LDM, typename S, typename A, class AF, class BF>
__device__ __forceinline__ void tile_k16(A (&c)[MT][NT][4], const AF& a, const BF& b,
                                         int mt, int nt) {
    if constexpr (sizeof(S) == 2) {
        bbx_mma_k16<MT, NT, B_LDM>(c, a, b, mt, nt);
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
// 16-aligned; the backward places them inside its own (evaluator_backward.cu).
struct EvSmem {
    int in, zero, w1a, w2, f32, ring, stage, total;
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

template <typename S, int T>
static EvSmem ev_smem(const EvDims& e) {
    EvSmem s;
    const EvSizes<S, T> z = ev_sizes<S, T>(e, s);
    EvTake take;
    s.in = take(z.in);
    s.zero = take(32 * (int)sizeof(S));  // a row of zeros for A or B
    s.w1a = take(z.w1a);
    s.w2 = take(z.w2);
    s.f32 = take(z.f32);
    s.ring = take(z.ring);
    s.stage = take(z.stage);
    s.total = take.at;
    return s;
}

// conv1 for image row y, transposed: out^T [channel][pixel] = W1 [c1m x
// 32] . patches [32 x 8T]; k = dy * 8 + dx * 2 + channel, whose 8 values
// for one dy are the contiguous padded pixels (y + dy, x .. x + 3) (the
// fourth's pair meets zero weights).  Warp `warp`'s n-tiles are afterstates
// 4 warp .. + 3 (8 columns each), its m-tiles the c1m / 16 channel blocks.
// `put(ch, x, a, v)` stores relu(sum + bias) rounded, for ch < c1p.
template <typename S, int T, class Put>
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
        tile_k16<2, 4, false, S>(c, a, b, e.c1m / 16, 4);
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
// 0-7: columns 0-7) and that + 1 (rows 8-15).
template <typename S, int T, typename A>
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
            tile_k16<2, 4, true, S>(c, a, b, 2, nt);
        }
    }
}

// The forward of the tile of T afterstates from `first` (one lane and
// slot), up to dense0's output: leaves h = relu(dense0) rounded, as float,
// in [T][hp + 1] at sm.ring, and the tile's features (float) at
// s_f + sm.feats.  Its 8T threads, the block's first, call it and meet at
// `sync()`, a barrier over exactly them.  After conv2's row r is in the
// stage ([T][8 c2p + 8]) and they have synchronised,
// `on_row(r, stage, sstr)` runs on every thread (the backward stores the
// row there; K8 passes a no-op).
template <typename S, int T, class OnRow, class Sync>
__device__ __forceinline__ void ev_forward_tile(const S* __restrict__ planes,
                                                const S* __restrict__ feats,
                                                const S* __restrict__ ctx,
                                                const S* __restrict__ lay, const EvDims& e,
                                                const EvSmem& sm, unsigned char* smem,
                                                size_t first, const OnRow& on_row,
                                                const Sync& sync) {
    constexpr int NTH = 8 * T, W = T / 4;
    using Acc = typename EvAccT<S>::type;
    S* s_in = (S*)(smem + sm.in);
    S* s_zero = (S*)(smem + sm.zero);
    S* s_w1a = (S*)(smem + sm.w1a);
    S* s_w2 = (S*)(smem + sm.w2);
    float* s_f = (float*)(smem + sm.f32);
    Acc* s_ctx = (Acc*)(s_f + sm.ctx);
    S* s_ring = (S*)(smem + sm.ring);
    Acc* s_odd = (Acc*)(smem + sm.ring);
    float* s_hid = (float*)(smem + sm.ring);
    S* s_stage = (S*)(smem + sm.stage);

    const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int lane = (int)(first / EV_ACTIONS);
    const int slot = (int)(first % EV_ACTIONS) / 64;
    const int c1p = e.c1p, sstr = 8 * e.c2p + 8;

    // The tile's planes into [T][10][10][2] with a zero halo: thread (a, y)
    // copies image row y of afterstate a.
    {
        const int a = tid >> 3, y = tid & 7;
        const uint4* src = (const uint4*)(planes + (first + a) * 128 + y * 16);
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
    if (tid < 32) {
        s_zero[tid] = 0;
        if (tid < 16) s_in[T * 200 + tid] = 0;
    }
    // The ring's zero columns.
    for (int i = tid; i < 3 * T * 2 * c1p; i += NTH) {
        const int row = i / (2 * c1p), side = (i / c1p) & 1;
        s_ring[(row * 10 + side * 9) * c1p + i % c1p] = 0;
    }
    // Weights: conv1's A and conv2's B blocks (16 bytes a thread a pass),
    // biases, dense0's feature rows and dense1 as float32; the features.
    {
        const uint4* src = (const uint4*)(lay + e.w1a);
        uint4* dst = (uint4*)s_w1a;
        for (int i = tid; i < e.c1m * EV_W1_STRIDE * (int)sizeof(S) / 16; i += NTH)
            dst[i] = src[i];
        src = (const uint4*)(lay + e.w2);
        dst = (uint4*)s_w2;
        for (int i = tid; i < e.ks2 * e.nt2 * 128 * (int)sizeof(S) / 16; i += NTH)
            dst[i] = src[i];
    }
    for (int i = tid; i < c1p; i += NTH) s_f[sm.b1c + i] = to_f(lay[e.b1c + i]);
    for (int i = tid; i < e.c2p; i += NTH) s_f[sm.b2 + i] = to_f(lay[e.b2 + i]);
    for (int i = tid; i < e.hp; i += NTH) {
        s_f[sm.b0 + i] = to_f(lay[e.b0 + i]);
        s_f[sm.w1 + i] = to_f(lay[e.w1 + i]);
    }
    for (int i = tid; i < 3 * e.hp; i += NTH) s_f[sm.w0f + i] = to_f(lay[e.w0f + i]);
    for (int i = tid; i < 3 * T; i += NTH) s_f[sm.feats + i] = to_f(feats[first * 3 + i]);
    // The context's part of dense0, one [d] . [d, hp] product for the
    // tile's (lane, slot), in the accumulator type.
    for (int hh = tid; hh < e.hp; hh += NTH) {
        const S* crow = ctx + ((size_t)lane * 3 + slot) * e.d;
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
    sync();

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
        ev_conv3_row<S, T>(c, s_ring, c1p, e.cg1, s_w2, e.nt2, s_zero, r);
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
        on_row(r, (const S*)s_stage, sstr);

        // dense0 over row r's k-slice (8 c2p columns of the flatten order),
        // then conv1 for row r + 2 into the ring row conv2 just finished.
#pragma unroll 2
        for (int s = kq; s < e.c2p / 2; s += 2) {
            const size_t ks = (size_t)r * (e.c2p / 2) + s;
            auto a = [&](int i, int row, int half) -> const S* {
                return s_stage + (i * 16 + row) * sstr + s * 16 + half * 8;
            };
            auto b = [&](int j, int half, int col) -> const S* {
                return lay + e.w0 + (ks * e.nt0 + n0 + (W / 2) * j) * 128 + half * 64 + col * 8;
            };
            tile_k16<T / 16, NT0, false, S>(acc, a, b, T / 16, nt0w);
        }
        if (r + 2 < 8) conv1_row(r + 2);
        sync();
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
