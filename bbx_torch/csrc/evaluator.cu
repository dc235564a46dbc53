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
// input.  A block of 8T threads (T = 32 in bf16, 16 in float32, whose
// activations are twice as wide: at 32 channels and a hidden width of 128
// a float32 tile of 32 needs 232,768 bytes of shared memory, more than the
// H100's 232,448) scores a tile of T afterstates,
// which lies in one (lane, slot) because T divides a slot's 64 anchors, and
// keeps every activation in shared memory.  The tile's planes go into
// [T][10][10][2] with a zero halo.  The block walks the 8 image rows:
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
//     halves of the warps (fewer reads of each activation row) and its
//     B operand read from L2.
// The float32 instantiation runs the same tiling with a scalar product on
// the CUDA cores.  The context's part of dense0 is one [D] . [D, H]
// product a tile, shared by its T afterstates, and the feature columns'
// part 3 multiply-adds an output; both stay float32 until they join the
// main sum.  Each layer rounds to the compute type after its bias and
// ReLU, as the plain version does.  At run9 widths on the H100 it takes
// 0.70 ms at M = 512 x 192: the shared-memory traffic of conv2's operand
// loads bounds it (PERF.md), not the tensor cores.
//
// The weights are laid out on the card at every call by a second, small
// kernel from the module's float32 parameters (never stale; evaluator.cuh,
// which also holds the tile's forward up to dense0, shared with the
// backward in evaluator_backward.cu).
// Limits: C1, C2 <= 32, H <= 128, D <= 256.
#include "evaluator.cuh"

// planes [B*192][8][8][2], feats [B*192][3], ctx [B][3][d], all S; lay the
// weight layout; scores [B*192] S.  One block of 8T threads (T / 4 warps)
// a tile of T afterstates; T divides 64.
template <typename S, int T>
__global__ void __launch_bounds__(8 * T)
evaluator_kernel(const S* __restrict__ planes, const S* __restrict__ feats,
                 const S* __restrict__ ctx, const S* __restrict__ lay,
                 S* __restrict__ scores, EvDims e, EvSmem sm) {
    BBX_DYNAMIC_SHARED(smem);
    const size_t first = (size_t)blockIdx.x * T;  // the tile's first afterstate
    ev_forward_tile<S, T>(planes, feats, ctx, lay, e, sm, smem, first,
                          [](int, const S*, int) {}, [] { __syncthreads(); });
    const float* s_f = (const float*)(smem + sm.f32);
    const float* s_hid = (const float*)(smem + sm.ring);
    float* s_part = (float*)(smem + sm.stage);

    // dense1: 8 threads an afterstate, then one.
    const int tid = threadIdx.x;
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
}

template <typename S, int T>
static int evaluator_launch(const void* planes, const void* feats, const void* ctx,
                            const float* const* params, void* layout, void* scores,
                            int b, const EvDims& e, void* stream) {
    ev_launch_layout<S>(params, layout, e, e.fwd_total, stream);
    const EvSmem sm = ev_smem<S, T>(e);
    auto* const kernel = &evaluator_kernel<S, T>;
    static int smem_set[64];
    const int err = ev_allow_smem(kernel, sm.total, smem_set);
    if (err) return err;
    BBX_LAUNCH_SMEM(kernel, b * (EV_ACTIONS / T), 8 * T, sm.total,
                    stream, (const S*)planes, (const S*)feats, (const S*)ctx,
                    (const S*)layout, (S*)scores, e, sm);
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
    const int err = elem == 2
        ? evaluator_launch<unsigned short, 32>(planes, feats, ctx, params, layout, scores, b, e,
                                           stream)
        : evaluator_launch<float, 16>(planes, feats, ctx, params, layout, scores, b, e, stream);
    return err ? err : (int)cudaGetLastError();
}
