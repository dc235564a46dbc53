// K3: the exact solvability tier -- all 6 placement orders x 64 first
// anchors x 64 second anchors, line clears simulated between placements,
// then "does the third piece fit anywhere".
//
// Replaces bbx/engine/solvability.py: solvable_exact_bits (with
// _clear_lines_words), which XLA evaluates in full as [K, 64, 64] word
// planes for every order.  Here one block of 384 threads serves one lane,
// thread = (order, first anchor a1); it walks only the second anchors that
// are valid on the cleared stage-1 board and stops at the first hit.  A
// shared flag lets every thread of the block stop once any thread has
// found a solution -- the early exit XLA could not express.  Bound by
// integer ALU work (a clear and a 9-shift fit per candidate), not bytes.
// The search itself is `bb_exact_hit_at` of verdict.cuh (through
// `bb_exact_hit`), which the fused regen kernel K7 runs too.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"
#include "verdict.cuh"

__global__ void exact_kernel(const long long* __restrict__ bits,
                             const int* __restrict__ ids,
                             const unsigned char* __restrict__ valid3,
                             const long long* __restrict__ place,
                             const int* __restrict__ shifts,
                             const long long* __restrict__ anchor_ok,
                             unsigned char* __restrict__ out) {
    __shared__ bb_triple s;
    __shared__ int s_found;

    const int lane = blockIdx.x;
    const int t = threadIdx.x;
    const int* id = ids + 3 * lane;
    const bool ids_ok = bb_ids_ok(id);
    if (t == 0) s_found = 0;
    if (ids_ok) bb_stage_triple(&s, t, id, place, shifts, anchor_ok);
    __syncthreads();

    int hit = 0;
    if (ids_ok && valid3[192 * (size_t)lane + 64 * bb_exact_first(t) + t % 64])
        hit = bb_exact_hit(t, bb_load(bits + 2 * lane), &s, &s_found);
    int any = __syncthreads_or(hit);
    if (t == 0) out[lane] = any ? 1 : 0;
}

extern "C" int bbx_solvable_exact(const void* bits, const void* ids,
                                  const void* valid3, const void* place,
                                  const void* shifts, const void* anchor_ok,
                                  void* out, int k, void* stream) {
    if (k > 0)
        BBX_LAUNCH(exact_kernel, k, BB_TRIPLE_THREADS, stream,
                   (const long long*)bits, (const int*)ids,
                   (const unsigned char*)valid3, (const long long*)place,
                   (const int*)shifts, (const long long*)anchor_ok,
                   (unsigned char*)out);
    return (int)cudaGetLastError();
}
