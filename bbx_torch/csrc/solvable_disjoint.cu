// K2: the sufficient solvability tier -- do the three drawn pieces have
// pairwise-disjoint valid anchors?
//
// Replaces bbx/engine/solvability.py: solvable_disjoint_bits, an AND /
// OR-reduce boolean matrix product over NO_CONFLICT_BITS that XLA
// materialises as a [K, 64, 64, 2] plane.  Here one block of 64 threads
// serves one lane, thread a0 = first-piece anchor: it walks the set bits a1
// of nc01[a0] & valid1 and ORs the rows nc12[a1] (64-bit words, the table
// slices stay in L1/L2), then tests t & nc02[a0] & valid2.  The block ORs
// the threads' hits with __syncthreads_or.  Bound by bytes (the 192 bool
// bytes of valid3 and 3 x 512 B table slices per lane) and launch latency.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"
#include "verdict.cuh"

__global__ void disjoint_kernel(const int* __restrict__ ids,
                                const unsigned char* __restrict__ valid3,
                                const long long* __restrict__ no_conflict,
                                unsigned char* __restrict__ out) {
    const int lane = blockIdx.x;
    const int a0 = threadIdx.x;
    const int* id = ids + 3 * lane;
    const unsigned char* v = valid3 + 192 * (size_t)lane;
    int hit = 0;
    if (bb_ids_ok(id) && v[a0]) {
        const u64 *nc01, *nc02, *nc12;
        bb_conflict_rows(no_conflict, id, &nc01, &nc02, &nc12);
        hit = bb_disjoint_hit(a0, bb_pack_bytes(v + 64), bb_pack_bytes(v + 128),
                              nc01, nc02, nc12);
    }
    int any = __syncthreads_or(hit);
    if (a0 == 0) out[lane] = any ? 1 : 0;
}

extern "C" int bbx_solvable_disjoint(const void* ids, const void* valid3,
                                     const void* no_conflict, void* out,
                                     int k, void* stream) {
    if (k > 0)
        BBX_LAUNCH(disjoint_kernel, k, 64, stream, (const int*)ids,
                   (const unsigned char*)valid3,
                   (const long long*)no_conflict, (unsigned char*)out);
    return (int)cudaGetLastError();
}
