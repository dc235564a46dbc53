// K2: the sufficient solvability tier -- do the three drawn pieces have
// pairwise-disjoint valid anchors?
//
// Replaces bbx/engine/solvability.py: solvable_disjoint_bits, an AND /
// OR-reduce boolean matrix product over NO_CONFLICT_BITS that XLA
// materialises as a [K, 64, 64, 2] plane.
//
// Bound by bytes (the 192 bool bytes of valid3 and 12 bytes of ids a lane,
// the 700 KB table, which stays in L2) and, at the parity engine's one
// lane, by launch latency.  A warp serves one lane, DISJOINT_WARPS lanes a
// block, with no block barrier:
//   * the lane's ids and its 192 mask bytes are loaded together, the masks
//     as twelve coalesced 16-byte chunks (threads 0..11), each folded into
//     16 bits branch-free (a byte's high bit where it is not 0, gathered by
//     one multiply, as in K9); a shuffle pairs the halves into 32-bit words
//     and six more give every thread the three 64-bit masks;
//   * the three NO_CONFLICT rows follow in one L2 round trip, then the
//     tier's body `bb_disjoint_warp` (verdict.cuh), which K7 runs on its
//     draws: thread l takes first anchors l and l + 32, walks the valid
//     second anchors a1 row by row against the (1,2) row in shared memory,
//     stops at its first compatible pair, and the warp votes with
//     __any_sync.
// valid3 must be 16-byte aligned (the wrapper checks).  Ids outside
// [0, 37) give false.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"
#include "verdict.cuh"

#define DISJOINT_WARPS 16                     // lanes (warps) a block
#define DISJOINT_CHUNKS (3 * BB_ANCHORS / 16)  // 16-byte chunks of a lane's masks

// ids [k][3] int32, valid3 [k][3][64] bool (16-byte aligned), out [k] bool.
__global__ void __launch_bounds__(32 * DISJOINT_WARPS)
disjoint_kernel(const int* __restrict__ ids, const unsigned char* __restrict__ valid3,
                const long long* __restrict__ no_conflict, unsigned char* __restrict__ out,
                int k) {
    __shared__ u64 s_nc12[DISJOINT_WARPS][BB_ANCHORS];
    const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int lane = blockIdx.x * DISJOINT_WARPS + w;
    if (lane >= k) return;  // a whole warp
    int id[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) id[s] = ids[3 * lane + s];
    const uint4* src = (const uint4*)(valid3 + (size_t)lane * 3 * BB_ANCHORS);
    const uint4 v = l < DISJOINT_CHUNKS ? src[l] : make_uint4(0, 0, 0, 0);
    const bool ok = bb_ids_ok(id);  // the same in the whole warp
    bb_disjoint_rows rows;
    if (ok) bb_disjoint_rows_load((const u64*)no_conflict, id, l, &rows, s_nc12[w]);
    // Chunk l holds anchors 16 (l % 4) .. + 15 of slot l / 4; the word at
    // even l, anchors 32 (l / 2 % 2) .. + 31 of that slot.
    const unsigned half = bb_pack16(v);
    const unsigned word = half | __shfl_down_sync(BB_FULL_WARP, half, 1) << 16;
    u64 m[3];
#pragma unroll
    for (int s = 0; s < 3; ++s)
        m[s] = (u64)__shfl_sync(BB_FULL_WARP, word, 4 * s) |
               (u64)__shfl_sync(BB_FULL_WARP, word, 4 * s + 2) << 32;
    __syncwarp();
    const bool hit = ok && bb_disjoint_warp(m[0], m[1], m[2], rows, l, s_nc12[w]);
    if (l == 0) out[lane] = hit ? 1 : 0;
}

extern "C" int bbx_solvable_disjoint(const void* ids, const void* valid3,
                                     const void* no_conflict, void* out,
                                     int k, void* stream) {
    if (k > 0)
        BBX_LAUNCH(disjoint_kernel, (k + DISJOINT_WARPS - 1) / DISJOINT_WARPS,
                   32 * DISJOINT_WARPS, stream, (const int*)ids,
                   (const unsigned char*)valid3, (const long long*)no_conflict,
                   (unsigned char*)out, k);
    return (int)cudaGetLastError();
}
