// K3: the exact solvability tier -- can the three drawn pieces be placed
// in some order, with line clears simulated between placements?  All 6
// orders x every valid first anchor a1 x every valid second anchor a2, then
// "does the third piece fit anywhere".
//
// Replaces bbx/engine/solvability.py: solvable_exact_bits (with
// _clear_lines_words), which XLA evaluates in full as [K, 64, 64] word
// planes for every order.
//
// Bound by the latency of the longest search: the unsolvable lanes are
// searched to the end, and a lane's candidates are a chain of dependent
// integer steps (the bytes are 221 a lane; at the parity engine's one lane,
// the launch).  A warp serves one lane, EXACT_WARPS lanes a block, with no
// block barrier:
//   * the lane's ids, its board and its 192 valid3 bytes load together,
//     the bytes as twelve 16-byte chunks folded by `bb_pack16` (as in K2);
//     then the warp stages the three pieces' PLACE rows in its slice of
//     shared memory (1.7 KB), 16 bytes a load through the read-only path,
//     with their shifts, anchor masks and spans; only a __syncwarp follows;
//   * the items -- (order, a1) with a1 valid for the order's first piece,
//     2 (|v0| + |v1| + |v2|) of them, numbered by `bb_exact_item` as K7
//     numbers them -- go round the warp, thread l taking items l, l + 32,
//     ...; each is searched by `bb_exact_search` (verdict.cuh, K7's exact
//     tier too), which, where the third piece fits nowhere after the
//     first, walks only the a2 that might complete a line;
//   * after each round of 32 items the warp votes with __any_sync, so a
//     solvable lane stops at the round of its first hit.
// valid3 must be 16-byte aligned (the wrapper checks).  Ids outside
// [0, 37) give false.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"
#include "verdict.cuh"

#define EXACT_WARPS 4  // lanes (warps) a block: of 4, 8, 16 and 32, the fastest (PERF.md)
#define EXACT_CHUNKS (3 * BB_ANCHORS / 16)  // 16-byte chunks of a lane's masks

// One warp's rows in shared memory: the PLACE rows of pieces 0..2 and
// their anchor masks, shifts and spans (`bb_piece_span`).
struct alignas(16) exact_rows {
    u64 place[3][BB_ANCHORS];
    u64 aok[3];
    int shift[3][BB_SHIFTS];
    int span[3];
};

// Warp thread l copies its share of the rows of triple `id` (in [0, 37)):
// 16 bytes a load, pair l of each PLACE row (a row is 32 pairs).
__device__ __forceinline__ void exact_stage(exact_rows* s, const int* id, int l,
                                            const long long* place, const int* shifts,
                                            const long long* anchor_ok) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
        ((uint4*)s->place[r])[l] = __ldg((const uint4*)(place + (size_t)id[r] * BB_ANCHORS) + l);
    if (l < 3 * BB_SHIFTS)
        s->shift[l / BB_SHIFTS][l % BB_SHIFTS] = __ldg(shifts + id[l / BB_SHIFTS] * BB_SHIFTS +
                                                       l % BB_SHIFTS);
    if (l < 3) {
        s->aok[l] = (u64)__ldg(anchor_ok + id[l]);
        s->span[l] = bb_piece_span((u64)__ldg(place + (size_t)id[l] * BB_ANCHORS));
    }
}

// bits [k][2] int64, ids [k][3] int32, valid3 [k][3][64] bool (16-byte
// aligned), out [k] bool.
__global__ void __launch_bounds__(32 * EXACT_WARPS)
exact_kernel(const long long* __restrict__ bits, const int* __restrict__ ids,
             const unsigned char* __restrict__ valid3, const long long* __restrict__ place,
             const int* __restrict__ shifts, const long long* __restrict__ anchor_ok,
             unsigned char* __restrict__ out, int k) {
    __shared__ exact_rows s_rows[EXACT_WARPS];
    const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int lane = blockIdx.x * EXACT_WARPS + w;
    if (lane >= k) return;  // a whole warp
    exact_rows* s = &s_rows[w];
    int id[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) id[q] = ids[3 * lane + q];
    const u64 board = bb_load(bits + 2 * lane);
    const uint4* src = (const uint4*)(valid3 + (size_t)lane * 3 * BB_ANCHORS);
    const uint4 v = l < EXACT_CHUNKS ? src[l] : make_uint4(0, 0, 0, 0);
    const bool ok = bb_ids_ok(id);  // the same in the whole warp
    if (ok) exact_stage(s, id, l, place, shifts, anchor_ok);
    // Chunk l holds anchors 16 (l % 4) .. + 15 of slot l / 4 (as in K2).
    const unsigned half = bb_pack16(v);
    const unsigned word = half | __shfl_down_sync(BB_FULL_WARP, half, 1) << 16;
    u64 m[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
        m[q] = (u64)__shfl_sync(BB_FULL_WARP, word, 4 * q) |
               (u64)__shfl_sync(BB_FULL_WARP, word, 4 * q + 2) << 32;
    __syncwarp();
    const int items = ok ? 2 * (BB_POPC(m[0]) + BB_POPC(m[1]) + BB_POPC(m[2])) : 0;
    bool found = false;
    for (int base = 0; base < items && !found; base += 32) {
        int hit = 0;
        if (base + l < items) {
            int o, a1, i, j, h;
            bb_exact_item(base + l, m[0], m[1], m[2], &o, &a1);
            bb_exact_order(o, &i, &j, &h);
            hit = bb_exact_search(a1, board, s->place[i], s->shift[j], s->aok[j], s->span[j],
                                  s->place[j], s->shift[h], s->aok[h], [] { return false; });
        }
        found = __any_sync(BB_FULL_WARP, hit);
    }
    if (l == 0) out[lane] = found ? 1 : 0;
}

extern "C" int bbx_solvable_exact(const void* bits, const void* ids, const void* valid3,
                                  const void* place, const void* shifts,
                                  const void* anchor_ok, void* out, int k, void* stream) {
    if (k > 0)
        BBX_LAUNCH(exact_kernel, (k + EXACT_WARPS - 1) / EXACT_WARPS, 32 * EXACT_WARPS, stream,
                   (const long long*)bits, (const int*)ids, (const unsigned char*)valid3,
                   (const long long*)place, (const int*)shifts, (const long long*)anchor_ok,
                   (unsigned char*)out, k);
    return (int)cudaGetLastError();
}
