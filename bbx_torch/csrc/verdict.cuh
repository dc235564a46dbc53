// The bodies of the solvability verdict's two tiers, each shared by a
// standalone kernel and the fused regen kernel K7 (regen.cu):
//   * the disjoint tier, one draw on one warp (`bb_disjoint_rows_load`,
//     `bb_disjoint_warp`): K2 (solvable_disjoint.cu) and K7's disjoint
//     tier;
//   * the exact search from one first placement (`bb_exact_hit_at`): K3
//     (solvable_exact.cu, through `bb_exact_hit` on a staged triple) and
//     K7's exact tier (through its own item walk).
// K1's body, the shift-OR fit `bb_fit`, is in bitboard.cuh; K7 runs it too.
#pragma once
#include "bitboard.cuh"

#define BB_ANCHORS 64
#define BB_FULL_WARP 0xFFFFFFFFu
#define BB_TRIPLE_THREADS 384  // the exact tier: 6 orders x 64 first anchors

// The geometry of one drawn triple, staged in shared memory by a block.
struct bb_triple {
    u64 place[3][BB_ANCHORS];
    int shift[3][BB_SHIFTS];
    u64 aok[3];
};

// Thread t of a block stages the PLACE rows, the shifts and the anchor
// masks of pieces id[0..2] (threads 0..191 the rows, 0..26 the shifts,
// 0..2 the masks).  The caller synchronises before reading them.
__device__ __forceinline__ void bb_stage_triple(bb_triple* s, int t,
                                                const int* id,
                                                const long long* place,
                                                const int* shifts,
                                                const long long* anchor_ok) {
    if (t < 3 * BB_ANCHORS)
        s->place[t / BB_ANCHORS][t % BB_ANCHORS] =
            (u64)place[id[t / BB_ANCHORS] * BB_ANCHORS + t % BB_ANCHORS];
    if (t < 3 * BB_SHIFTS)
        s->shift[t / BB_SHIFTS][t % BB_SHIFTS] =
            shifts[id[t / BB_SHIFTS] * BB_SHIFTS + t % BB_SHIFTS];
    if (t < 3) s->aok[t] = (u64)anchor_ok[id[t]];
}

// Warp lane l's share of the NO_CONFLICT rows of triple `id` (in [0, 37)):
// words l and l + 32 (first anchors a0 = l, l + 32) of the (0,1) and (0,2)
// rows, and its two words of the (1,2) row, stored into the warp's slice
// `s_nc12` of shared memory (read after a __syncwarp).  One L2 round trip:
// the six loads are independent.
struct bb_disjoint_rows {
    u64 r01[2], r02[2];
};

__device__ __forceinline__ void bb_disjoint_rows_load(const u64* nc, const int* id, int l,
                                                      bb_disjoint_rows* r, u64* s_nc12) {
    const u64* nc01 = nc + (size_t)(id[0] * BB_NUM_PIECES + id[1]) * BB_ANCHORS;
    const u64* nc02 = nc + (size_t)(id[0] * BB_NUM_PIECES + id[2]) * BB_ANCHORS;
    const u64* nc12 = nc + (size_t)(id[1] * BB_NUM_PIECES + id[2]) * BB_ANCHORS;
    r->r01[0] = __ldg(nc01 + l);
    r->r01[1] = __ldg(nc01 + l + 32);
    r->r02[0] = __ldg(nc02 + l);
    r->r02[1] = __ldg(nc02 + l + 32);
    s_nc12[l] = __ldg(nc12 + l);
    s_nc12[l + 32] = __ldg(nc12 + l + 32);
}

// The disjoint tier of one draw on a warp, thread l taking first anchors
// a0 = l and l + 32: whether pairwise-disjoint valid anchors exist, given
// the valid-anchor masks v0, v1, v2 and the rows of `bb_disjoint_rows_load`
// (the (1,2) row in `s_nc12`, visible to the warp).  For a0 valid, some a1
// in NC01[a0] & v1 whose row NC12[a1] meets NC02[a0] & v2, tested row by
// row so that a thread stops at its first compatible pair; the warp votes
// with __any_sync after each half, so a solvable draw whose a0 < 32 skips
// the second.  The same answer in all 32 threads.
__device__ __forceinline__ bool bb_disjoint_warp(u64 v0, u64 v1, u64 v2,
                                                 const bb_disjoint_rows& r, int l,
                                                 const u64* s_nc12) {
    for (int h = 0; h < 2; ++h) {
        int hit = 0;
        if ((v0 >> (l + 32 * h)) & 1ULL) {
            const u64 third = r.r02[h] & v2;
            u64 m01 = third ? r.r01[h] & v1 : 0;
            while (m01 && !hit) {
                hit = (s_nc12[BB_LOWEST(m01)] & third) != 0;
                m01 &= m01 - 1;
            }
        }
        if (__any_sync(BB_FULL_WARP, hit)) return true;
    }
    return false;
}

// The exact search from one first placement: the first piece at anchor
// a1 (its PLACE row `place1`), then every valid anchor a2 of the second
// piece (shifts `shift2`, anchor mask `aok2`, PLACE row `place2`) on the
// cleared board, stopping at the first a2 after which the third piece
// (`shift3`, `aok3`) fits anywhere, or as soon as another thread has set
// *found.  1 iff this thread found a solution.
__device__ __forceinline__ int bb_exact_hit_at(int a1, u64 board,
                                               const u64* place1,
                                               const int* shift2, u64 aok2,
                                               const u64* place2,
                                               const int* shift3, u64 aok3,
                                               volatile int* found) {
    const u64 b1 = bb_clear_lines(board | place1[a1]);
    u64 f2 = bb_fit(b1, shift2, aok2);
    while (f2 && !*found) {
        const int a2 = BB_LOWEST(f2);
        f2 &= f2 - 1;
        const u64 b2 = bb_clear_lines(b1 | place2[a2]);
        if (bb_fit(b2, shift3, aok3)) {
            *found = 1;
            return 1;
        }
    }
    return 0;
}

// The pieces (first, second, third) of order o in [0, 6).
__device__ __forceinline__ void bb_exact_order(int o, int* i, int* j, int* h) {
    *i = o / 2;
    *j = (o % 2 == 0) ? (*i == 0 ? 1 : 0) : (*i == 2 ? 1 : 2);
    *h = 3 - *i - *j;
}

// K3's body for thread t = (order, first anchor a1) of a staged triple,
// given that the first piece of the order is valid at a1.
__device__ __forceinline__ int bb_exact_hit(int t, u64 board,
                                            const bb_triple* s,
                                            volatile int* found) {
    int i, j, h;
    bb_exact_order(t / BB_ANCHORS, &i, &j, &h);
    return bb_exact_hit_at(t % BB_ANCHORS, board, s->place[i], s->shift[j],
                           s->aok[j], s->place[j], s->shift[h], s->aok[h],
                           found);
}

// The first piece of thread t's order in the exact tier.
__device__ __forceinline__ int bb_exact_first(int t) {
    return (t / BB_ANCHORS) / 2;
}
