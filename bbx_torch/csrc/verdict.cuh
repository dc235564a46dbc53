// The bodies of the solvability verdict, shared by the standalone kernels
// K2 (solvable_disjoint.cu) and K3 (solvable_exact.cu) and by the fused
// regen kernel K7 (regen.cu), so the three run the same code.  K1's body,
// the shift-OR fit `bb_fit`, is in bitboard.cuh.
#pragma once
#include "bitboard.cuh"

#define BB_ANCHORS 64
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

// K2's body for first anchor a0: given that piece 0 is valid at a0, walk
// the set bits a1 of nc01[a0] & v1 (piece 1 valid and disjoint from piece 0
// at a0), OR the rows nc12[a1], and test the result against nc02[a0] & v2.
// 1 iff pairwise-disjoint valid anchors (a0, a1, a2) exist.
__device__ __forceinline__ int bb_disjoint_hit(int a0, u64 v1, u64 v2,
                                               const u64* nc01,
                                               const u64* nc02,
                                               const u64* nc12) {
    u64 m01 = nc01[a0] & v1;
    u64 t = 0;
    while (m01) {
        t |= nc12[BB_LOWEST(m01)];
        m01 &= m01 - 1;
    }
    return (t & nc02[a0] & v2) != 0;
}

// The NO_CONFLICT rows of the pairs (0,1), (0,2), (1,2) of a triple.
__device__ __forceinline__ void bb_conflict_rows(const long long* no_conflict,
                                                 const int* id,
                                                 const u64** nc01,
                                                 const u64** nc02,
                                                 const u64** nc12) {
    const u64* nc = (const u64*)no_conflict;
    *nc01 = nc + (size_t)(id[0] * BB_NUM_PIECES + id[1]) * BB_ANCHORS;
    *nc02 = nc + (size_t)(id[0] * BB_NUM_PIECES + id[2]) * BB_ANCHORS;
    *nc12 = nc + (size_t)(id[1] * BB_NUM_PIECES + id[2]) * BB_ANCHORS;
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
