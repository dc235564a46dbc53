// The bodies of the solvability verdict's two tiers, each shared by a
// standalone kernel and the fused regen kernel K7 (regen.cu):
//   * the disjoint tier, one draw on one warp (`bb_disjoint_rows_load`,
//     `bb_disjoint_warp`): K2 (solvable_disjoint.cu) and K7's disjoint
//     tier;
//   * the exact tier, one item -- an order of the three pieces and a valid
//     anchor a1 of its first piece -- a thread (`bb_exact_item` numbers the
//     items, `bb_exact_search` searches one, `bb_line_anchors` prunes its
//     walk): K3 (solvable_exact.cu, the items of one draw over one warp)
//     and K7's exact tier (the items of the draws its disjoint tier
//     rejects, over a block).
// K1's body, the shift-OR fit `bb_fit`, is in bitboard.cuh; K7 runs it too.
#pragma once
#include "bitboard.cuh"

#define BB_ANCHORS 64
#define BB_FULL_WARP 0xFFFFFFFFu
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

// The pieces (first i, second j, third h) of order o in [0, 6): orders 2i
// and 2i + 1 start with piece i.  Each order has its own ordered pair (j, h).
__host__ __device__ __forceinline__ void bb_exact_order(int o, int* i, int* j, int* h) {
    *i = o / 2;
    *j = (o % 2 == 0) ? (*i == 0 ? 1 : 0) : (*i == 2 ? 1 : 2);
    *h = 3 - *i - *j;
}

// Position of the k-th set bit (k from 0) of m, which has more than k.
__host__ __device__ __forceinline__ int bb_nth_bit(u64 m, int k) {
    int pos = 0;
    for (int w = 32; w >= 1; w >>= 1) {
        const u64 low = m & ((1ULL << w) - 1);
        const int c = BB_POPC(low);
        if (k >= c) {
            k -= c;
            m >>= w;
            pos += w;
        } else {
            m = low;
        }
    }
    return pos;
}

// Item u of a draw's exact tier, given the stage-1 masks v0, v1, v2 of its
// three pieces: 2 |v_i| items (orders 2i and 2i + 1, each over the valid
// anchors a1 of piece i in increasing order) for each first piece i in
// turn, 2 (|v0| + |v1| + |v2|) in all.  Gives the item's order and a1.
// (The masks come by value and are chosen by selects, so that no array is
// indexed at run time: on the card that would put it in local memory.)
__host__ __device__ __forceinline__ void bb_exact_item(int u, u64 v0, u64 v1, u64 v2, int* o,
                                                       int* a1) {
    const int c0 = BB_POPC(v0), c1 = BB_POPC(v1);
    const bool past0 = u >= 2 * c0;
    const bool past1 = u >= 2 * (c0 + c1);
    const int i = past1 ? 2 : (past0 ? 1 : 0);
    const u64 vi = past1 ? v2 : (past0 ? v1 : v0);
    const int c = BB_POPC(vi);
    u -= past1 ? 2 * (c0 + c1) : (past0 ? 2 * c0 : 0);
    const int second = u >= c ? 1 : 0;
    *o = 2 * i + second;
    *a1 = bb_nth_bit(vi, u - second * c);
}

// The most cells a piece puts in one row (w) and in one column (h), from
// its PLACE row at anchor 0 (the top-left corner, in bounds for every
// piece), packed as w | h << 8.
__host__ __device__ __forceinline__ int bb_piece_span(u64 p0) {
    int w = 0, h = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int n = BB_POPC((p0 >> (8 * r)) & 0xFFULL);
        w = n > w ? n : w;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int n = BB_POPC((p0 >> c) & BB_BYTE_LSB);
        h = n > h ? n : h;
    }
    return w | h << 8;
}

// The first set bit of each byte (row) of f that has 1..n set bits: the
// bytes' counts by SWAR, tested against 1 and n through each byte's high
// bit (a count is at most 8, so nothing carries out of its byte).
__host__ __device__ __forceinline__ u64 bb_short_row_firsts(u64 f, int n) {
    u64 x = f - ((f >> 1) & 0x5555555555555555ULL);
    x = (x & 0x3333333333333333ULL) + ((x >> 2) & 0x3333333333333333ULL);
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0FULL;
    const u64 nonzero = (x + 0x7F7F7F7F7F7F7F7FULL) & 0x8080808080808080ULL;
    const u64 over = (x + (0x7FULL - n) * BB_BYTE_LSB) & 0x8080808080808080ULL;
    u64 before = (f << 1) & 0xFEFEFEFEFEFEFEFEULL;  // a set bit lower in the byte
    before |= (before << 2) & 0xFCFCFCFCFCFCFCFCULL;
    before |= (before << 4) & 0xF0F0F0F0F0F0F0F0ULL;
    return f & ~before & (((nonzero & ~over) >> 7) * 0xFFULL);
}

// The anchors (in `aok`) of a piece with shifts `shifts` and span `span`
// (`bb_piece_span`) whose placement on board b might complete a line: the
// anchors that cover the first free cell of a row with 1..w free cells or
// of a column with 1..h free cells.  A placement completes a line only by
// covering all of that line's free cells, the first among them, and a
// line with more free cells than the piece puts in it stays open, so every
// anchor that completes a line is in the result.  The rows are counted a
// byte at a time in one word (SWAR), the columns the same way on the
// board's transpose.
__device__ __forceinline__ u64 bb_line_anchors(u64 b, const int* shifts, u64 aok, int span) {
    const int w = span & 0xFF, h = span >> 8;
    const u64 free = ~b;
    const u64 key = bb_short_row_firsts(free, w) |
                    bb_transpose(bb_short_row_firsts(bb_transpose(free), h));
    return aok & ~bb_fit(key, shifts, aok);
}

// The exact search of one item: the first piece at anchor a1 (its PLACE
// row `place1`) and the lines it completes cleared, giving b1; then the
// anchors a2 of the second piece (shifts `shift2`, anchor mask `aok2`,
// span `span2`, PLACE row `place2`) valid on b1, in increasing order, each
// placed with its lines cleared and tested for room for the third piece
// (`shift3`, `aok3`).  Where the third piece fits nowhere on b1, an a2
// can make room for it only by completing a line, so the walk keeps to
// `bb_line_anchors`: on the lanes searched to the end (the unsolvable
// ones) that removes most of the walk.  Stops at the first hit, or when
// `stop()` turns true before an a2.  Stage 2's and stage 3's masks come
// from the board alone, as in bbx's search; stage 1's from the caller
// (bbx's valid3).  1 iff a hit was found.
template <class Stop>
__device__ __forceinline__ int bb_exact_search(int a1, u64 board, const u64* place1,
                                               const int* shift2, u64 aok2, int span2,
                                               const u64* place2, const int* shift3,
                                               u64 aok3, Stop stop) {
    const u64 b1 = bb_clear_lines(board | place1[a1]);
    u64 f2 = bb_fit(b1, shift2, aok2);
    if (bb_fit(b1, shift3, aok3) == 0) f2 &= bb_line_anchors(b1, shift2, aok2, span2);
    while (f2 && !stop()) {
        const int a2 = BB_LOWEST(f2);
        f2 &= f2 - 1;
        if (bb_fit(bb_clear_lines(b1 | place2[a2]), shift3, aok3)) return 1;
    }
    return 0;
}
