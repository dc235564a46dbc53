// K7: piece regeneration -- for every lane that has used its three pieces,
// draw triples until one is solvable on the new board (at most 100 draws;
// on exhaustion the 100th draw is kept), all in one launch.
//
// Replaces bbx/engine/state.py: regen_pieces with _verdict_flat, a
// demand-compacted retry loop (cumsum + searchsorted compaction, a main
// round of one draw, tail rounds of 4 and a straggler loop of 8) that XLA
// runs as while-loops, and the port's plain round loop, which synchronises
// with the host every round (`.nonzero()` / `.numel()`).
//
// Design.  About 70% of the lanes need no regen in a step, and a needy
// lane's first draw is accepted most of the time, so the kernel is latency
// work spread thinly over the lanes; its time is that of the slowest lane,
// one that needs 10 or 50 draws, most of them unsolvable.
//   * One block of REGEN_THREADS threads a chunk of 32 lanes: a chunk whose
//     lanes need nothing costs one ballot and a copy, not a block a lane,
//     and the hardware hands the next chunk to whichever SM frees a slot
//     first, so a straggler holds one block while the others run on.
//   * Warp 0 `__ballot_sync`s the chunk's need, copies the ids of the
//     lanes that keep their triple (attempts 0) and stages the boards of
//     the others in shared memory -- no block for a lane without need.
//   * The chunk runs in rounds.  Each round, thread 0 gives every warp one
//     (needy lane, attempt) pair: the next attempt of each open lane in
//     turn, then, while warps are left, further attempts of the same lanes
//     (speculative draws), so a lane that needs 12 draws takes about one
//     round where a warp a lane would take 12.  Since a round settles every
//     attempt it issued, a lane's answer is its lowest accepted attempt, as
//     in the plain version's round loop.
//   * Each warp runs its draw through the disjoint tier alone, with no
//     block barrier: each thread hashes the draw and fits the three pieces
//     itself, takes the first anchors a0 = lane and lane + 32, with their
//     two NO_CONFLICT words and the warp's (1,2) row (in shared memory)
//     loaded in one L2 round trip, and the warp votes with `__any_sync`.
//   * The draws it rejects go through the exact tier together, over all of
//     the block's threads: the valid first placements (order, a1) of every
//     such draw, compacted into one list, in passes of the block width; a
//     draw's items stop as soon as one of them has found a solution (a flag
//     per warp).  One hard draw thus gets the whole block, and several get
//     it side by side.  Each item is K3's body, `bb_exact_search`
//     (verdict.cuh): where the third piece fits nowhere after the first,
//     only the second placements that might complete a line are walked.
//   * PLACE_U64, PIECE_SHIFTS and ANCHOR_OK (20.5 KB) are staged once per
//     block in static shared memory, with each piece's span
//     (`bb_piece_span`); NO_CONFLICT_U64 (700 KB) stays in L2 and is read
//     through the read-only path by the disjoint tier.
// Draw j of lane i is the counter-based hash `regen_draw(seed, lane_base +
// i, j)` that the plain version computes too, so ids and attempts agree bit
// for bit.  `lane_base` is the global index of the fleet's first lane: a
// rank that owns lanes [lane_base, lane_base + n) of a fleet sharded over
// ranks draws what those lanes draw in one process (0 for a whole fleet).
// Bound: the bytes are 45 per lane plus the tables; the work is integer ALU
// work in the exact tier on the draws the disjoint tier rejects.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitboard.cuh"
#include "hash.cuh"
#include "launch.cuh"
#include "verdict.cuh"

#define REGEN_MAX_ATTEMPTS 100
#define REGEN_CHUNK 32
// Block width: 12 warps, so 12 draws are decided side by side in a round
// (of 128, 192, 256 and 384 threads, 384 was the fastest at the engine
// step's inputs; PERF.md).
#define REGEN_THREADS 384

// Piece id of slot s of the draw with attempt key k: the slot's word
// mapped to [0, 37) by (w * 37) >> 32.
__host__ __device__ __forceinline__ int regen_shape(uint32_t k, int s) {
    const uint32_t salt = s == 0 ? 0x9E3779B9U : (s == 1 ? 0x3C6EF372U : 0xDAA66D2BU);
    const uint32_t w = bbx_mix32(k ^ salt);
    return (int)(((uint64_t)w * BB_NUM_PIECES) >> 32);
}

// Item u of a draw's exact tier (numbered by `bb_exact_item`, as K3 numbers
// them), searched by `bb_exact_search`; it stops early once *found is set.
// 1 iff it found a solution (and then sets *found).
__device__ __forceinline__ int regen_exact_item(int u, u64 board, const int* id,
                                                const u64* v, const u64* s_place,
                                                const int* s_shift, const u64* s_aok,
                                                const int* s_span, volatile int* found) {
    int o, a1, i, j, h;
    bb_exact_item(u, v[0], v[1], v[2], &o, &a1);
    bb_exact_order(o, &i, &j, &h);
    if (!bb_exact_search(a1, board, s_place + BB_ANCHORS * id[i], s_shift + BB_SHIFTS * id[j],
                         s_aok[id[j]], s_span[id[j]], s_place + BB_ANCHORS * id[j],
                         s_shift + BB_SHIFTS * id[h], s_aok[id[h]],
                         [found] { return *found != 0; }))
        return 0;
    *found = 1;
    return 1;
}

__global__ void __launch_bounds__(REGEN_THREADS)
regen_kernel(const long long* __restrict__ bits, const int* __restrict__ ids,
             const unsigned char* __restrict__ need,
             const long long* __restrict__ seed,
             const long long* __restrict__ place,
             const int* __restrict__ shifts,
             const long long* __restrict__ anchor_ok,
             const long long* __restrict__ no_conflict,
             int* __restrict__ out_ids, int* __restrict__ attempts, int n,
             int lane_base) {
    constexpr int W = REGEN_THREADS;
    constexpr int NW = W / 32;
    __shared__ u64 s_place[BB_NUM_PIECES * BB_ANCHORS];
    __shared__ int s_shift[BB_NUM_PIECES * BB_SHIFTS];
    __shared__ u64 s_aok[BB_NUM_PIECES];
    __shared__ int s_span[BB_NUM_PIECES];
    // Per warp: its (1,2) row, its (lane, attempt) this round, the draw's
    // ids and masks, the disjoint tier's verdict, the draw's exact-tier
    // items (0 if none) and the exact tier's found flag.
    __shared__ u64 s_nc12[NW][BB_ANCHORS];
    __shared__ int s_lane[NW], s_attempt[NW], s_id[NW][3];
    __shared__ u64 s_valid[NW][3];
    __shared__ int s_ok[NW], s_items[NW], s_found[NW];
    // Per lane of the chunk: its board and its next attempt to issue.
    __shared__ u64 s_board[REGEN_CHUNK];
    __shared__ int s_next[REGEN_CHUNK];
    __shared__ int s_busy;

    const int t = threadIdx.x;
    const int w = t / 32;
    const int l = t % 32;
    for (int i = t; i < BB_NUM_PIECES * BB_ANCHORS; i += W) s_place[i] = (u64)place[i];
    for (int i = t; i < BB_NUM_PIECES * BB_SHIFTS; i += W) s_shift[i] = shifts[i];
    for (int i = t; i < BB_NUM_PIECES; i += W) {
        s_aok[i] = (u64)anchor_ok[i];
        s_span[i] = bb_piece_span((u64)place[i * BB_ANCHORS]);
    }
    const uint32_t seed_key = bbx_mix32((uint32_t)seed[0]);
    const u64* nc = (const u64*)no_conflict;

    const int base = blockIdx.x * REGEN_CHUNK;
    __syncthreads();
    // Warp 0, thread l for the chunk's lane l: copy the ids of a lane
    // that keeps its triple; stage a needy lane's board.
    bool open = false;
    if (w == 0) {
        const int lane = base + l;
        const bool in = lane < n;
        const u64 board = in ? bb_load(bits + 2 * lane) : 0;
        open = in && need[lane] != 0;
        if (open) {
            s_board[l] = board;
            s_next[l] = 0;
        } else if (in) {
            for (int s = 0; s < 3; ++s) out_ids[3 * lane + s] = ids[3 * lane + s];
            attempts[lane] = 0;
        }
        if (l < NW) s_lane[l] = -1;
    }
    __syncwarp();

    for (;;) {
        // Warp 0 settles the last round and hands out this one's
        // (lane, attempt) pairs, thread l for lane l.  Every attempt a
        // round issued is decided by its end, so a lane is done at its
        // lowest accepted attempt, or once all 100 are spent.
        if (w == 0) {
            const int lane = base + l;
            if (open) {
                int best = REGEN_MAX_ATTEMPTS, q_best = -1;
                for (int q = 0; q < NW; ++q)
                    if (s_lane[q] == l && (s_ok[q] || s_found[q]) && s_attempt[q] < best) {
                        best = s_attempt[q];
                        q_best = q;
                    }
                if (q_best >= 0 || s_next[l] == REGEN_MAX_ATTEMPTS) {
                    int id[3];
                    if (q_best >= 0) {
                        for (int s = 0; s < 3; ++s) id[s] = s_id[q_best][s];
                    } else {
                        const uint32_t key =
                            bbx_mix32(bbx_mix32(seed_key ^ (uint32_t)(lane_base + lane)) ^
                                        (uint32_t)(REGEN_MAX_ATTEMPTS - 1));
                        for (int s = 0; s < 3; ++s) id[s] = regen_shape(key, s);
                    }
                    for (int s = 0; s < 3; ++s) out_ids[3 * lane + s] = id[s];
                    attempts[lane] = best + (q_best >= 0 ? 1 : 0);
                    open = false;
                }
            }
            // The open lanes in turn, round robin over the warps: the
            // open lane of rank r takes warps r, r + c, ... (c open
            // lanes), at its next attempts.
            const unsigned mask = __ballot_sync(BB_FULL_WARP, open);
            const int c = BB_POPC((u64)mask);
            __syncwarp();
            if (open) {
                const int r = BB_POPC((u64)(mask & ((1u << l) - 1)));
                int next = s_next[l];
                for (int q = r; q < NW; q += c) {
                    const bool go = next < REGEN_MAX_ATTEMPTS;
                    s_lane[q] = go ? l : -1;
                    s_attempt[q] = next;
                    next += go ? 1 : 0;
                }
                s_next[l] = next;
            } else if (c == 0 && l < NW) {
                s_lane[l] = -1;
            }
            if (l < NW) s_found[l] = 0;
            if (l == 0) s_busy = c;
        }
        __syncthreads();
        if (s_busy == 0) break;

        // The disjoint tier, one draw a warp.
        const int k = s_lane[w];
        if (k >= 0) {
            const int lane = base + k;
            const uint32_t key = bbx_mix32(bbx_mix32(seed_key ^ (uint32_t)(lane_base + lane)) ^
                                             (uint32_t)s_attempt[w]);
            int id[3];
            u64 v[3];
            for (int s = 0; s < 3; ++s) {
                id[s] = regen_shape(key, s);
                v[s] = bb_fit(s_board[k], s_shift + BB_SHIFTS * id[s], s_aok[id[s]]);
            }
            // The disjoint tier (verdict.cuh's body, which K2 runs too).
            bb_disjoint_rows rows;
            bb_disjoint_rows_load(nc, id, l, &rows, s_nc12[w]);
            __syncwarp();
            const bool ok = bb_disjoint_warp(v[0], v[1], v[2], rows, l, s_nc12[w]);
            if (l == 0) {
                s_ok[w] = ok ? 1 : 0;
                s_items[w] = ok ? 0 : 2 * (BB_POPC(v[0]) + BB_POPC(v[1]) + BB_POPC(v[2]));
                for (int s = 0; s < 3; ++s) {
                    s_id[w][s] = id[s];
                    s_valid[w][s] = v[s];
                }
            }
        } else if (l == 0) {
            s_items[w] = 0;
        }
        __syncthreads();

        // The exact tier over the block, for every draw the disjoint
        // tier rejected: their items in passes of W.
        int total = 0;
        for (int q = 0; q < NW; ++q) total += s_items[q];
        if (total) {
            const volatile int* found = s_found;
            for (int u = t; u < total; u += W) {
                int q = 0, off = u;
                while (off >= s_items[q]) off -= s_items[q++];
                if (!found[q])
                    regen_exact_item(off, s_board[s_lane[q]], s_id[q], s_valid[q],
                                     s_place, s_shift, s_aok, s_span, &s_found[q]);
            }
            __syncthreads();
        }
    }
}

extern "C" int bbx_regen(const void* bits, const void* ids, const void* need,
                         const void* seed, const void* place,
                         const void* shifts, const void* anchor_ok,
                         const void* no_conflict, void* out_ids,
                         void* attempts, int n, int lane_base, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    BBX_LAUNCH(regen_kernel, (n + REGEN_CHUNK - 1) / REGEN_CHUNK, REGEN_THREADS,
               stream, (const long long*)bits, (const int*)ids,
               (const unsigned char*)need, (const long long*)seed,
               (const long long*)place, (const int*)shifts,
               (const long long*)anchor_ok, (const long long*)no_conflict,
               (int*)out_ids, (int*)attempts, n, lane_base);
    return (int)cudaGetLastError();
}
