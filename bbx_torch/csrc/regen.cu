// K7: piece regeneration -- for every lane that has used its three pieces,
// draw triples until one is solvable on the new board (at most 100 draws;
// on exhaustion the 100th draw is kept), all in one launch.
//
// Replaces bbx/engine/state.py: regen_pieces with _verdict_flat, a
// demand-compacted retry loop (cumsum + searchsorted compaction, a main
// round of one draw, tail rounds of 4 and a straggler loop of 8) that XLA
// runs as while-loops, and the port's plain round loop, which synchronises
// with the host every round (`.nonzero()` / `.numel()`).  Here one block of
// 384 threads serves one lane and loops over attempts j: draw j comes from
// the counter-based hash `regen_draw(seed, lane, j)` (the same function the
// plain version computes); K1's shift-OR fit gives the three valid-anchor
// masks; K2's body (64 threads, one per first anchor) accepts most draws;
// K3's body (6 orders x 64 first anchors, a shared early-exit flag) decides
// the rest; the block stops at its first accepted draw.  Blocks of lanes
// that need no regen copy their ids and return, so the host compacts
// nothing and nothing synchronises.  Bound by integer ALU work in the exact
// tier (a clear and a 9-shift fit per candidate) on the draws the disjoint
// tier rejects; the bytes are 45 per lane plus the tables.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitboard.cuh"
#include "launch.cuh"
#include "verdict.cuh"

#define REGEN_MAX_ATTEMPTS 100

// A 32-bit mixing hash (xorshift-multiply, multipliers below 2^31 so that
// the plain version's int64 products stay below 2^63).  A bijection.
__host__ __device__ __forceinline__ uint32_t regen_mix32(uint32_t x) {
    x ^= x >> 15;
    x *= 0x2C1B3C6DU;
    x ^= x >> 12;
    x *= 0x297A2D39U;
    x ^= x >> 15;
    return x;
}

// Piece id of slot s of the draw with attempt key k: the slot's word
// mapped to [0, 37) by (w * 37) >> 32.
__host__ __device__ __forceinline__ int regen_shape(uint32_t k, int s) {
    const uint32_t salt = s == 0 ? 0x9E3779B9U : (s == 1 ? 0x3C6EF372U : 0xDAA66D2BU);
    const uint32_t w = regen_mix32(k ^ salt);
    return (int)(((uint64_t)w * BB_NUM_PIECES) >> 32);
}

__global__ void regen_kernel(const long long* __restrict__ bits,
                             const int* __restrict__ ids,
                             const unsigned char* __restrict__ need,
                             const long long* __restrict__ seed,
                             const long long* __restrict__ place,
                             const int* __restrict__ shifts,
                             const long long* __restrict__ anchor_ok,
                             const long long* __restrict__ no_conflict,
                             int* __restrict__ out_ids,
                             int* __restrict__ attempts) {
    __shared__ bb_triple s;
    __shared__ int s_id[3];
    __shared__ u64 s_valid[3];
    __shared__ int s_found;

    const int lane = blockIdx.x;
    const int t = threadIdx.x;
    if (!need[lane]) {
        if (t < 3) out_ids[3 * lane + t] = ids[3 * lane + t];
        if (t == 0) attempts[lane] = 0;
        return;
    }
    const u64 board = bb_load(bits + 2 * lane);
    const uint32_t lane_key = regen_mix32(regen_mix32((uint32_t)seed[0]) ^ (uint32_t)lane);
    for (int j = 0; j < REGEN_MAX_ATTEMPTS; ++j) {
        // Draw j; every thread has left the previous attempt's last
        // barrier, after which no thread reads shared memory.
        if (t < 3) s_id[t] = regen_shape(regen_mix32(lane_key ^ (uint32_t)j), t);
        if (t == 0) s_found = 0;
        __syncthreads();
        bb_stage_triple(&s, t, s_id, place, shifts, anchor_ok);
        __syncthreads();
        if (t < 3) s_valid[t] = bb_fit(board, s.shift[t], s.aok[t]);
        __syncthreads();

        // The disjoint tier: thread t < 64 is first anchor a0 = t.
        int hit = 0;
        if (t < BB_ANCHORS && ((s_valid[0] >> t) & 1ULL)) {
            const u64 *nc01, *nc02, *nc12;
            bb_conflict_rows(no_conflict, s_id, &nc01, &nc02, &nc12);
            hit = bb_disjoint_hit(t, s_valid[1], s_valid[2], nc01, nc02, nc12);
        }
        int ok = __syncthreads_or(hit);
        if (!ok) {
            // The exact tier: thread t = (order, first anchor).
            hit = 0;
            if ((s_valid[bb_exact_first(t)] >> (t % BB_ANCHORS)) & 1ULL)
                hit = bb_exact_hit(t, board, &s, &s_found);
            ok = __syncthreads_or(hit);
        }
        if (ok || j == REGEN_MAX_ATTEMPTS - 1) {
            if (t < 3) out_ids[3 * lane + t] = s_id[t];
            if (t == 0) attempts[lane] = j + 1;
            return;
        }
    }
}

extern "C" int bbx_regen(const void* bits, const void* ids, const void* need,
                         const void* seed, const void* place,
                         const void* shifts, const void* anchor_ok,
                         const void* no_conflict, void* out_ids,
                         void* attempts, int n, void* stream) {
    if (n > 0)
        BBX_LAUNCH(regen_kernel, n, BB_TRIPLE_THREADS, stream,
                   (const long long*)bits, (const int*)ids,
                   (const unsigned char*)need, (const long long*)seed,
                   (const long long*)place, (const int*)shifts,
                   (const long long*)anchor_ok,
                   (const long long*)no_conflict, (int*)out_ids,
                   (int*)attempts);
    return (int)cudaGetLastError();
}
