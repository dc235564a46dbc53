// K4: the afterstate expansion -- all 192 post-move boards of a lane, in
// the evaluator's input layout and compute dtype, with the per-move
// features.
//
// Replaces bbx/models/afterstate.py: afterstate_planes, which XLA unrolls
// into 64 static slices of the padded piece planes plus float reductions,
// and the feature concatenation and casts of AfterstateNetwork.__call__.
// The output is one buffer: the planes [B, 192, 8, 8, 2] (NHWC, channel 0
// the post-clear afterboard, channel 1 the placed piece; the evaluator runs
// channels-last), then the features [B, 192, 3] (lines / 4, lines > 0,
// nblocks / 5, each computed in float32 and rounded once to T, as bbx's two
// casts round it), both in T (float or bf16), then the overlap flags
// [B, 192] as bytes.  (bbx's divisions by 4 and 5 are products with the
// float32 reciprocals once XLA compiles them, and so are these.)
//
// Bound by the bytes it writes: 48 KB of bf16 planes a lane (96 KB in
// float32) against 1 KB read.  A persistent grid of 192-thread blocks walks
// the lanes.  For each lane the block packs the board and the three pieces
// into bits with warp ballots, each thread (= action, slot * 64 + row * 8 +
// col) shifts its piece to its anchor, unions, clears full rows and columns
// on one snapshot, and keeps the afterboard and placed words and its three
// features in shared memory (double-buffered, so a lane needs two block
// barriers); the block then writes the lane's contiguous slab with
// coalesced 16-byte stores, each expanding four (bf16) or two (float)
// cells of both channels from the words.  (A slab built in shared memory
// and stored with TMA bulk copies, double-buffered, measured 3-20% slower
// on the H100 at every shape of the paths, PERF.md.)
#include <cuda_runtime.h>
#ifndef BBX_EMULATE
#include <cuda_bf16.h>
#endif

#include "bitboard.cuh"
#include "launch.cuh"

#define AFTER_ACTIONS 192
#define AFTER_FEATS 3

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// 16 bytes of an action's [8, 8, 2] slab from its two words: cells c0 ..
// c0 + 16 / (2 sizeof(T)) - 1, channel 0 then 1 per cell (1.0 is 0x3F80 in
// bf16, 0x3F800000 in float32).
template <typename T>
__device__ __forceinline__ uint4 slab_chunk(u64 after, u64 placed, int c0) {
    unsigned v[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = (unsigned)((after >> (c0 + j)) & 1) * 0x3F80u
                   | (unsigned)((placed >> (c0 + j)) & 1) * 0x3F800000u;
    } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            v[2 * j] = (unsigned)((after >> (c0 + j)) & 1) * 0x3F800000u;
            v[2 * j + 1] = (unsigned)((placed >> (c0 + j)) & 1) * 0x3F800000u;
        }
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(AFTER_ACTIONS)
afterstate_kernel(const float* __restrict__ board, const float* __restrict__ pieces,
                  uint4* __restrict__ planes, uint4* __restrict__ feats,
                  unsigned char* __restrict__ overlap, int b) {
    constexpr int CELLS = 8 / sizeof(T);                  // cells a 16-byte chunk
    constexpr int CHUNKS = AFTER_ACTIONS * 64 / CELLS;    // chunks a lane's planes
    constexpr int FEAT_CHUNKS = AFTER_ACTIONS * AFTER_FEATS * sizeof(T) / 16;
    __shared__ unsigned s_bits[8];  // board, piece 0, 1, 2: low, high word
    __shared__ u64 s_words[2][AFTER_ACTIONS][2];  // afterboard, placed
    __shared__ uint4 s_feats[2][FEAT_CHUNKS];

    const int t = threadIdx.x;
    const int slot = t / 64;
    const int r = (t % 64) / 8;
    const int c = t % 8;
    int buf = 0;
    for (int lane = blockIdx.x; lane < b; lane += gridDim.x, buf ^= 1) {
        // The lane's 256 cells (board, then the three pieces), 32 a ballot.
        const float* bd = board + 64 * (size_t)lane;
        const float* pc = pieces + 192 * (size_t)lane;
        const unsigned lo = __ballot_sync(0xFFFFFFFFu, (t < 64 ? bd[t] : pc[t - 64]) > 0.5f);
        if (t % 32 == 0) s_bits[t / 32] = lo;
        if (t < 64) {
            const unsigned hi = __ballot_sync(0xFFFFFFFFu, pc[128 + t] > 0.5f);
            if (t % 32 == 0) s_bits[6 + t / 32] = hi;
        }
        __syncthreads();

        const u64 bw = (u64)s_bits[0] | ((u64)s_bits[1] << 32);
        const u64 pw = (u64)s_bits[2 + 2 * slot] | ((u64)s_bits[3 + 2 * slot] << 32);
        // Piece cell (pr, pc) lands on (pr + r, pc + c): keep the columns
        // pc < 8 - c, then shift by the anchor; rows pr + r >= 8 fall off
        // the top of the 64-bit word.
        const u64 col_keep = (0xFFULL >> c) * BB_BYTE_LSB;
        const u64 placed = (pw & col_keep) << (8 * r + c);
        const int kept = BB_POPC(placed);
        const bool lost = kept < BB_POPC(pw);
        const bool collide = (placed & bw) != 0;
        const u64 pre = bw | placed;
        const u64 rows = bb_full_rows(pre);
        const u64 cols = bb_full_cols(pre);
        const int lines = BB_POPC(rows) + BB_POPC(cols);
        s_words[buf][t][0] = pre & ~(rows * 0xFFULL | cols * BB_BYTE_LSB);
        s_words[buf][t][1] = placed;
        T* f = (T*)s_feats[buf] + AFTER_FEATS * t;
        f[0] = from_float<T>((float)lines * 0.25f);
        f[1] = from_float<T>(lines > 0 ? 1.0f : 0.0f);
        f[2] = from_float<T>(__fmul_rn((float)kept, 0.2f));
        overlap[(size_t)lane * AFTER_ACTIONS + t] = (collide || lost) ? 1 : 0;
        __syncthreads();

        // The lane's slab, [192 actions][8][8][2] of T, as 16-byte chunks;
        // then its [192][3] features.  The next lane writes the other
        // buffers, so no barrier is needed before it.
        uint4* slab = planes + (size_t)lane * CHUNKS;
        for (int q = t; q < CHUNKS; q += AFTER_ACTIONS) {
            const int a = q / (64 / CELLS);
            slab[q] = slab_chunk<T>(s_words[buf][a][0], s_words[buf][a][1],
                                    (q % (64 / CELLS)) * CELLS);
        }
        if (t < FEAT_CHUNKS) feats[(size_t)lane * FEAT_CHUNKS + t] = s_feats[buf][t];
    }
}

// One block of 192 threads a lane, as many blocks as fit on the card at
// once; each block walks the lanes blockIdx.x, + gridDim.x, ...
template <typename T>
static int afterstate_grid(int b) {
    static int resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 1, per_sm = 1;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, afterstate_kernel<T>,
                                                      AFTER_ACTIONS, 0);
        resident = sms * max(per_sm, 1);
    }
    return min(b, resident);
}

template <typename T>
static void afterstate_launch(const void* board, const void* pieces, void* out, int b,
                              void* stream) {
    unsigned char* base = (unsigned char*)out;
    const size_t plane_bytes = (size_t)b * AFTER_ACTIONS * 128 * sizeof(T);
    const size_t feat_bytes = (size_t)b * AFTER_ACTIONS * AFTER_FEATS * sizeof(T);
    BBX_LAUNCH(afterstate_kernel<T>, afterstate_grid<T>(b), AFTER_ACTIONS, stream,
               (const float*)board, (const float*)pieces, (uint4*)base,
               (uint4*)(base + plane_bytes), base + plane_bytes + feat_bytes, b);
}

// `out`: one buffer of B * 192 * (131 * elem + 1) bytes, 16-byte aligned;
// elem is 2 (bf16) or 4 (float32).
extern "C" int bbx_afterstate(const void* board, const void* pieces, void* out, int b,
                              int elem, void* stream) {
    if (elem != 2 && elem != 4) return (int)cudaErrorInvalidValue;
    if (b > 0) {
        if (elem == 2)
            afterstate_launch<__nv_bfloat16>(board, pieces, out, b, stream);
        else
            afterstate_launch<float>(board, pieces, out, b, stream);
    }
    return (int)cudaGetLastError();
}
