// K9: a uniform draw over each lane's valid actions, [N, 192] bool mask ->
// [N] int32, for the engine path's random policy.
//
// Replaces bbx/env/vector.py: sample_valid_actions_device (:90), a
// categorical over where(mask, 0, -1e9) -- Gumbel-max, which the port's
// plain tensor code ran as 11 launches a step (where, rand, two logs, two
// negations, clamp, add, argmax, a cast).
//
// Bound by bytes: 192 mask bytes in and 4 out a lane (3.2 MB at 16,384
// lanes, 1 us at 3.35 TB/s); at 512 lanes a launch is latency.  A warp
// serves SAMPLE_LANES = 8 lanes, whose 1.5 KB of mask lie in one run: each
// thread reads three 16-byte chunks of it, neighbouring threads on
// neighbouring chunks (512 bytes a warp load, all three in flight
// together, with the seed's), and folds each chunk into 16 bits with
// integer arithmetic (a byte's high bit set where the byte is nonzero, the
// four of a word gathered by one multiply: no branch a byte).  A shuffle
// pairs neighbouring chunks into 32-bit words, which go to shared memory,
// 7 words a lane (odd, so that the lanes' reads of their six words hit
// different banks).  Then a thread takes each lane: the popcounts of its
// six words give its count c of valid actions; the draw is u =
// bbx_mix32(bbx_mix32(seed) ^ lane) (hash.cuh), k = (u * c) >> 32 (a bias
// below 1e-7 at c <= 192), and the lane takes its k-th valid action, found
// in a fixed number of steps: a popcount prefix over the six words picks
// the word, a popcount binary search (16, 8, 4, 2, 1) the bit.  c = 0
// gives action 0, as bbx's categorical does on an all-false row.  Eight
// lanes a warp rather than 32 spread the per-thread chain of loads,
// folds and shuffles over four times the warps (2,048 at 16,384 lanes,
// 64 at 512).  The mask must be 16-byte aligned (the wrapper checks).  The
// plain version (`bbx_torch/env/vector.py:sample_valid_actions_plain`)
// computes the same hash and pick, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitboard.cuh"
#include "hash.cuh"
#include "launch.cuh"

#define SAMPLE_ACTIONS 192
#define SAMPLE_WORDS (SAMPLE_ACTIONS / 32)   // 32-bit words a lane
#define SAMPLE_CHUNKS (SAMPLE_ACTIONS / 16)  // 16-byte chunks a lane
#define SAMPLE_STRIDE (SAMPLE_WORDS + 1)     // shared words a lane
#define SAMPLE_LANES 8                       // lanes a warp (8, 16 or 32)
#define SAMPLE_LOADS (SAMPLE_CHUNKS * SAMPLE_LANES / 32)  // 16-byte loads a thread
#define SAMPLE_WARPS 4                       // warps a block


// mask [n][192] bool (16-byte aligned), seed: one int64, out [n] int32.
__global__ void __launch_bounds__(32 * SAMPLE_WARPS)
sample_kernel(const unsigned char* __restrict__ mask, const long long* __restrict__ seed,
              int* __restrict__ out, int n) {
    __shared__ unsigned s_words[SAMPLE_WARPS][SAMPLE_LANES * SAMPLE_STRIDE];
    const uint32_t key = bbx_mix32((uint32_t)seed[0]);  // in flight with the mask's loads
    const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int first = (blockIdx.x * SAMPLE_WARPS + warp) * SAMPLE_LANES;
    if (first >= n) return;  // a whole warp
    const int chunks = min(SAMPLE_LANES, n - first) * SAMPLE_CHUNKS;
    const uint4* src = (const uint4*)(mask + (size_t)first * SAMPLE_ACTIONS);
    unsigned* words = s_words[warp];
    uint4 v[SAMPLE_LOADS];
#pragma unroll
    for (int i = 0; i < SAMPLE_LOADS; ++i) {
        const int c = 32 * i + l;
        v[i] = c < chunks ? src[c] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < SAMPLE_LOADS; ++i) {
        // Chunk c is bytes 16 (c % 12) of the warp's lane c / 12; c is even
        // where l is, and then chunk c + 1 (thread l + 1's) is the word's
        // high half.
        const int c = 32 * i + l;
        const unsigned half = bb_pack16(v[i]);
        const unsigned high = __shfl_down_sync(0xFFFFFFFFu, half, 1);
        if (!(l & 1)) words[(c / SAMPLE_CHUNKS) * SAMPLE_STRIDE + (c % SAMPLE_CHUNKS) / 2] =
            half | high << 16;
    }
    __syncwarp();
    const int lane = first + l;
    if (l >= SAMPLE_LANES || lane >= n) return;
    unsigned w[SAMPLE_WORDS];
    int count = 0;
#pragma unroll
    for (int j = 0; j < SAMPLE_WORDS; ++j) {
        w[j] = words[l * SAMPLE_STRIDE + j];
        count += __popc(w[j]);
    }
    const uint32_t u = bbx_mix32(key ^ (uint32_t)lane);
    const int k = (int)(((uint64_t)u * (uint32_t)count) >> 32);
    // The word of the k-th set bit: the last j whose prefix count p_j <= k
    // (a later one would have p_j >= p_{j*+1} > k); k becomes its rank there.
    unsigned m = w[0];
    int base = 0, r = k, prefix = 0;
#pragma unroll
    for (int j = 1; j < SAMPLE_WORDS; ++j) {
        prefix += __popc(w[j - 1]);
        const bool here = prefix <= k;
        m = here ? w[j] : m;
        base = here ? 32 * j : base;
        r = here ? k - prefix : r;
    }
    int pos = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int low = __popc(m & ((1u << s) - 1u));
        const bool up = r >= low;
        pos += up ? s : 0;
        r -= up ? low : 0;
        m = up ? m >> s : m;
    }
    out[lane] = count ? base + pos : 0;
}

extern "C" int bbx_sample(const void* mask, const void* seed, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    constexpr int lanes = SAMPLE_LANES * SAMPLE_WARPS;  // a block
    BBX_LAUNCH(sample_kernel, (n + lanes - 1) / lanes, 32 * SAMPLE_WARPS, stream,
               (const unsigned char*)mask, (const long long*)seed, (int*)out, n);
    return (int)cudaGetLastError();
}
