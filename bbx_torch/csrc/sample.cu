// K9: a uniform draw over each lane's valid actions, [N, 192] bool mask ->
// [N] int32, for the engine path's random policy.
//
// Replaces bbx/env/vector.py: sample_valid_actions_device (:90), a
// categorical over where(mask, 0, -1e9) -- Gumbel-max, which the port's
// plain tensor code ran as 11 launches a step (where, rand, two logs, two
// negations, clamp, add, argmax, a cast).
//
// Bound by bytes: 192 mask bytes in and 4 out a lane (3.2 MB at 16,384
// lanes, 1 us at 3.35 TB/s); a launch is latency.  One warp a lane: six
// ballots over the mask's 192 bytes give its 6 words, their popcounts the
// count c of valid actions.  The draw is u = bbx_mix32(bbx_mix32(seed) ^
// lane) (hash.cuh), k = (u * c) >> 32 (a bias below 1e-7 at c <= 192), and
// the lane takes its k-th valid action; c = 0 gives action 0, as bbx's
// categorical does on an all-false row.  The plain version
// (`bbx_torch/env/vector.py:sample_valid_actions_plain`) computes the same
// hash and pick, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"
#include "launch.cuh"

#define SAMPLE_ACTIONS 192
#define SAMPLE_WARPS 8  // lanes a block

// mask [n][192] bool, seed: one int64, out [n] int32.
__global__ void __launch_bounds__(32 * SAMPLE_WARPS)
sample_kernel(const unsigned char* __restrict__ mask, const long long* __restrict__ seed,
              int* __restrict__ out, int n) {
    const int l = threadIdx.x & 31;
    const int lane = blockIdx.x * SAMPLE_WARPS + (threadIdx.x >> 5);
    if (lane >= n) return;  // a whole warp: n is the same for its 32 threads
    const unsigned char* row = mask + (size_t)lane * SAMPLE_ACTIONS;
    unsigned words[SAMPLE_ACTIONS / 32];
    int count = 0;
#pragma unroll
    for (int w = 0; w < SAMPLE_ACTIONS / 32; ++w) {
        words[w] = __ballot_sync(0xFFFFFFFFu, row[w * 32 + l] != 0);
        count += __popc(words[w]);
    }
    if (l != 0) return;
    const uint32_t u = bbx_mix32(bbx_mix32((uint32_t)seed[0]) ^ (uint32_t)lane);
    int k = (int)(((uint64_t)u * (uint32_t)count) >> 32);
    int action = 0;
    if (count > 0) {
        for (int w = 0; w < SAMPLE_ACTIONS / 32; ++w) {
            const int c = __popc(words[w]);
            if (k < c) {
                unsigned m = words[w];
                for (int i = 0; i < k; ++i) m &= m - 1;  // drop the k lowest set bits
                action = w * 32 + __ffs(m) - 1;
                break;
            }
            k -= c;
        }
    }
    out[lane] = action;
}

extern "C" int bbx_sample(const void* mask, const void* seed, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    BBX_LAUNCH(sample_kernel, (n + SAMPLE_WARPS - 1) / SAMPLE_WARPS, 32 * SAMPLE_WARPS, stream,
               (const unsigned char*)mask, (const long long*)seed, (int*)out, n);
    return (int)cudaGetLastError();
}
