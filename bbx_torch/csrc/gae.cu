// K5: generalised advantage estimation, the reverse scan over a rollout.
//
// Replaces bbx/agent/ppo.py: compute_gae, a lax.scan(reverse=True) over the
// T rows of [T, N] rewards / dones / values that PyTorch would run as
// about 10 launches per row.  The float operations run in bbx's order,
//   delta = (r + (gamma * v') * nonterm) - v
//   A     = delta + ((gamma * lambda) * nonterm) * A'
//   ret   = A + v,
// each one rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc never contracts into an FMA), so the result equals the plain
// PyTorch version bit for bit.  gamma * lambda is formed in double on the
// host and rounded once, as Python does before PyTorch sees it.
//
// Bound by bytes (17 B per element: 4 + 1 + 4 read, 8 written); at T x N =
// 128 x 512 that is 1.1 MB, a third of a microsecond, so the time is
// latency: the launch, the loads, and the chain of T dependent steps of
// each env, which no reassociation may shorten (a parallel scan over time
// would change the bits).  So only the chain is serial.  A block of 512
// threads serves GAE_ENVS = 8 neighbouring envs and walks the rollout in
// chunks of GAE_CHUNK = 128 steps from the end (one chunk at T = 128).
// Each chunk: (1) all threads load the chunk's rows (8 floats of a row
// side by side, 64 rows at once), every load issued before any arithmetic,
// and compute delta_t and c_t = (gamma * lambda) * nonterm_t into shared
// memory, with v' = values[t + 1], or last_value at t = T - 1; (2) one
// thread an env runs A_t = delta_t + c_t * A_{t+1} from shared memory,
// two rounded operations a step, with the operands of the next GAE_BATCH
// steps loaded ahead, carrying A across chunks in a register; (3) all
// threads form ret = A + v (v kept in registers from (1)) and store adv
// and ret.  At N = 512: 64 blocks.
#include <cuda_runtime.h>

#include "launch.cuh"

#define GAE_ENVS 8
#define GAE_THREADS 512
#define GAE_ROWS (GAE_THREADS / GAE_ENVS)             // rows a pass of the block
#define GAE_CHUNK 128                                  // steps a chunk
#define GAE_PER_THREAD (GAE_CHUNK / GAE_ROWS)          // elements a thread a chunk
#define GAE_BATCH 4                                    // chain steps loaded together

// At most 32 registers a thread, so that four blocks fit an SM and
// tpu.yaml's 4,096 envs (512 blocks) run in one wave.
__global__ void __launch_bounds__(GAE_THREADS, 2048 / GAE_THREADS)
gae_kernel(const float* __restrict__ rewards, const unsigned char* __restrict__ dones,
           const float* __restrict__ values, const float* __restrict__ last_value,
           float* __restrict__ adv, float* __restrict__ ret, float gamma,
           float gamma_lambda, int t_len, int n) {
    __shared__ float s_delta[GAE_CHUNK * GAE_ENVS];
    __shared__ float s_c[GAE_CHUNK * GAE_ENVS];
    __shared__ float s_a[GAE_CHUNK * GAE_ENVS];
    const int e = threadIdx.x % GAE_ENVS, row = threadIdx.x / GAE_ENVS;
    const int env = blockIdx.x * GAE_ENVS + e;
    const bool live = env < n;
    float adv_next = 0.0f;  // the chain's carry, in the threads of row 0
    for (int end = t_len; end > 0; end -= GAE_CHUNK) {
        const int start = max(end - GAE_CHUNK, 0);
        // Every load of the chunk first, then the arithmetic: issued in
        // order, a load behind an instruction that waits on an earlier one
        // would wait too.
        float r[GAE_PER_THREAD], v[GAE_PER_THREAD], v_next[GAE_PER_THREAD];
        bool done[GAE_PER_THREAD];
#pragma unroll
        for (int j = 0; j < GAE_PER_THREAD; ++j) {
            const int t = start + row + j * GAE_ROWS;
            r[j] = v[j] = v_next[j] = 0.0f;
            done[j] = false;
            if (live && t < end) {
                const size_t i = (size_t)t * n + env;
                r[j] = rewards[i];
                v[j] = values[i];
                v_next[j] = t + 1 < t_len ? values[i + n] : last_value[env];
                done[j] = dones[i];
            }
        }
#pragma unroll
        for (int j = 0; j < GAE_PER_THREAD; ++j) {
            const int tl = row + j * GAE_ROWS;
            const float nonterm = 1.0f - (done[j] ? 1.0f : 0.0f);
            s_delta[tl * GAE_ENVS + e] = __fsub_rn(
                __fadd_rn(r[j], __fmul_rn(__fmul_rn(gamma, v_next[j]), nonterm)), v[j]);
            s_c[tl * GAE_ENVS + e] = __fmul_rn(gamma_lambda, nonterm);
        }
        __syncthreads();
        if (row == 0 && live) {
            // nvcc keeps a shared load behind a shared store it cannot tell
            // apart from it, which would put a load's latency on every
            // step; so the operands of the next GAE_BATCH steps are loaded
            // before this batch's results are stored (clamped at step 0).
            int tl = end - start - 1;
            float d[GAE_BATCH], c[GAE_BATCH];
#pragma unroll
            for (int q = 0; q < GAE_BATCH; ++q) {
                const int s = max(tl - q, 0) * GAE_ENVS + e;
                d[q] = s_delta[s];
                c[q] = s_c[s];
            }
            for (; tl >= GAE_BATCH - 1; tl -= GAE_BATCH) {
                float d_next[GAE_BATCH], c_next[GAE_BATCH], a[GAE_BATCH];
#pragma unroll
                for (int q = 0; q < GAE_BATCH; ++q) {
                    const int s = max(tl - GAE_BATCH - q, 0) * GAE_ENVS + e;
                    d_next[q] = s_delta[s];
                    c_next[q] = s_c[s];
                }
#pragma unroll
                for (int q = 0; q < GAE_BATCH; ++q) {
                    adv_next = __fadd_rn(d[q], __fmul_rn(c[q], adv_next));
                    a[q] = adv_next;
                }
#pragma unroll
                for (int q = 0; q < GAE_BATCH; ++q) {
                    s_a[(tl - q) * GAE_ENVS + e] = a[q];
                    d[q] = d_next[q];
                    c[q] = c_next[q];
                }
            }
            for (; tl >= 0; --tl) {  // a chunk's last steps short of a batch
                const int s = tl * GAE_ENVS + e;
                adv_next = __fadd_rn(s_delta[s], __fmul_rn(s_c[s], adv_next));
                s_a[s] = adv_next;
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < GAE_PER_THREAD; ++j) {
            const int tl = row + j * GAE_ROWS, t = start + tl;
            if (live && t < end) {
                const size_t i = (size_t)t * n + env;
                const float a = s_a[tl * GAE_ENVS + e];
                adv[i] = a;
                ret[i] = __fadd_rn(a, v[j]);
            }
        }
        __syncthreads();  // the next chunk refills shared memory
    }
}

extern "C" int bbx_gae(const void* rewards, const void* dones,
                       const void* values, const void* last_value, void* adv,
                       void* ret, float gamma, float gamma_lambda, int t_len,
                       int n, void* stream) {
    if (n > 0 && t_len > 0)
        BBX_LAUNCH(gae_kernel, (n + GAE_ENVS - 1) / GAE_ENVS, GAE_THREADS, stream,
                   (const float*)rewards, (const unsigned char*)dones,
                   (const float*)values, (const float*)last_value, (float*)adv,
                   (float*)ret, gamma, gamma_lambda, t_len, n);
    return (int)cudaGetLastError();
}
