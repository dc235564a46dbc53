// K5: generalised advantage estimation, the reverse scan over a rollout.
//
// Replaces bbx/agent/ppo.py: compute_gae, a lax.scan(reverse=True) over the
// T rows of [T, N] rewards / dones / values that PyTorch would run as
// about 10 launches per row.  Here one thread serves one env and walks
// t = T-1 ... 0 with A' and v' in registers; each step reads one element of
// a row, so a warp reads 32 neighbouring elements (coalesced).  The float
// operations run in bbx's order,
//   delta = (r + (gamma * v') * nonterm) - v
//   A     = delta + ((gamma * lambda) * nonterm) * A'
//   ret   = A + v,
// each one rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc never contracts into an FMA), so the result equals the plain
// PyTorch version bit for bit.  gamma * lambda is formed in double on the
// host and rounded once, as Python does before PyTorch sees it.  Bound by
// bytes (17 B per element: 4 + 1 + 4 read, 8 written); at T x N = 128 x
// 512 that is 1.1 MB, well under a microsecond, so launch latency and the
// T dependent steps of each thread set the time.
#include <cuda_runtime.h>

#include "launch.cuh"

#define GAE_THREADS 128

__global__ void gae_kernel(const float* __restrict__ rewards,
                           const unsigned char* __restrict__ dones,
                           const float* __restrict__ values,
                           const float* __restrict__ last_value,
                           float* __restrict__ adv, float* __restrict__ ret,
                           float gamma, float gamma_lambda, int t_len,
                           int n) {
    const int env = blockIdx.x * blockDim.x + threadIdx.x;
    if (env >= n) return;
    float adv_next = 0.0f;
    float v_next = last_value[env];
    for (int t = t_len - 1; t >= 0; --t) {
        const size_t i = (size_t)t * n + env;
        const float v = values[i];
        const float nonterm = 1.0f - (dones[i] ? 1.0f : 0.0f);
        const float delta = __fsub_rn(
            __fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, v_next), nonterm)), v);
        const float a = __fadd_rn(
            delta, __fmul_rn(__fmul_rn(gamma_lambda, nonterm), adv_next));
        adv[i] = a;
        ret[i] = __fadd_rn(a, v);
        adv_next = a;
        v_next = v;
    }
}

extern "C" int bbx_gae(const void* rewards, const void* dones,
                       const void* values, const void* last_value, void* adv,
                       void* ret, float gamma, float gamma_lambda, int t_len,
                       int n, void* stream) {
    if (n > 0 && t_len > 0)
        BBX_LAUNCH(gae_kernel, (n + GAE_THREADS - 1) / GAE_THREADS,
                   GAE_THREADS, stream, (const float*)rewards,
                   (const unsigned char*)dones, (const float*)values,
                   (const float*)last_value, (float*)adv, (float*)ret, gamma,
                   gamma_lambda, t_len, n);
    return (int)cudaGetLastError();
}
