// CPU emulation of the CUDA features the port's kernels use, so the CPU
// tests can compile `bbx_torch/csrc/*.cu` as C++ (with -DBBX_EMULATE and
// this directory first on the include path) and hold each kernel against
// its plain PyTorch version.  Each CUDA thread is a std::thread; the blocks
// of a grid run one after another; __syncthreads is a std::barrier.  Only
// what the kernels use is here: no warp intrinsics, no atomics.
#pragma once
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>

struct bbx_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local bbx_dim3 threadIdx;
inline bbx_dim3 blockIdx, blockDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
// Shared memory: one instance per kernel, used by one block at a time.
#define __shared__ static

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

// Float intrinsics with one rounding per operation (the host compiler runs
// without FMA contraction: -std=c++20 sets -ffp-contract=off).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

inline std::barrier<>* bbx_block_barrier;
inline std::atomic<int> bbx_block_or{0};

inline void __syncthreads() { bbx_block_barrier->arrive_and_wait(); }

inline int __syncthreads_or(int pred) {
    __syncthreads();
    if (pred) bbx_block_or.fetch_or(1);
    __syncthreads();
    int any = bbx_block_or.load();
    __syncthreads();
    if (threadIdx.x == 0) bbx_block_or = 0;
    return any;
}

template <class Body>
void bbx_emulate_launch(int grid, int block, Body body) {
    blockDim.x = block;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        std::barrier<> bar(block);
        bbx_block_barrier = &bar;
        std::vector<std::thread> threads;
        threads.reserve(block);
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&body, t] { threadIdx.x = t; body(); });
        for (auto& th : threads) th.join();
    }
}
