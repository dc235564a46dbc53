// CPU emulation of the CUDA features the port's kernels use, so the CPU
// tests can compile `bbx_torch/csrc/*.cu` as C++ (with -DBBX_EMULATE and
// this directory first on the include path) and hold each kernel against
// its plain PyTorch version.  Each CUDA thread is a std::thread; the blocks
// of a grid run one after another, so no block may wait on another;
// __syncthreads is a std::barrier over the block (a named barrier one over
// the threads that use it), and the warp intrinsics
// (__syncwarp, __ballot_sync, __any_sync, __shfl_down_sync, __shfl_sync) a
// std::barrier over the warp's 32 threads, which must all take part (a
// full mask).  The emulated card
// has BBX_EMULATED_SMS multiprocessors that hold one block each (or as
// many as bbx_emulate_set_resident says), so a kernel that sizes its grid
// by occupancy walks several items a block.
// A block's dynamic shared memory is filled with 0xFF bytes (a NaN in
// float32 and in bf16) before it runs, so that a read of shared memory the
// kernel never wrote shows in its output.  Only what the kernels use is
// here.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

struct bbx_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local bbx_dim3 threadIdx;
inline bbx_dim3 blockIdx, blockDim, gridDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
// Shared memory: one instance per kernel, used by one block at a time.
#define __shared__ static

typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum {
    cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
    cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
inline int cudaGetLastError() { return 0; }
// The H100's dynamic shared memory a block can opt into: a kernel that asks
// for more is refused (cudaErrorInvalidValue), as on the card.
#define BBX_EMULATED_SMEM_OPTIN 232448
template <class F>
inline int cudaFuncSetAttribute(F, int attr, int value) {
    return attr == cudaFuncAttributeMaxDynamicSharedMemorySize && value > BBX_EMULATED_SMEM_OPTIN;
}
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
#define BBX_EMULATED_SMS 3
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = BBX_EMULATED_SMS; return 0; }
// Blocks an emulated SM holds: 1, unless a test sets more through
// bbx_emulate_set_resident (so that an occupancy-sized grid splits its work
// more finely).
inline int bbx_emulated_resident = 1;
extern "C" void bbx_emulate_set_resident(int n) { bbx_emulated_resident = n; }
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
    *n = bbx_emulated_resident;
    return 0;
}

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
    return {x, y, z, w};
}

// bf16 as its bit pattern; float -> bf16 rounds to nearest even, as
// PyTorch's conversion does (a NaN stays a quiet NaN).
struct __nv_bfloat16 { unsigned short bits; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) return {(unsigned short)((u >> 16) | 0x40u)};
    u += 0x7FFFu + ((u >> 16) & 1u);
    return {(unsigned short)(u >> 16)};
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

// Float intrinsics with one rounding per operation (the host compiler runs
// without FMA contraction: -std=c++20 sets -ffp-contract=off).
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

inline std::barrier<>* bbx_block_barrier;
inline std::atomic<int> bbx_block_or{0};

// One warp: its barrier, the word its ballots gather in and the values its
// shuffles exchange.
struct bbx_warp {
    explicit bbx_warp(int size) : barrier(size) {}
    std::barrier<> barrier;
    std::atomic<unsigned> ballot{0};
    unsigned shuffled[32];
};
inline thread_local bbx_warp* bbx_this_warp;

inline void __syncwarp(unsigned = 0xFFFFFFFFu) { bbx_this_warp->barrier.arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
    bbx_warp* w = bbx_this_warp;
    w->barrier.arrive_and_wait();
    if (pred) w->ballot.fetch_or(1u << (threadIdx.x % 32));
    w->barrier.arrive_and_wait();
    const unsigned bits = w->ballot.load();
    w->barrier.arrive_and_wait();
    if (threadIdx.x % 32 == 0) w->ballot = 0;
    return bits;
}

inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }

// Thread l gets thread l + delta's value, or its own where l + delta is
// past the warp's 32 threads.
inline unsigned __shfl_down_sync(unsigned, unsigned v, unsigned delta) {
    bbx_warp* w = bbx_this_warp;
    const unsigned l = threadIdx.x % 32;
    w->shuffled[l] = v;
    w->barrier.arrive_and_wait();
    const unsigned got = l + delta < 32 ? w->shuffled[l + delta] : v;
    w->barrier.arrive_and_wait();
    return got;
}

// Every thread gets thread src's value.
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
    bbx_warp* w = bbx_this_warp;
    w->shuffled[threadIdx.x % 32] = v;
    w->barrier.arrive_and_wait();
    const unsigned got = w->shuffled[src & 31];
    w->barrier.arrive_and_wait();
    return got;
}

template <class T>
inline T __ldg(const T* p) { return *p; }

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

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

// Named barriers (bulk.cuh's bbx_bar_sync / bbx_bar_arrive): the running
// block's barrier of each id, made at its first use with the count given
// (the first thread to publish one wins; no lock after that).
inline std::atomic<std::barrier<>*> bbx_named[16];

inline std::barrier<>& bbx_named_barrier(int id, int n) {
    std::barrier<>* bar = bbx_named[id].load(std::memory_order_acquire);
    if (bar == nullptr) {
        auto* made = new std::barrier<>(n);
        if (bbx_named[id].compare_exchange_strong(bar, made, std::memory_order_acq_rel)) {
            bar = made;
        } else {
            delete made;
        }
    }
    return *bar;
}

inline void bbx_bar_sync(int id, int n) { bbx_named_barrier(id, n).arrive_and_wait(); }
inline void bbx_bar_arrive(int id, int n) { (void)bbx_named_barrier(id, n).arrive(); }

// The running block's dynamic shared memory (`BBX_DYNAMIC_SHARED`).
inline std::vector<unsigned char> bbx_dynamic_smem;
inline unsigned char* bbx_dynamic_shared() { return bbx_dynamic_smem.data(); }

template <class Body>
void bbx_emulate_launch(int grid, int block, Body body, size_t smem = 0) {
    blockDim.x = block;
    gridDim.x = grid;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        bbx_dynamic_smem.assign(smem, 0xFF);
        for (auto& named : bbx_named) delete named.exchange(nullptr);
        std::barrier<> bar(block);
        bbx_block_barrier = &bar;
        std::vector<std::unique_ptr<bbx_warp>> warps;
        for (int w = 0; w < block; w += 32)
            warps.push_back(std::make_unique<bbx_warp>(std::min(32, block - w)));
        std::vector<std::thread> threads;
        threads.reserve(block);
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&body, &warps, t] {
                threadIdx.x = t;
                bbx_this_warp = warps[t / 32].get();
                body();
            });
        for (auto& th : threads) th.join();
    }
}
