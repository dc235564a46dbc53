// Hopper's bulk asynchronous copy and the shared-memory barriers it
// reports to, as K8w (evaluator_backward.cu) fills its ring of stages,
//
//   bbx_mbar_init(bar, n)          a barrier whose phase completes after n
//                                  arrivals and the bytes it expects (one
//                                  thread, then bbx_mbar_fence_init and a
//                                  block barrier)
//   bbx_mbar_expect_tx(bar, bytes) one arrival that also expects `bytes`
//   bbx_bulk_copy(dst, src, bytes, bar)
//                                  `bytes` (a multiple of 16, both ends
//                                  16-byte aligned) from device memory into
//                                  shared memory, counted off `bar` as they
//                                  land (cp.async.bulk, no tensor map)
//   bbx_mbar_arrive(bar)           one arrival
//   bbx_mbar_wait(bar, parity)     until the phase of that parity completes
//
// and the named block barriers with which K8b's two warp groups hand rows
// to each other:
//
//   bbx_bar_sync(id, n)    wait until n threads (a multiple of 32, this
//                          one included) have reached barrier id (1-15)
//   bbx_bar_arrive(id, n)  count this thread in, and go on
//
// Under BBX_EMULATE the CPU emulation (tests/cuda_emulation/
// bulk_emulation.h) copies at once and keeps each mbarrier's count, bytes
// and phase under a lock, so the same protocol runs on the CPU threads;
// tests/cuda_emulation/cuda_runtime.h has the named barriers.
#pragma once

#ifdef BBX_EMULATE
#include "bulk_emulation.h"
#else
__device__ __forceinline__ unsigned bbx_shared_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bbx_mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bbx_shared_addr(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void bbx_mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bbx_mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     bbx_shared_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bbx_mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bbx_shared_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void bbx_mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "BBX_MBAR_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra BBX_MBAR_WAIT;\n"
        "}\n" ::"r"(bbx_shared_addr(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bbx_bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bbx_bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bbx_bulk_copy(void* dst, const void* src, unsigned bytes,
                                              unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(bbx_shared_addr(dst)),
        "l"(src), "r"(bytes), "r"(bbx_shared_addr(bar))
        : "memory");
}
#endif
