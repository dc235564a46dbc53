// Kernel launch used by every exported entry point.
//
// With BBX_EMULATE defined (tests/cuda_emulation/ compiles these sources as
// C++ for the CPU tests) the launch runs the kernel through the emulator's
// bbx_emulate_launch; otherwise it is an ordinary launch on `stream`.
// BBX_LAUNCH_SMEM also gives the kernel `smem` bytes of dynamic shared
// memory, which it names with BBX_DYNAMIC_SHARED.
#pragma once

#ifdef BBX_EMULATE
#define BBX_LAUNCH(kernel, grid, block, stream, ...) \
    bbx_emulate_launch((grid), (block), [&] { kernel(__VA_ARGS__); })
#define BBX_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
    bbx_emulate_launch((grid), (block), [&] { kernel(__VA_ARGS__); }, (smem))
#define BBX_DYNAMIC_SHARED(name) unsigned char* name = bbx_dynamic_shared()
#else
#define BBX_LAUNCH(kernel, grid, block, stream, ...) \
    kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define BBX_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define BBX_DYNAMIC_SHARED(name) extern __shared__ __align__(16) unsigned char name[]
#endif
