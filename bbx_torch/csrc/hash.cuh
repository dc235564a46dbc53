// The counter-based hash of the port's random draws, shared by K7's regen
// draws (regen.cu) and K9's action sampler (sample.cu), and computed alike
// by their plain versions (`bbx_torch/engine/hashing.py:mix32`), so a
// kernel and its plain version draw the same bits.
#pragma once

#include <stdint.h>

// A 32-bit mixing hash (xorshift-multiply, multipliers below 2^31 so that
// the plain version's int64 products stay below 2^63).  A bijection.
__host__ __device__ __forceinline__ uint32_t bbx_mix32(uint32_t x) {
    x ^= x >> 15;
    x *= 0x2C1B3C6DU;
    x ^= x >> 12;
    x *= 0x297A2D39U;
    x ^= x >> 15;
    return x;
}
