// K1: valid-anchor masks of the three drawn pieces, from bitboards.
//
// Replaces bbx/engine/solvability.py: piece_fit_words / valid3_bits (the
// shift-OR dilation, with _shr64 carrying shifts across the two u32 words).
// On Hopper the board is one native u64, so each shift is one instruction.
//
// Bound by bytes (16 B board + 12 B ids read, 192 B of bools written a
// lane: 1.1 us at 16,384 lanes) and, at the eval and parity widths (1 to a
// few thousand lanes), by launch latency: what counts there is the chain
// of dependent steps a thread runs.  The design keeps that chain to one
// round of global loads, a few operations and one store:
//   * A thread writes one 16-byte chunk of the output: chunk c holds
//     anchors 16 (c % 4) .. 16 (c % 4) + 15 of (lane, slot) c / 4, so a
//     warp's stores cover 512 contiguous bytes, and the work spreads over
//     12 threads a lane (48 blocks at 512 lanes).
//   * The block stages PIECE_SHIFTS (37 x 9 int32) and ANCHOR_OK (37 u64)
//     in shared memory with the same round of loads that fetches its
//     threads' boards and ids, so the piece's shifts, whose address
//     depends on its id, come from shared memory and not from a second
//     global round trip.
//   * Each of the four threads of a (lane, slot) computes the <= 9
//     shift-ORs of the fit itself (cheaper than passing it on), and turns
//     its 16 bits into 16 bool bytes four at a time: one multiply spreads
//     a nibble into four bytes.
// An id outside [0, 37) gives an all-false row.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"

#define VALID3_THREADS 128
#define VALID3_TABLE_SHIFTS (BB_NUM_PIECES * BB_SHIFTS)

// Bits 0..3 of x -> four bool bytes (byte j = bit j): bit j times 2^(7j)
// lands on bit 8j, and no two of the 16 products share a bit.
__device__ __forceinline__ unsigned valid3_spread4(unsigned x) {
    return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// bits [k][2] int64 (u32 words), ids [k][3] int32, out [k][3][64] bool
// (16-byte aligned): n = 12 k chunks of 16 bytes.
__global__ void __launch_bounds__(VALID3_THREADS)
valid3_kernel(const long long* __restrict__ bits, const int* __restrict__ ids,
              const int* __restrict__ shifts, const long long* __restrict__ anchor_ok,
              uint4* __restrict__ out, int n) {
    __shared__ int s_shift[VALID3_TABLE_SHIFTS];
    __shared__ u64 s_aok[BB_NUM_PIECES];
    const int t = threadIdx.x;
    const int c = blockIdx.x * VALID3_THREADS + t;
    const u64 b = c < n ? bb_load(bits + 2 * (c / 12)) : 0;
    const int p = c < n ? ids[c / 4] : -1;
#pragma unroll
    for (int j = 0; j < (VALID3_TABLE_SHIFTS + VALID3_THREADS - 1) / VALID3_THREADS; ++j) {
        const int i = t + j * VALID3_THREADS;
        if (i < VALID3_TABLE_SHIFTS) s_shift[i] = shifts[i];
    }
    if (t < BB_NUM_PIECES) s_aok[t] = (u64)anchor_ok[t];
    __syncthreads();
    if (c >= n) return;
    u64 f = 0;
    if (p >= 0 && p < BB_NUM_PIECES) f = bb_fit(b, s_shift + BB_SHIFTS * p, s_aok[p]);
    const unsigned h = (unsigned)(f >> (16 * (c % 4)));
    out[c] = make_uint4(valid3_spread4(h), valid3_spread4(h >> 4), valid3_spread4(h >> 8),
                        valid3_spread4(h >> 12));
}

extern "C" int bbx_valid3(const void* bits, const void* ids,
                          const void* shifts, const void* anchor_ok,
                          void* out, int k, void* stream) {
    const int n = 12 * k;
    if (n > 0)
        BBX_LAUNCH(valid3_kernel, (n + VALID3_THREADS - 1) / VALID3_THREADS, VALID3_THREADS,
                   stream, (const long long*)bits, (const int*)ids, (const int*)shifts,
                   (const long long*)anchor_ok, (uint4*)out, n);
    return (int)cudaGetLastError();
}
