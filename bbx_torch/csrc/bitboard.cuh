// 64-bit bitboard helpers shared by the engine kernels.
//
// A board is one unsigned 64-bit word: cell i = row*8 + col is bit i, so
// row r is byte r and column c is bit c of every byte.  The Python side
// keeps bbx's two-word layout ([..., 2] int64 holding u32 values); only the
// kernels combine the words.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#ifdef __CUDA_ARCH__
#define BB_POPC(x) __popcll(x)
#define BB_LOWEST(x) (__ffsll((long long)(x)) - 1)
#else
#define BB_POPC(x) __builtin_popcountll(x)
#define BB_LOWEST(x) __builtin_ctzll(x)
#endif

#define BB_NUM_PIECES 37
#define BB_SHIFTS 9
#define BB_BYTE_LSB 0x0101010101010101ULL

// Two int64 words holding u32 values -> one 64-bit board.
__host__ __device__ __forceinline__ u64 bb_load(const long long* w) {
    return (u64)(uint32_t)w[0] | ((u64)(uint32_t)w[1] << 32);
}

// Bit 8r set iff row r is full.
__host__ __device__ __forceinline__ u64 bb_full_rows(u64 b) {
    u64 x = b & (b >> 1);
    x &= x >> 2;
    x &= x >> 4;
    return x & BB_BYTE_LSB;
}

// Bit c set iff column c is full.
__host__ __device__ __forceinline__ u64 bb_full_cols(u64 b) {
    u64 c = b & (b >> 8);
    c &= c >> 16;
    c &= c >> 32;
    return c & 0xFFULL;
}

// Zero every full row and column, found on the same snapshot.
__host__ __device__ __forceinline__ u64 bb_clear_lines(u64 b) {
    u64 rows = bb_full_rows(b) * 0xFFULL;
    u64 cols = bb_full_cols(b) * BB_BYTE_LSB;
    return b & ~(rows | cols);
}

// The board's transpose: cell (r, c) to (c, r) (three block swaps).
__host__ __device__ __forceinline__ u64 bb_transpose(u64 x) {
    u64 t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAULL;
    x ^= t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCULL;
    x ^= t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ULL;
    return x ^ t ^ (t << 28);
}

// Valid-anchor mask of one piece on board b: anchor a collides iff some
// piece cell a + shift is occupied, so the mask is
// anchor_ok & ~OR_o(b >> shift_o) (shifts <= 36; out-of-bounds anchors read
// row-wrapped bits, which anchor_ok zeroes).
__host__ __device__ __forceinline__ u64 bb_fit(u64 b, const int* shifts,
                                               u64 anchor_ok) {
    u64 m = 0;
#pragma unroll
    for (int o = 0; o < BB_SHIFTS; ++o) m |= b >> shifts[o];
    return anchor_ok & ~m;
}

// 64 bool bytes (0/1) at an 8-byte aligned address -> one bitmask.
__host__ __device__ __forceinline__ u64 bb_pack_bytes(const unsigned char* v) {
    const u64* w = (const u64*)v;
    u64 r = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 x = w[i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            r |= (u64)(((x >> (8 * j)) & 0xFFULL) != 0) << (8 * i + j);
    }
    return r;
}

// Bit i of the result set where byte i of x is nonzero (i < 4), with no
// branch a byte: a byte's high bit is set where the byte is not 0, and one
// multiply gathers the four (bits 0, 8, 16, 24 times 2^28 + 2^21 + 2^14 +
// 2^7 land on 28-31, and no two of the 16 products share a bit, so nothing
// carries).
__host__ __device__ __forceinline__ unsigned bb_pack4(unsigned x) {
    const unsigned high = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
    return ((high >> 7) * 0x10204080u) >> 28;
}

// 16 bytes -> 16 bits, bit i set where byte i is nonzero.
__host__ __device__ __forceinline__ unsigned bb_pack16(uint4 v) {
    return bb_pack4(v.x) | bb_pack4(v.y) << 4 | bb_pack4(v.z) << 8 | bb_pack4(v.w) << 12;
}

// Bits 0..7 of x -> eight bool bytes (byte j = bit j), little-endian.
__host__ __device__ __forceinline__ u64 bb_spread_byte(u64 x) {
    u64 r = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) r |= ((x >> j) & 1ULL) << (8 * j);
    return r;
}

__host__ __device__ __forceinline__ bool bb_ids_ok(const int* id) {
    return id[0] >= 0 && id[0] < BB_NUM_PIECES && id[1] >= 0 &&
           id[1] < BB_NUM_PIECES && id[2] >= 0 && id[2] < BB_NUM_PIECES;
}
