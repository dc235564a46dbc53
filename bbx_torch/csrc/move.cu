// K6: the per-lane move core of the game step -- decode the action, test
// its validity, place, clear full rows and columns, update the streak and
// score -- plus the statistics of the new board that the shaped reward
// reads (holes, centre openness, filled cells).
//
// Replaces bbx/engine/step.py: _move_core (with count_holes,
// center_openness and total_blocks of bbx/engine/kernel.py applied to its
// new board), which XLA runs as a fusion of gathers over PLACEMENT and
// [N, 8, 8] reductions and PyTorch as about 30 launches.  Here one thread
// serves one lane: the uint8 board is packed into one u64 (eight 8-byte
// loads), the move is a handful of 64-bit ops on PLACE_U64 and
// ANCHOR_OK_U64, and holes / centre / fill are shifts, masks and popcounts
// of the new board.  Every output is written in the same pass: the board
// back as uint8 (eight 8-byte stores) and the [N] results as rows of one
// int32 block and one bool block, so neighbouring threads store to
// neighbouring addresses.  Bound by bytes (about 80 B read and 130 B
// written per lane); at N = 512-4096 lanes, launch latency sets the time.
#include <cuda_runtime.h>

#include "bitboard.cuh"
#include "launch.cuh"

#define MOVE_THREADS 128
#define MOVE_CENTER16 0x00003C3C3C3C0000ULL  // rows 2-5 x columns 2-5
#define MOVE_COL0 BB_BYTE_LSB
#define MOVE_COL7 (BB_BYTE_LSB << 7)

// Rows of the int32 output block [MOVE_INTS, n]; the order is the one
// `bbx_torch/engine/step.py` unpacks.
enum {
    MV_PIECE, MV_NBLOCKS, MV_LINES, MV_ROWS, MV_COLS, MV_STREAK, MV_COMBO,
    MV_SCORE, MV_HOLES, MV_FILL, MOVE_INTS
};
// Rows of the bool output block [MOVE_FLAGS, n].
enum { MV_VALID, MV_CLEARED, MOVE_FLAGS };

// Empty cells whose four orthogonal neighbours are filled or off the board.
__host__ __device__ __forceinline__ int bb_holes(u64 b) {
    const u64 up = (b << 8) | 0xFFULL;              // row 0: off the board
    const u64 down = (b >> 8) | (0xFFULL << 56);    // row 7: off the board
    const u64 left = ((b << 1) & ~MOVE_COL0) | MOVE_COL0;
    const u64 right = ((b >> 1) & ~MOVE_COL7) | MOVE_COL7;
    return BB_POPC(~b & up & down & left & right);
}

__global__ void move_kernel(const unsigned char* __restrict__ board,
                            const int* __restrict__ ids,
                            const unsigned char* __restrict__ used,
                            const unsigned char* __restrict__ done,
                            const int* __restrict__ streak,
                            const int* __restrict__ action,
                            const long long* __restrict__ place,
                            const long long* __restrict__ anchor_ok,
                            const int* __restrict__ nblocks_of,
                            unsigned char* __restrict__ new_board,
                            int* __restrict__ ints,
                            unsigned char* __restrict__ flags,
                            unsigned char* __restrict__ used_after,
                            float* __restrict__ center, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const u64 b = bb_pack_bytes(board + 64 * (size_t)lane);

    // Decode; an action outside [0, 192) or a bad piece id is an invalid
    // move (the plain version refuses such inputs outright).
    const int a = action[lane];
    const bool a_ok = a >= 0 && a < 192;
    const int slot = a_ok ? a / 64 : 0;
    const int anchor = a_ok ? a % 64 : 0;
    const int p = ids[3 * lane + slot];
    const bool p_ok = p >= 0 && p < BB_NUM_PIECES;
    const int q = p_ok ? p : 0;
    const u64 occ = (u64)place[64 * q + anchor];
    const bool in_bounds = (((u64)anchor_ok[q] >> anchor) & 1ULL) != 0;
    const bool valid = a_ok && p_ok && in_bounds && (occ & b) == 0 &&
                       used[3 * lane + slot] == 0 && done[lane] == 0;

    // Place and clear on every lane; only valid lanes keep the result.
    const u64 placed = b | occ;
    const u64 rows = bb_full_rows(placed);
    const u64 cols = bb_full_cols(placed);
    const int rows_c = BB_POPC(rows);
    const int cols_c = BB_POPC(cols);
    const u64 nb = valid ? placed & ~(rows * 0xFFULL | cols * BB_BYTE_LSB) : b;
    const int lines = valid ? rows_c + cols_c : 0;
    const bool cleared_any = lines > 0;
    const int st = streak[lane];
    const int streak_after = valid ? (cleared_any ? st + 1 : 0) : st;
    const int nblocks = nblocks_of[q];
    const int combo = lines < 4 ? lines : 4;
    const int streak_mult = streak_after + 1 < 8 ? streak_after + 1 : 8;
    const int line_points = lines * 8 * 10 * combo * streak_mult;
    const int score = valid ? nblocks + (cleared_any ? line_points : 0) : 0;

    u64* out_board = (u64*)(new_board + 64 * (size_t)lane);
#pragma unroll
    for (int r = 0; r < 8; ++r) out_board[r] = bb_spread_byte(nb >> (8 * r));
    const int fill = BB_POPC(nb);
    ints[MV_PIECE * n + lane] = p;
    ints[MV_NBLOCKS * n + lane] = nblocks;
    ints[MV_LINES * n + lane] = lines;
    ints[MV_ROWS * n + lane] = rows_c;
    ints[MV_COLS * n + lane] = cols_c;
    ints[MV_STREAK * n + lane] = streak_after;
    ints[MV_COMBO * n + lane] = combo;
    ints[MV_SCORE * n + lane] = score;
    ints[MV_HOLES * n + lane] = bb_holes(nb);
    ints[MV_FILL * n + lane] = fill;
    flags[MV_VALID * n + lane] = valid ? 1 : 0;
    flags[MV_CLEARED * n + lane] = cleared_any ? 1 : 0;
#pragma unroll
    for (int s = 0; s < 3; ++s)
        used_after[3 * lane + s] =
            (used[3 * lane + s] != 0 || (valid && s == slot)) ? 1 : 0;
    // 1 - k/16 is exact in float32 for k in [0, 16].
    center[lane] = 1.0f - (float)BB_POPC(nb & MOVE_CENTER16) / 16.0f;
}

extern "C" int bbx_move(const void* board, const void* ids, const void* used,
                        const void* done, const void* streak,
                        const void* action, const void* place,
                        const void* anchor_ok, const void* nblocks,
                        void* new_board, void* ints, void* flags,
                        void* used_after, void* center, int n, void* stream) {
    if (n > 0)
        BBX_LAUNCH(move_kernel, (n + MOVE_THREADS - 1) / MOVE_THREADS,
                   MOVE_THREADS, stream, (const unsigned char*)board,
                   (const int*)ids, (const unsigned char*)used,
                   (const unsigned char*)done, (const int*)streak,
                   (const int*)action, (const long long*)place,
                   (const long long*)anchor_ok, (const int*)nblocks,
                   (unsigned char*)new_board, (int*)ints,
                   (unsigned char*)flags, (unsigned char*)used_after,
                   (float*)center, n);
    return (int)cudaGetLastError();
}
