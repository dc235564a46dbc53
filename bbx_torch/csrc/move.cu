// K6: the whole per-lane game step but regen, in two entry points around
// the regen kernel K7.
//
// `bbx_move`, before regen: decode the action, test its validity, place,
// clear full rows and columns, update the streak and score, plus the
// statistics of the new board that the shaped reward reads (holes, centre
// openness, filled cells), the new board's bitboard words (regen's and
// the game-over test's input) and regen's need flag.
// `bbx_step_finish`, after regen: K1's fit of the lane's final triple, the
// game-over test, the shaped reward, every counter of the state, the info
// fields, the auto-reset of lanes that ended, and the observation.
//
// Replaces bbx/engine/step.py: _move_core (with count_holes,
// center_openness and total_blocks of bbx/engine/kernel.py applied to its
// new board) and the reward / auto-reset block of `step` (:143-289), which
// XLA runs as a fusion of gathers over PLACEMENT and [N, 8, 8] reductions
// and PyTorch as about 120 launches.  Here one thread serves one lane: the
// uint8 board is packed into one u64, the move is a handful of 64-bit ops
// on PLACE_U64 and ANCHOR_OK_U64, holes / centre / fill and the fits are
// shifts, masks and popcounts.  The [N] results are rows of packed blocks,
// so neighbouring threads store to neighbouring addresses; the finish
// kernel stages each lane's board, masks and pieces as bitboards in shared
// memory and its block then writes the observation ([N, 8, 8] and
// [N, 3, 8, 8] f32, [N, 192] bool) with coalesced 16- and 8-byte stores.
// The reward's float sum is rounded operation by operation (`_rn`
// intrinsics, no contraction), in the plain version's order, so it is
// equal bit for bit.  Bound by bytes (about 90 B read and 150 B written a
// lane by `bbx_move`, about 180 B read and 1,300 B written by
// `bbx_step_finish`, most of it the float32 observation); at 512-16,384
// lanes, launch latency and the wrapper's host work set the time.
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
// Rows of the bool output block [MOVE_FLAGS, n]; MV_NEED is regen's need
// flag (a valid move that used the last unused piece).
enum { MV_VALID, MV_CLEARED, MV_NEED, MOVE_FLAGS };

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
                            float* __restrict__ center,
                            long long* __restrict__ bits, int n) {
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
    bool all_used = true;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        const bool u = used[3 * lane + s] != 0 || (valid && s == slot);
        used_after[3 * lane + s] = u ? 1 : 0;
        all_used = all_used && u;
    }
    flags[MV_VALID * n + lane] = valid ? 1 : 0;
    flags[MV_CLEARED * n + lane] = cleared_any ? 1 : 0;
    flags[MV_NEED * n + lane] = (valid && all_used) ? 1 : 0;
    // 1 - k/16 is exact in float32 for k in [0, 16].
    center[lane] = 1.0f - (float)BB_POPC(nb & MOVE_CENTER16) / 16.0f;
    bits[2 * lane] = (long long)(nb & 0xFFFFFFFFULL);
    bits[2 * lane + 1] = (long long)(nb >> 32);
}

extern "C" int bbx_move(const void* board, const void* ids, const void* used,
                        const void* done, const void* streak,
                        const void* action, const void* place,
                        const void* anchor_ok, const void* nblocks,
                        void* new_board, void* ints, void* flags,
                        void* used_after, void* center, void* bits, int n,
                        void* stream) {
    if (n > 0)
        BBX_LAUNCH(move_kernel, (n + MOVE_THREADS - 1) / MOVE_THREADS,
                   MOVE_THREADS, stream, (const unsigned char*)board,
                   (const int*)ids, (const unsigned char*)used,
                   (const unsigned char*)done, (const int*)streak,
                   (const int*)action, (const long long*)place,
                   (const long long*)anchor_ok, (const int*)nblocks,
                   (unsigned char*)new_board, (int*)ints,
                   (unsigned char*)flags, (unsigned char*)used_after,
                   (float*)center, (long long*)bits, n);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bbx_step_finish.
// ---------------------------------------------------------------------------

#define FIN_THREADS 128
#define FIN_INVALID_REWARD (-10.0f)  // INVALID_ACTION_REWARD of step.py

// The 4-byte output block, in order: the observation's board [n, 64] and
// pieces [n, 3, 64] (f32), FIN_FLOATS rows of n f32, the piece ids [n, 3]
// and FIN_INTS rows of n int32.  The byte block: the board [n, 64] (u8),
// the action mask [n, 192] and `used` [n, 3] (bool), then FIN_BOOLS rows
// of n bool.  `bbx_torch/engine/step.py` carves its views in this order.
enum { FF_PREV_CENTER, FF_EP_RETURN, FF_REWARD, FF_FINAL_RETURN, FF_BOARD_FILL,
       FIN_FLOATS };
enum { FI_SCORE, FI_STREAK, FI_MOVES, FI_LINES, FI_MAX_STREAK, FI_BLOCKS,
       FI_PREV_HOLES, FI_EP_LEN,  // the new state
       FI_SCORE_INFO, FI_MOVES_INFO, FI_LINES_INFO, FI_MAX_STREAK_INFO,
       FI_BLOCKS_INFO, FI_EP_LEN_INFO, FI_LAST_BLOCKS, FI_LAST_COMBO,  // info
       FIN_INTS };
enum { FB_DONE, FB_GAME_OVER, FB_INVALID, FIN_BOOLS };

struct finish_inputs {
    // The state before the step.
    const int *score, *moves, *lines_total, *max_streak, *blocks_total,
        *prev_holes, *ep_len;
    const unsigned char* done;
    const float *prev_center, *ep_return;
    // bbx_move's outputs.
    const unsigned char *valid, *cleared, *need, *used_after;
    const int *nblocks, *lines, *combo, *gained, *holes, *fill, *streak;
    const float* center;
    const long long* bits;
    // Regen's ids and the fresh triple of a lane that resets (null
    // without auto-reset).
    const int *ids, *fresh;
    const long long* place;
    const int* shifts;
    const long long* anchor_ok;
};

// The shaped reward's coefficients, each rounded once to float32 on the
// host exactly as the plain version rounds them.
struct finish_coefs {
    float block_placed, survival, line_clear, combo_bonus, game_over, hole,
        center;
};

// Valid-anchor mask of piece p on board b (0 for an id out of range).
__device__ __forceinline__ u64 fin_fit(u64 b, int p, const int* shifts,
                                       const long long* anchor_ok) {
    if (p < 0 || p >= BB_NUM_PIECES) return 0;
    return bb_fit(b, shifts + BB_SHIFTS * p, (u64)anchor_ok[p]);
}

__global__ void __launch_bounds__(FIN_THREADS)
step_finish_kernel(finish_inputs in, finish_coefs c, int auto_reset,
                   int* __restrict__ out4, unsigned char* __restrict__ out1,
                   int n) {
    __shared__ u64 s_board[FIN_THREADS];
    __shared__ u64 s_mask[FIN_THREADS][3];
    __shared__ u64 s_piece[FIN_THREADS][3];

    const int t = threadIdx.x;
    const int base = blockIdx.x * FIN_THREADS;
    const int lane = base + t;
    const size_t nn = (size_t)n;
    float* obs_board = (float*)out4;
    float* obs_pieces = obs_board + 64 * nn;
    float* frow = obs_pieces + 192 * nn;
    int* ids_out = (int*)(frow + FIN_FLOATS * nn);
    int* irow = ids_out + 3 * nn;
    unsigned char* board_out = out1;
    unsigned char* mask_out = board_out + 64 * nn;
    unsigned char* used_out = mask_out + 192 * nn;
    unsigned char* brow = used_out + 3 * nn;

    if (lane < n) {
        const bool valid = in.valid[lane] != 0;
        const bool cleared = in.cleared[lane] != 0;
        const bool need = in.need[lane] != 0;
        const u64 nb = bb_load(in.bits + 2 * lane);

        // The game-over test on the final triple (regen's used slots
        // cleared).
        int id[3];
        bool used[3];
        u64 fit[3], moves_left = 0;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            id[s] = in.ids[3 * lane + s];
            used[s] = !need && in.used_after[3 * lane + s] != 0;
            fit[s] = fin_fit(nb, id[s], in.shifts, in.anchor_ok);
            if (!used[s]) moves_left |= fit[s];
        }
        const bool done_in = in.done[lane] != 0;
        const bool no_moves = moves_left == 0;
        const bool done_after = valid ? no_moves : done_in;
        const bool game_over = valid && no_moves && !done_in;

        const int nblocks = in.nblocks[lane], lines = in.lines[lane];
        const int combo = in.combo[lane], holes = in.holes[lane];
        const int streak = in.streak[lane];
        const int score_after = in.score[lane] + in.gained[lane];
        const int moves_after = in.moves[lane] + (valid ? 1 : 0);
        const int lines_after = in.lines_total[lane] + lines;
        const int max_streak_after = max(in.max_streak[lane], streak);
        const int blocks_after = in.blocks_total[lane] + (valid ? nblocks : 0);

        // The shaped reward, term by term in the plain version's order.
        const float prev_center = in.prev_center[lane];
        const float center = in.center[lane];
        const int prev_holes = in.prev_holes[lane];
        const int hole_delta = holes - prev_holes;
        const float combo_f = (float)combo;
        const float line_term = __fadd_rn(
            __fmul_rn(__fmul_rn((float)lines, c.line_clear), combo_f),
            combo > 1 ? __fmul_rn(__fsub_rn(combo_f, 1.0f), c.combo_bonus) : 0.0f);
        float r = __fmul_rn((float)nblocks, c.block_placed);
        r = __fadd_rn(r, c.survival);
        r = __fadd_rn(r, cleared ? line_term : 0.0f);
        r = __fadd_rn(r, game_over ? c.game_over : 0.0f);
        r = __fadd_rn(r, hole_delta > 0 ? __fmul_rn((float)hole_delta, c.hole) : 0.0f);
        r = __fadd_rn(r, center >= prev_center ? c.center : 0.0f);
        const float reward = valid ? r : FIN_INVALID_REWARD;
        const float return_after = __fadd_rn(in.ep_return[lane], reward);
        const int len_after = in.ep_len[lane] + 1;

        // Auto-reset of a lane whose game ended in this step.
        const bool reset = auto_reset && game_over;
        const bool done_out = !auto_reset && done_after;
        const size_t i = (size_t)lane;
        frow[FF_PREV_CENTER * nn + i] = reset ? 1.0f : (valid ? center : prev_center);
        frow[FF_EP_RETURN * nn + i] = reset ? 0.0f : return_after;
        frow[FF_REWARD * nn + i] = reward;
        frow[FF_FINAL_RETURN * nn + i] = return_after;
        frow[FF_BOARD_FILL * nn + i] = (float)in.fill[lane] / 64.0f;
        irow[FI_SCORE * nn + i] = reset ? 0 : score_after;
        irow[FI_STREAK * nn + i] = reset ? 0 : streak;
        irow[FI_MOVES * nn + i] = reset ? 0 : moves_after;
        irow[FI_LINES * nn + i] = reset ? 0 : lines_after;
        irow[FI_MAX_STREAK * nn + i] = reset ? 0 : max_streak_after;
        irow[FI_BLOCKS * nn + i] = reset ? 0 : blocks_after;
        irow[FI_PREV_HOLES * nn + i] = reset ? 0 : (valid ? holes : prev_holes);
        irow[FI_EP_LEN * nn + i] = reset ? 0 : len_after;
        irow[FI_SCORE_INFO * nn + i] = score_after;
        irow[FI_MOVES_INFO * nn + i] = moves_after;
        irow[FI_LINES_INFO * nn + i] = lines_after;
        irow[FI_MAX_STREAK_INFO * nn + i] = max_streak_after;
        irow[FI_BLOCKS_INFO * nn + i] = blocks_after;
        irow[FI_EP_LEN_INFO * nn + i] = len_after;
        irow[FI_LAST_BLOCKS * nn + i] = valid ? nblocks : 0;
        irow[FI_LAST_COMBO * nn + i] = cleared ? combo : 1;
        brow[FB_DONE * nn + i] = done_out ? 1 : 0;
        brow[FB_GAME_OVER * nn + i] = game_over ? 1 : 0;
        brow[FB_INVALID * nn + i] = valid ? 0 : 1;

        // The final triple, its used slots, masks and piece planes.  A lane
        // that resets has an empty board, so its masks are ANCHOR_OK.
        s_board[t] = reset ? 0 : nb;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            const int p = reset ? in.fresh[3 * lane + s] : id[s];
            const bool u = !reset && used[s];
            const bool p_ok = p >= 0 && p < BB_NUM_PIECES;
            ids_out[3 * i + s] = p;
            used_out[3 * i + s] = u ? 1 : 0;
            const u64 m = reset ? (p_ok ? (u64)in.anchor_ok[p] : 0) : fit[s];
            s_mask[t][s] = (u || done_out) ? 0 : m;
            s_piece[t][s] = (u || !p_ok) ? 0 : (u64)in.place[64 * p];
        }
    }
    __syncthreads();

    // The block's lanes' observation and board, with coalesced stores.
    const int count = min(FIN_THREADS, n - base);
    float4* ob = (float4*)(obs_board + 64 * (size_t)base);
    for (int k = t; k < count * 16; k += FIN_THREADS) {
        const u64 b = s_board[k / 16] >> (4 * (k % 16));
        ob[k] = make_float4((float)(b & 1), (float)((b >> 1) & 1),
                            (float)((b >> 2) & 1), (float)((b >> 3) & 1));
    }
    float4* op = (float4*)(obs_pieces + 192 * (size_t)base);
    for (int k = t; k < count * 48; k += FIN_THREADS) {
        const int r = k % 48;
        const u64 m = s_piece[k / 48][r / 16] >> (4 * (r % 16));
        op[k] = make_float4((float)(m & 1), (float)((m >> 1) & 1),
                            (float)((m >> 2) & 1), (float)((m >> 3) & 1));
    }
    u64* om = (u64*)(mask_out + 192 * (size_t)base);
    for (int k = t; k < count * 24; k += FIN_THREADS) {
        const int r = k % 24;
        om[k] = bb_spread_byte(s_mask[k / 24][r / 8] >> (8 * (r % 8)));
    }
    u64* obd = (u64*)(board_out + 64 * (size_t)base);
    for (int k = t; k < count * 8; k += FIN_THREADS)
        obd[k] = bb_spread_byte(s_board[k / 8] >> (8 * (k % 8)));
}

extern "C" int bbx_step_finish(
    const void* score, const void* moves, const void* lines_total,
    const void* max_streak, const void* blocks_total, const void* prev_holes,
    const void* ep_len, const void* done, const void* prev_center,
    const void* ep_return, const void* valid, const void* cleared,
    const void* need, const void* used_after, const void* nblocks,
    const void* lines, const void* combo, const void* gained,
    const void* holes, const void* fill, const void* streak,
    const void* center, const void* bits, const void* ids, const void* fresh,
    const void* place, const void* shifts, const void* anchor_ok,
    float block_placed, float survival, float line_clear, float combo_bonus,
    float game_over, float hole, float center_step, int auto_reset,
    void* out4, void* out1, int n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    if (auto_reset && fresh == nullptr) return (int)cudaErrorInvalidValue;
    finish_inputs in;
    in.score = (const int*)score;
    in.moves = (const int*)moves;
    in.lines_total = (const int*)lines_total;
    in.max_streak = (const int*)max_streak;
    in.blocks_total = (const int*)blocks_total;
    in.prev_holes = (const int*)prev_holes;
    in.ep_len = (const int*)ep_len;
    in.done = (const unsigned char*)done;
    in.prev_center = (const float*)prev_center;
    in.ep_return = (const float*)ep_return;
    in.valid = (const unsigned char*)valid;
    in.cleared = (const unsigned char*)cleared;
    in.need = (const unsigned char*)need;
    in.used_after = (const unsigned char*)used_after;
    in.nblocks = (const int*)nblocks;
    in.lines = (const int*)lines;
    in.combo = (const int*)combo;
    in.gained = (const int*)gained;
    in.holes = (const int*)holes;
    in.fill = (const int*)fill;
    in.streak = (const int*)streak;
    in.center = (const float*)center;
    in.bits = (const long long*)bits;
    in.ids = (const int*)ids;
    in.fresh = (const int*)fresh;
    in.place = (const long long*)place;
    in.shifts = (const int*)shifts;
    in.anchor_ok = (const long long*)anchor_ok;
    const finish_coefs c = {block_placed, survival, line_clear, combo_bonus,
                            game_over, hole, center_step};
    BBX_LAUNCH(step_finish_kernel, (n + FIN_THREADS - 1) / FIN_THREADS,
               FIN_THREADS, stream, in, c, auto_reset, (int*)out4,
               (unsigned char*)out1, n);
    return (int)cudaGetLastError();
}
