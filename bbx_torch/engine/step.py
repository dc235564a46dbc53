"""The batched game step: place -> clear -> score -> regen -> game over.

The move core (validity, placement, clears, score, and the new board's
holes / centre / fill) dispatches on the device of the state: the plain
PyTorch version for CPU tensors, the CUDA kernel K6 (`csrc/move.cu`) for
CUDA tensors, counting its launches in ``_move_core.launches``.  Regen,
the game-over test (K1), the reward sum and the auto-reset stay tensor
code.

Counterpart of `bbx/engine/step.py`, with its quirks kept exactly:
  * invalid action: reward -10, state unchanged, episode does NOT end;
  * ``blocks_in_lines = lines_cleared * 8`` ignores row/col intersections;
  * the streak multiplier reads ``combo_count + 1`` *after* the increment,
    so the first clearing move already gets x2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..ops import build
from . import kernel as K
from . import solvability as S
from .state import EnvState, fresh_pieces, regen_pieces
from .tables import BOARD_SIZE, NUM_ACTIONS, NUM_CELLS, PIECES_PER_TURN, tables

MAX_COMBO_MULTIPLIER = 4   # engine.py:96
MAX_STREAK_MULTIPLIER = 8  # engine.py:97
BASE_SCORE_PER_BLOCK = 10  # engine.py:95
PLACEMENT_SCORE_PER_BLOCK = 1  # engine.py:94
INVALID_ACTION_REWARD = -10.0  # block_blast_env.py:245


@dataclass(frozen=True)
class RewardConfig:
    """Shaped-reward coefficients (`block_blast_env.py:63-71`)."""

    line_clear_base: float = 1.0
    block_placed: float = 0.01
    game_over_penalty: float = -1.0
    hole_penalty: float = -0.05
    center_bonus: float = 0.02
    combo_multiplier_bonus: float = 0.5
    survival_bonus: float = 0.001


class StepOutput(NamedTuple):
    state: EnvState
    obs: dict            # {'board' [N,8,8] f32, 'pieces' [N,3,8,8] f32, 'action_mask' [N,192] bool}
    reward: torch.Tensor  # [N] f32
    done: torch.Tensor    # [N] bool -- episode ended at this step
    info: dict            # per-env diagnostic tensors


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[n, idx[n]] for a [N, 3] table and [N] slot indices."""
    return torch.gather(t, 1, idx[:, None].long())[:, 0]


def observe(state: EnvState, valid3: Optional[torch.Tensor] = None) -> dict:
    """Build the network observation; `valid3` ([N, 3, 64] per-slot anchor
    validity) is computed from the bitboard if not supplied."""
    tb = tables(state.device)
    if valid3 is None:
        valid3 = S.valid3_bits(S.board_bits(state.board), state.piece_ids)
    mask3 = valid3 & ~state.used[:, :, None] & ~state.done[:, None, None]
    pieces = tb.PIECE_MASKS[state.piece_ids.long()]  # [N, 3, 8, 8]
    pieces = pieces * (~state.used[:, :, None, None]).to(torch.float32)
    return {
        "board": state.board.to(torch.float32),
        "pieces": pieces,
        "action_mask": mask3.reshape(-1, NUM_ACTIONS),
    }


# ---------------------------------------------------------------------------
# K6: the move core.
# ---------------------------------------------------------------------------

def _move_core_plain(state: EnvState, actions: torch.Tensor):
    """Plain version of `_move_core`."""
    tb = tables(state.device)
    n = state.num_envs
    slot, anchor = K.decode_action(actions.long())
    piece = _take(state.piece_ids, slot)
    pl = piece.long()

    # Point validity of the chosen (piece, anchor): bounds + no overlap +
    # piece unused + game not over.
    occ = tb.PLACEMENT[pl, anchor]  # [N, 64] bool
    overlap = (occ & (state.board.reshape(n, NUM_CELLS) > 0)).any(dim=1)
    slot_used = _take(state.used, slot)
    valid = tb.ANCHOR_OK[pl, anchor] & ~overlap & ~slot_used & ~state.done

    placed = state.board | occ.reshape(n, BOARD_SIZE, BOARD_SIZE).to(torch.uint8)
    cleared, rows_c, cols_c = K.clear_lines(placed)
    lines = rows_c + cols_c
    new_board = torch.where(valid[:, None, None], cleared, state.board)
    lines = torch.where(valid, lines, 0)

    cleared_any = lines > 0
    streak_after = torch.where(cleared_any, state.streak + 1, 0)
    streak_after = torch.where(valid, streak_after, state.streak)

    nblocks = tb.PIECE_NBLOCKS[pl]
    combo_mult = torch.clamp(lines, max=MAX_COMBO_MULTIPLIER)
    streak_mult = torch.clamp(streak_after + 1, max=MAX_STREAK_MULTIPLIER)
    line_points = lines * BOARD_SIZE * BASE_SCORE_PER_BLOCK * combo_mult * streak_mult
    score_gained = torch.where(
        valid,
        nblocks * PLACEMENT_SCORE_PER_BLOCK + torch.where(cleared_any, line_points, 0),
        0,
    )

    one_hot = torch.nn.functional.one_hot(slot, PIECES_PER_TURN).to(torch.bool)
    used_after = torch.where(valid[:, None], state.used | one_hot, state.used)
    return (
        valid, piece, nblocks, new_board, lines, rows_c, cols_c,
        cleared_any, streak_after, combo_mult, score_gained, used_after,
        K.count_holes(new_board), K.center_openness(new_board),
        K.total_blocks(new_board),
    )


def _move_core(state: EnvState, actions: torch.Tensor):
    """Pure move mechanics for all lanes (validity, placement, clears,
    score) and the statistics of the new board.

    Args:
      state: batched EnvState (boards 0/1).
      actions: [N] integer flat actions in [0, 192).
    Returns:
      (valid [N] bool, piece [N] i32, nblocks [N] i32, new_board [N,8,8]
      uint8, lines [N] i32, rows_cleared [N] i32, cols_cleared [N] i32,
      cleared_any [N] bool, streak_after [N] i32, combo_mult [N] i32,
      score_gained [N] i32, used_after [N,3] bool, holes [N] i32,
      center [N] f32, filled [N] i32): the twelve outputs of
      `bbx/engine/step.py:_move_core`, then `count_holes`,
      `center_openness` and `total_blocks` of the new board.
    """
    if not state.board.is_cuda:
        return _move_core_plain(state, actions)
    return _move_core_cuda(state, actions)


# Rows of the kernel's int32 and bool output blocks (`csrc/move.cu`).
(_MV_PIECE, _MV_NBLOCKS, _MV_LINES, _MV_ROWS, _MV_COLS, _MV_STREAK, _MV_COMBO,
 _MV_SCORE, _MV_HOLES, _MV_FILL) = range(10)


def _move_core_cuda(state: EnvState, actions: torch.Tensor):
    n = state.num_envs
    build.require("_move_core: board", state.board, torch.uint8,
                  (n, BOARD_SIZE, BOARD_SIZE))
    build.require("_move_core: piece_ids", state.piece_ids, torch.int32,
                  (n, PIECES_PER_TURN))
    build.require("_move_core: used", state.used, torch.bool, (n, PIECES_PER_TURN))
    build.require("_move_core: done", state.done, torch.bool, (n,))
    build.require("_move_core: streak", state.streak, torch.int32, (n,))
    actions = actions.to(torch.int32).contiguous()
    build.require("_move_core: actions", actions, torch.int32, (n,))
    tb = tables(state.device)
    dev = state.device
    new_board = torch.empty((n, BOARD_SIZE, BOARD_SIZE), dtype=torch.uint8,
                            device=dev)
    ints = torch.empty((10, n), dtype=torch.int32, device=dev)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    used_after = torch.empty((n, PIECES_PER_TURN), dtype=torch.bool, device=dev)
    center = torch.empty(n, dtype=torch.float32, device=dev)
    err = build.function("move")(
        state.board.data_ptr(), state.piece_ids.data_ptr(),
        state.used.data_ptr(), state.done.data_ptr(), state.streak.data_ptr(),
        actions.data_ptr(), tb.PLACE_U64.data_ptr(), tb.ANCHOR_OK_U64.data_ptr(),
        tb.PIECE_NBLOCKS.data_ptr(), new_board.data_ptr(), ints.data_ptr(),
        flags.data_ptr(), used_after.data_ptr(), center.data_ptr(), n,
        build.stream_of(state.board))
    build.check("move", err)
    _move_core.launches += 1
    return (
        flags[0], ints[_MV_PIECE], ints[_MV_NBLOCKS], new_board, ints[_MV_LINES],
        ints[_MV_ROWS], ints[_MV_COLS], flags[1], ints[_MV_STREAK],
        ints[_MV_COMBO], ints[_MV_SCORE], used_after, ints[_MV_HOLES], center,
        ints[_MV_FILL],
    )


_move_core.launches = 0


def step(state: EnvState, actions: torch.Tensor,
         reward_config: RewardConfig = RewardConfig(),
         auto_reset: bool = True) -> StepOutput:
    """Advance every environment by one action.

    Args:
      state: batched EnvState.
      actions: [N] integer flat actions (slot*64 + row*8 + col).
      reward_config: shaped-reward coefficients.
      auto_reset: reset finished lanes in place, with their final episode
        stats in `info`.  With False, finished lanes stay terminal and
        further steps on them take the invalid-action path.
    Returns:
      StepOutput(state, obs, reward, done, info).
    """
    tb = tables(state.device)
    n = state.num_envs
    (
        valid, piece, nblocks, new_board, lines, rows_c, cols_c,
        cleared_any, streak_after, combo_mult, score_gained, used_after,
        holes_now, center_now, filled,
    ) = _move_core(state, actions)

    score_after = state.score + score_gained
    moves_after = state.moves + valid.to(torch.int32)
    lines_total_after = state.lines_total + lines
    max_streak_after = torch.maximum(state.max_streak, streak_after)
    blocks_total_after = state.blocks_total + torch.where(valid, nblocks, 0)

    # Regenerate pieces when all three are used.
    all_used = used_after.all(dim=1) & valid
    ids_after = regen_pieces(new_board, state.piece_ids, state.rng, all_used)
    used_after = torch.where(all_used[:, None], False, used_after)

    # Game over: no unused piece has a valid placement.
    valid3 = S.valid3_bits(S.board_bits(new_board), ids_after)
    mask3 = valid3 & ~used_after[:, :, None]
    no_moves = ~mask3.reshape(n, -1).any(dim=1)
    done_after = torch.where(valid, no_moves, state.done)
    game_over_now = valid & no_moves & ~state.done

    # ---- Shaped reward (`block_blast_env.py:148-193`) ----
    rc = reward_config
    hole_delta = holes_now - state.prev_holes
    combo_mult_f = combo_mult.to(torch.float32)
    f32 = torch.float32
    reward = (
        nblocks.to(f32) * rc.block_placed
        + rc.survival_bonus
        + torch.where(
            cleared_any,
            lines.to(f32) * rc.line_clear_base * combo_mult_f
            + torch.where(combo_mult > 1,
                          (combo_mult_f - 1.0) * rc.combo_multiplier_bonus, 0.0),
            0.0,
        )
        + torch.where(game_over_now, rc.game_over_penalty, 0.0)
        + torch.where(hole_delta > 0, hole_delta.to(f32) * rc.hole_penalty, 0.0)
        + torch.where(center_now >= state.prev_center, rc.center_bonus * 0.1, 0.0)
    )
    reward = torch.where(valid, reward, INVALID_ACTION_REWARD).to(f32)
    prev_holes_after = torch.where(valid, holes_now, state.prev_holes)
    prev_center_after = torch.where(valid, center_now, state.prev_center)

    ep_return_after = state.ep_return + reward
    ep_len_after = state.ep_len + 1

    new_state = EnvState(
        board=new_board,
        piece_ids=ids_after,
        used=used_after,
        score=score_after,
        streak=streak_after,
        moves=moves_after,
        lines_total=lines_total_after,
        max_streak=max_streak_after,
        blocks_total=blocks_total_after,
        done=done_after,
        prev_holes=prev_holes_after,
        prev_center=prev_center_after,
        ep_return=ep_return_after,
        ep_len=ep_len_after,
        rng=state.rng,
    )

    info = {
        "score": score_after,
        "moves": moves_after,
        "lines_cleared": lines_total_after,
        "max_combo": max_streak_after,
        "blocks_placed": blocks_total_after,
        "board_fill": filled.to(f32) / NUM_CELLS,
        "holes": holes_now,
        "invalid_action": ~valid,
        # last-move details
        "last_blocks_placed": torch.where(valid, nblocks, 0),
        "last_lines_cleared": lines,
        "last_combo_multiplier": torch.where(cleared_any, combo_mult, 1),
        "last_score_gained": score_gained,
        # episode-final stats, valid where `done`
        "final_score": score_after,
        "final_length": ep_len_after,
        "final_return": ep_return_after,
        "final_lines": lines_total_after,
        "final_max_combo": max_streak_after,
    }

    if auto_reset:
        d = game_over_now
        draw = fresh_pieces(n, state.rng, state.device)
        new_state = EnvState(
            board=torch.where(d[:, None, None], 0, new_state.board),
            piece_ids=torch.where(d[:, None], draw, new_state.piece_ids),
            used=torch.where(d[:, None], False, new_state.used),
            score=torch.where(d, 0, new_state.score),
            streak=torch.where(d, 0, new_state.streak),
            moves=torch.where(d, 0, new_state.moves),
            lines_total=torch.where(d, 0, new_state.lines_total),
            max_streak=torch.where(d, 0, new_state.max_streak),
            blocks_total=torch.where(d, 0, new_state.blocks_total),
            done=torch.zeros(n, dtype=torch.bool, device=state.device),
            prev_holes=torch.where(d, 0, new_state.prev_holes),
            prev_center=torch.where(d, 1.0, new_state.prev_center),
            ep_return=torch.where(d, 0.0, new_state.ep_return),
            ep_len=torch.where(d, 0, new_state.ep_len),
            rng=state.rng,
        )
        # Masks for reset lanes come from the empty board: ANCHOR_OK of the
        # freshly drawn pieces.
        valid3 = torch.where(d[:, None, None],
                             tb.ANCHOR_OK[new_state.piece_ids.long()], valid3)

    obs = observe(new_state, valid3)
    return StepOutput(new_state, obs, reward, game_over_now, info)
