"""The batched game step: place -> clear -> score -> regen -> game over.

`step` dispatches on the device of the state.  On the CPU it runs the
plain PyTorch versions: `_move_core_plain` (validity, placement, clears,
score, the new board's holes / centre / fill, its bitboard and regen's
need flag), `regen_pieces_plain`, and `_step_finish_plain` (the game-over
test, the shaped reward, the counters, auto-reset and the observation).
On the card it makes three kernel launches: K6's two entry points
(`csrc/move.cu`: `bbx_move` before regen, `bbx_step_finish` after it)
around regen's K7 (`csrc/regen.cu`), counted in ``_move_core.launches``,
``_step_finish_cuda.launches`` and ``regen_pieces.launches``; a CUDA
tensor never takes a plain version.  There the step's outputs (the new state, obs,
reward, done and info) are views of `bbx_step_finish`'s two output blocks
(info's holes, lines and score gained of `bbx_move`'s), so a caller that
keeps one output keeps its block.  Both paths draw from the fleet's
generator alike: regen's seed, then (with auto-reset) the fresh triples,
once each a step.

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
from .state import (EnvState, _launch_regen, fresh_pieces, regen_pieces_plain,
                    regen_seed)
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
    regen_attempts: torch.Tensor  # [N] i32 -- regen's draws per lane (0: kept its triple)


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
# K6, before regen: the move core.
# ---------------------------------------------------------------------------

class Moved(NamedTuple):
    """The move core's outputs ([N] unless shown)."""

    valid: torch.Tensor          # bool
    piece: torch.Tensor          # i32
    nblocks: torch.Tensor        # i32
    new_board: torch.Tensor      # [N, 8, 8] u8
    lines: torch.Tensor          # i32
    rows_cleared: torch.Tensor   # i32
    cols_cleared: torch.Tensor   # i32
    cleared_any: torch.Tensor    # bool
    streak_after: torch.Tensor   # i32
    combo_mult: torch.Tensor     # i32
    score_gained: torch.Tensor   # i32
    used_after: torch.Tensor     # [N, 3] bool
    holes: torch.Tensor          # i32
    center: torch.Tensor         # f32
    filled: torch.Tensor         # i32
    bits: torch.Tensor           # [N, 2] i64, the new board's bitboard
    need: torch.Tensor           # bool, regen's need: all used by a valid move


def _move_core_plain(state: EnvState, actions: torch.Tensor) -> Moved:
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
    return Moved(
        valid, piece, nblocks, new_board, lines, rows_c, cols_c,
        cleared_any, streak_after, combo_mult, score_gained, used_after,
        K.count_holes(new_board), K.center_openness(new_board),
        K.total_blocks(new_board), S.board_bits(new_board),
        used_after.all(dim=1) & valid,
    )


def _move_core(state: EnvState, actions: torch.Tensor) -> Moved:
    """Pure move mechanics for all lanes (validity, placement, clears,
    score) and what the rest of the step reads of the new board.

    Args:
      state: batched EnvState (boards 0/1).
      actions: [N] integer flat actions in [0, 192).
    Returns:
      `Moved`: the twelve outputs of `bbx/engine/step.py:_move_core`
      (valid, piece, nblocks, new_board, lines, rows_cleared, cols_cleared,
      cleared_any, streak_after, combo_mult, score_gained, used_after), then
      `count_holes`, `center_openness` and `total_blocks` of the new board,
      its bitboard (`solvability.board_bits`) and regen's need flag
      (``used_after.all(1) & valid``).
    """
    if not state.board.is_cuda:
        return _move_core_plain(state, actions)
    return _move_core_cuda(state, _require_state(state, actions))


def _require_state(state: EnvState, actions: Optional[torch.Tensor] = None):
    """Raise unless every field of `state` (and `actions`, converted to
    int32) is what K6 takes; returns the converted actions."""
    n = state.num_envs
    shapes = {1: (n,), 3: (n, PIECES_PER_TURN), 8: (n, BOARD_SIZE, BOARD_SIZE)}
    checks = [(label, getattr(state, field), dtype, shapes[kind])
              for label, field, dtype, kind in _STATE_CHECKS]
    if actions is not None:
        actions = actions.to(torch.int32).contiguous()
        checks.append(("step: actions", actions, torch.int32, shapes[1]))
    build.require_many(checks)
    return actions


# (label, field, dtype, shape kind: [n], [n, 3] or [n, 8, 8]) of each
# field of the state that K6 reads.
_STATE_CHECKS = (
    ("step: board", "board", torch.uint8, 8),
    ("step: piece_ids", "piece_ids", torch.int32, 3),
    ("step: used", "used", torch.bool, 3),
    ("step: done", "done", torch.bool, 1),
    ("step: prev_center", "prev_center", torch.float32, 1),
    ("step: ep_return", "ep_return", torch.float32, 1),
) + tuple((f"step: {f}", f, torch.int32, 1) for f in (
    "score", "streak", "moves", "lines_total", "max_streak", "blocks_total",
    "prev_holes", "ep_len"))


def _rows_at(layout) -> tuple:
    """({field: (first row, rows)}, rows in all) of a block whose outputs
    are `layout`'s (field, rows) in turn, each row n elements."""
    at, row = {}, 0
    for field, rows in layout:
        at[field] = (row, rows)
        row += rows
    return at, row


# `bbx_move`'s outputs in its two blocks, the one place that lays them out
# (`csrc/move.cu` takes a pointer to each output; it writes the ten int32
# rows from `piece` to `filled` and the three bool rows from `valid` to
# `need` in this order).  The int32 block holds the bitboards [n, 2] i64,
# ten int32 rows and the centre f32; the byte block the board [n, 8, 8],
# `used` [n, 3] and three bool rows.
_MV_WORD_AT, _MV_WORDS = _rows_at((
    ("bits", 4), ("piece", 1), ("nblocks", 1), ("lines", 1), ("rows_cleared", 1),
    ("cols_cleared", 1), ("streak_after", 1), ("combo_mult", 1),
    ("score_gained", 1), ("holes", 1), ("filled", 1), ("center", 1)))
_MV_BYTE_AT, _MV_BYTES = _rows_at((
    ("new_board", NUM_CELLS), ("used_after", PIECES_PER_TURN), ("valid", 1),
    ("cleared_any", 1), ("need", 1)))
# dtype and per-lane shape of the outputs that are not one int32 a lane.
_MV_VIEWS = {
    "bits": (torch.int64, (2,)), "center": (torch.float32, ()),
    "new_board": (torch.uint8, (BOARD_SIZE, BOARD_SIZE)),
    "used_after": (torch.bool, (PIECES_PER_TURN,)), "valid": (torch.bool, ()),
    "cleared_any": (torch.bool, ()), "need": (torch.bool, ())}


class MoveBlocks(NamedTuple):
    """`bbx_move`'s two output blocks and the device pointer of each of its
    outputs, by `Moved`'s field names."""

    words: torch.Tensor  # int32 [n * _MV_WORDS]
    raw: torch.Tensor    # uint8 [n * _MV_BYTES]
    ptrs: dict

    def view(self, field: str) -> torch.Tensor:
        """Output `field` as a view of its block."""
        if field in _MV_WORD_AT:
            block, (row, rows), size = self.words, _MV_WORD_AT[field], _MV_WORDS
        else:
            block, (row, rows), size = self.raw, _MV_BYTE_AT[field], _MV_BYTES
        n = block.numel() // size
        dtype, shape = _MV_VIEWS.get(field, (torch.int32, ()))
        return block[row * n:(row + rows) * n].view(dtype).view(n, *shape)

    def moved(self) -> Moved:
        return Moved(*(self.view(f) for f in Moved._fields))


def _launch_move(state: EnvState, actions: torch.Tensor, stream: int,
                 tb) -> MoveBlocks:
    """`bbx_move` on a checked state into two fresh blocks."""
    n = state.num_envs
    dev = state.board.device
    words = torch.empty(n * _MV_WORDS, dtype=torch.int32, device=dev)
    raw = torch.empty(n * _MV_BYTES, dtype=torch.uint8, device=dev)
    w, r = words.data_ptr(), raw.data_ptr()
    ptrs = {f: w + 4 * n * row for f, (row, _) in _MV_WORD_AT.items()}
    ptrs.update((f, r + n * row) for f, (row, _) in _MV_BYTE_AT.items())
    err = build.function("move")(
        state.board.data_ptr(), state.piece_ids.data_ptr(),
        state.used.data_ptr(), state.done.data_ptr(), state.streak.data_ptr(),
        actions.data_ptr(), tb.PLACE_U64.data_ptr(), tb.ANCHOR_OK_U64.data_ptr(),
        tb.PIECE_NBLOCKS.data_ptr(), ptrs["new_board"], ptrs["piece"],
        ptrs["valid"], ptrs["used_after"], ptrs["center"], ptrs["bits"], n, stream)
    build.check("move", err)
    if n:
        _move_core.launches += 1
    return MoveBlocks(words, raw, ptrs)


def _move_core_cuda(state: EnvState, actions: torch.Tensor) -> Moved:
    """`bbx_move` on a checked state, its outputs as views of its blocks."""
    return _launch_move(state, actions, build.stream_of(state.board),
                        tables(state.device)).moved()


_move_core.launches = 0


# ---------------------------------------------------------------------------
# K6, after regen: game over, reward, counters, auto-reset, observation.
# ---------------------------------------------------------------------------

def _step_finish_plain(state: EnvState, moved: Moved, ids_after: torch.Tensor,
                       fresh: Optional[torch.Tensor],
                       reward_config: RewardConfig, auto_reset: bool):
    """The rest of `bbx/engine/step.py:step` after regen, per lane: the
    game-over test, the shaped reward, the counters, auto-reset and the
    observation (the plain version of `_step_finish_cuda`).

    Args:
      state: the EnvState before the step.
      moved: `_move_core`'s outputs for the step's actions.
      ids_after: [N, 3] int32, regen's ids (`regen_pieces` on
        ``moved.bits`` and ``moved.need``).
      fresh: [N, 3] int32, the triples of lanes that reset
        (`fresh_pieces`); None without auto-reset.
      reward_config, auto_reset: as `step`'s.
    Returns:
      (new state, obs, reward, done, info) as in `StepOutput`.
    """
    tb = tables(state.device)
    n = state.num_envs
    (valid, _piece, nblocks, new_board, lines, _rows, _cols, cleared_any,
     streak_after, combo_mult, score_gained, used_after, holes_now, center_now,
     filled, bits, all_used) = moved

    score_after = state.score + score_gained
    moves_after = state.moves + valid.to(torch.int32)
    lines_total_after = state.lines_total + lines
    max_streak_after = torch.maximum(state.max_streak, streak_after)
    blocks_total_after = state.blocks_total + torch.where(valid, nblocks, 0)
    used_after = torch.where(all_used[:, None], False, used_after)

    # Game over: no unused piece has a valid placement.
    valid3 = S.valid3_bits_plain(bits, ids_after)
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
        new_state = EnvState(
            board=torch.where(d[:, None, None], 0, new_state.board),
            piece_ids=torch.where(d[:, None], fresh, new_state.piece_ids),
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
    return new_state, obs, reward, game_over_now, info


def _reward_coefficients(rc: RewardConfig) -> tuple:
    """The reward's coefficients as the plain version's float32 arithmetic
    sees them: each Python double (``center_bonus * 0.1`` a double product)
    is rounded once to float32, by ctypes as by PyTorch."""
    return (rc.block_placed, rc.survival_bonus, rc.line_clear_base,
            rc.combo_multiplier_bonus, rc.game_over_penalty, rc.hole_penalty,
            rc.center_bonus * 0.1)


# Rows of `bbx_step_finish`'s output blocks (`csrc/move.cu`).
_FIN_FLOATS, _FIN_INTS, _FIN_BOOLS = 5, 16, 3
_OBS_FLOATS = NUM_CELLS + NUM_ACTIONS  # board and pieces planes a lane
# bbx_move's outputs that `bbx_step_finish` reads, in its argument order.
_FIN_MOVED = ("valid", "cleared_any", "need", "used_after", "nblocks", "lines",
              "combo_mult", "score_gained", "holes", "filled", "streak_after",
              "center", "bits")


def _step_finish_cuda(state: EnvState, moved: MoveBlocks, ids_after: torch.Tensor,
                      fresh: Optional[torch.Tensor], reward_config: RewardConfig,
                      auto_reset: bool, stream: int, tb):
    """`bbx_step_finish` on a checked state, `bbx_move`'s blocks for it,
    regen's ids and (with auto-reset) the fresh triples, into two fresh
    blocks: (new state, obs, reward, done, info) as views of them."""
    n = state.num_envs
    dev = state.board.device
    words = torch.empty(n * (_OBS_FLOATS + _FIN_FLOATS + PIECES_PER_TURN + _FIN_INTS),
                        dtype=torch.int32, device=dev)
    raw = torch.empty(n * (NUM_CELLS + NUM_ACTIONS + PIECES_PER_TURN + _FIN_BOOLS),
                      dtype=torch.uint8, device=dev)
    err = build.function("step_finish")(
        state.score.data_ptr(), state.moves.data_ptr(),
        state.lines_total.data_ptr(), state.max_streak.data_ptr(),
        state.blocks_total.data_ptr(), state.prev_holes.data_ptr(),
        state.ep_len.data_ptr(), state.done.data_ptr(),
        state.prev_center.data_ptr(), state.ep_return.data_ptr(),
        *(moved.ptrs[f] for f in _FIN_MOVED), ids_after.data_ptr(),
        fresh.data_ptr() if auto_reset else None, tb.PLACE_U64.data_ptr(),
        tb.PIECE_SHIFTS_I32.data_ptr(), tb.ANCHOR_OK_U64.data_ptr(),
        *_reward_coefficients(reward_config), int(auto_reset), words.data_ptr(),
        raw.data_ptr(), n, stream)
    build.check("step_finish", err)
    if n:
        _step_finish_cuda.launches += 1
    return _finish_views(state, words, raw, moved)


_step_finish_cuda.launches = 0


def _finish_views(state: EnvState, words, raw, moved: MoveBlocks):
    """(new state, obs, reward, done, info) as views of `bbx_step_finish`'s
    blocks (info's holes, lines and score_gained of `bbx_move`'s)."""
    n = state.num_envs
    obs_board, obs_pieces, floats, _ = words.view(torch.float32).split(
        [NUM_CELLS * n, NUM_ACTIONS * n, _FIN_FLOATS * n,
         (PIECES_PER_TURN + _FIN_INTS) * n])
    ids, ints = words[(_OBS_FLOATS + _FIN_FLOATS) * n:].split(
        [PIECES_PER_TURN * n, _FIN_INTS * n])
    board = raw[:NUM_CELLS * n]
    mask, used, flags = raw[NUM_CELLS * n:].view(torch.bool).split(
        [NUM_ACTIONS * n, PIECES_PER_TURN * n, _FIN_BOOLS * n])
    prev_center, ep_return, reward, final_return, fill = floats.view(
        _FIN_FLOATS, n).unbind(0)
    (score, streak, moves, lines_total, max_streak, blocks_total, prev_holes,
     ep_len, score_i, moves_i, lines_i, max_streak_i, blocks_i, ep_len_i,
     last_blocks, last_combo) = ints.view(_FIN_INTS, n).unbind(0)
    done, game_over, invalid = flags.view(_FIN_BOOLS, n).unbind(0)
    new_state = EnvState(
        board=board.view(n, BOARD_SIZE, BOARD_SIZE),
        piece_ids=ids.view(n, PIECES_PER_TURN),
        used=used.view(n, PIECES_PER_TURN),
        score=score, streak=streak, moves=moves, lines_total=lines_total,
        max_streak=max_streak, blocks_total=blocks_total, done=done,
        prev_holes=prev_holes, prev_center=prev_center, ep_return=ep_return,
        ep_len=ep_len, rng=state.rng)
    obs = {"board": obs_board.view(n, BOARD_SIZE, BOARD_SIZE),
           "pieces": obs_pieces.view(n, PIECES_PER_TURN, BOARD_SIZE, BOARD_SIZE),
           "action_mask": mask.view(n, NUM_ACTIONS)}
    info = {
        "score": score_i, "moves": moves_i, "lines_cleared": lines_i,
        "max_combo": max_streak_i, "blocks_placed": blocks_i,
        "board_fill": fill, "holes": moved.view("holes"), "invalid_action": invalid,
        "last_blocks_placed": last_blocks, "last_lines_cleared": moved.view("lines"),
        "last_combo_multiplier": last_combo,
        "last_score_gained": moved.view("score_gained"),
        "final_score": score_i, "final_length": ep_len_i,
        "final_return": final_return, "final_lines": lines_i,
        "final_max_combo": max_streak_i,
    }
    return new_state, obs, reward, game_over, info




# ---------------------------------------------------------------------------
# The step.
# ---------------------------------------------------------------------------

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
      StepOutput(state, obs, reward, done, info, regen_attempts).
    """
    if not state.board.is_cuda:
        return _step_plain(state, actions, reward_config, auto_reset)
    return _step_cuda(state, actions, reward_config, auto_reset)


def _step_plain(state, actions, reward_config, auto_reset) -> StepOutput:
    moved = _move_core_plain(state, actions)
    # One seed per step, drawn whether or not a lane needs it, so the
    # generator advances alike on every step.
    seed = regen_seed(state.rng, state.device)
    ids, attempts = regen_pieces_plain(moved.bits, state.piece_ids, seed, moved.need)
    fresh = fresh_pieces(state.num_envs, state.rng, state.device) if auto_reset else None
    return StepOutput(*_step_finish_plain(state, moved, ids, fresh, reward_config,
                                          auto_reset), attempts)


def _step_cuda(state, actions, reward_config, auto_reset) -> StepOutput:
    """K6, K7, K6: three launches and the generator's draws, the state
    checked once, each kernel reading the previous one's output blocks
    through `MoveBlocks.ptrs`, no host synchronisation."""
    actions = _require_state(state, actions)
    n = state.num_envs
    dev = state.board.device
    stream = build.stream_of(state.board)
    tb = tables(dev)
    moved = _launch_move(state, actions, stream, tb)
    seed = regen_seed(state.rng, dev)
    ids, attempts = _launch_regen(moved.ptrs["bits"], state.piece_ids.data_ptr(),
                                  moved.ptrs["need"], seed.data_ptr(), n, dev,
                                  stream, tb)
    fresh = fresh_pieces(n, state.rng, dev) if auto_reset else None
    return StepOutput(*_step_finish_cuda(state, moved, ids, fresh, reward_config,
                                         auto_reset, stream, tb), attempts)
