"""Batched board ops: counterpart of `bbx/engine/kernel.py`.

Boards are ``[N, 8, 8]`` uint8 (0/1).  Every function is plain tensor code
with no data-dependent Python control flow, so it runs as-is on the CPU or
the card.  Semantics mirror `bbx.engine.kernel` op for op.  The step's own
move, clear and board statistics run in the CUDA kernel K6 on the card
(`bbx_torch.engine.step`); the helpers here serve observation, analysis and
the tests.
"""
from __future__ import annotations

import torch

from .tables import BOARD_SIZE, NUM_CELLS, dense_tables, tables


def empty_boards(n: int, device) -> torch.Tensor:
    """A batch of empty 8x8 boards."""
    return torch.zeros((n, BOARD_SIZE, BOARD_SIZE), dtype=torch.uint8,
                       device=device)


def valid_anchors_all_pieces(board: torch.Tensor) -> torch.Tensor:
    """Validity of every (piece, anchor) pair on every board.

    One bf16 ``[N, 64] x [64, 37*64]`` product counts the board cells each
    anchored piece overlaps (counts <= 9, exact in bf16), as bbx computes
    it outside any kernel.

    Args:
      board: [N, 8, 8] uint8 (0/1).
    Returns:
      [N, 37, 64] bool -- the piece fits in bounds with no overlap.
    """
    n = board.shape[0]
    flat = board.reshape(n, NUM_CELLS).to(torch.bfloat16)
    overlap = torch.matmul(flat, dense_tables(board.device).OCC_T_BF16)  # [N, 2368]
    no_overlap = overlap.reshape(n, -1, NUM_CELLS) < 0.5
    return tables(board.device).ANCHOR_OK[None] & no_overlap


def gather_piece_validity(all_valid: torch.Tensor,
                          piece_ids: torch.Tensor) -> torch.Tensor:
    """Rows of a [N, 37, 64] validity tensor for [N, K] piece ids -> [N, K, 64]."""
    idx = piece_ids.long()[:, :, None].expand(-1, -1, all_valid.shape[-1])
    return torch.gather(all_valid, 1, idx)


def valid_anchors_for(board: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    """Validity of specific pieces per board: [N, 8, 8], [N, K] -> [N, K, 64]."""
    return gather_piece_validity(valid_anchors_all_pieces(board), piece_ids)


def place(board: torch.Tensor, piece_id: torch.Tensor,
          anchor: torch.Tensor) -> torch.Tensor:
    """Stamp each piece's cells onto its board (no validity check).

    Args:
      board: [N, 8, 8] uint8.  piece_id, anchor: [N] integer (anchor = the
        flat cell row * 8 + col).
    Returns:
      [N, 8, 8] uint8.
    """
    occ = tables(board.device).PLACEMENT[piece_id.long(), anchor.long()]
    return board | occ.reshape(board.shape).to(torch.uint8)


def action_mask(all_valid: torch.Tensor, piece_ids: torch.Tensor,
                used: torch.Tensor) -> torch.Tensor:
    """Per-slot action mask [N, 3, 64] bool from `valid_anchors_all_pieces`,
    the current ids [N, 3] and the used flags [N, 3]."""
    return gather_piece_validity(all_valid, piece_ids) & ~used[:, :, None]


def clear_lines(board: torch.Tensor):
    """Clear all complete rows and columns (found on the same snapshot).

    Returns (new_board [N,8,8] uint8, rows_cleared [N] i32, cols_cleared [N] i32).
    """
    filled = board > 0
    rows_full = filled.all(dim=2)  # [N, 8]
    cols_full = filled.all(dim=1)  # [N, 8]
    keep = ~(rows_full[:, :, None] | cols_full[:, None, :])
    new_board = torch.where(keep, board, torch.zeros_like(board))
    return (
        new_board,
        rows_full.sum(dim=1, dtype=torch.int32),
        cols_full.sum(dim=1, dtype=torch.int32),
    )


def count_holes(board: torch.Tensor) -> torch.Tensor:
    """Empty cells whose 4 orthogonal neighbours are filled or off-board. [N] i32."""
    filled = board > 0
    padded = torch.nn.functional.pad(filled, (1, 1, 1, 1), value=True)
    up = padded[:, :-2, 1:-1]
    down = padded[:, 2:, 1:-1]
    left = padded[:, 1:-1, :-2]
    right = padded[:, 1:-1, 2:]
    holes = (~filled) & up & down & left & right
    return holes.sum(dim=(1, 2), dtype=torch.int32)


def clear_lines_flat(flat: torch.Tensor) -> torch.Tensor:
    """Line clear on flat boards of any leading shape ([..., 64] -> [..., 64],
    same dtype)."""
    lead = flat.shape[:-1]
    g = (flat > 0).reshape(*lead, BOARD_SIZE, BOARD_SIZE)
    rows_full = g.all(dim=-1)
    cols_full = g.all(dim=-2)
    keep = ~(rows_full[..., :, None] | cols_full[..., None, :])
    return (g & keep).reshape(*lead, NUM_CELLS).to(flat.dtype)


def count_potential_holes(board: torch.Tensor) -> torch.Tensor:
    """Empty cells with >= 3 blocked orthogonal neighbours. [N] i32."""
    filled = board > 0
    padded = torch.nn.functional.pad(filled, (1, 1, 1, 1), value=True).to(torch.int32)
    blocked = (padded[:, :-2, 1:-1] + padded[:, 2:, 1:-1]
               + padded[:, 1:-1, :-2] + padded[:, 1:-1, 2:])
    return ((~filled) & (blocked >= 3)).sum(dim=(1, 2), dtype=torch.int32)


def height_map(board: torch.Tensor) -> torch.Tensor:
    """Per-column height: 8 - topmost filled row, 0 if empty. [N, 8] i32."""
    filled = board > 0
    row_idx = torch.arange(BOARD_SIZE, dtype=torch.int32,
                           device=board.device)[None, :, None]
    top = torch.where(filled, row_idx, BOARD_SIZE).amin(dim=1)
    return torch.where(top < BOARD_SIZE, BOARD_SIZE - top, 0).to(torch.int32)


def bumpiness(board: torch.Tensor) -> torch.Tensor:
    """Sum of |height[i] - height[i+1]|. [N] i32."""
    h = height_map(board)
    return (h[:, 1:] - h[:, :-1]).abs().sum(dim=1, dtype=torch.int32)


def center_openness(board: torch.Tensor) -> torch.Tensor:
    """1 - fill fraction of the inner 4x4. [N] f32."""
    center = board[:, 2:6, 2:6].to(torch.float32)
    return 1.0 - center.sum(dim=(1, 2)) / 16.0


def total_blocks(board: torch.Tensor) -> torch.Tensor:
    """Number of filled cells per board. [N] i32."""
    return (board > 0).sum(dim=(1, 2), dtype=torch.int32)


def decode_action(action: torch.Tensor):
    """Flat action -> (slot, anchor); action = slot*64 + row*8 + col."""
    return action // NUM_CELLS, action % NUM_CELLS


def encode_action(slot, row, col):
    """(slot, row, col) -> flat action."""
    return slot * NUM_CELLS + row * BOARD_SIZE + col
