"""ASCII rendering: counterpart of `bbx/render.py`.

Host-side presentation helpers for the play and eval CLIs.  Boards are
numpy arrays or CPU tensors ([8, 8], nonzero = filled); each string is
byte-equal to bbx's for the same board, ids and flags.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .engine import pieces as P

FILLED = "█"
EMPTY = "·"
GHOST = "○"
BAD = "✗"


def _host(board) -> np.ndarray:
    return np.asarray(board)


def render_board(board, show_coords: bool = True) -> str:
    """Board grid with coordinates."""
    board = _host(board)
    size = board.shape[0]
    lines = []
    if show_coords:
        lines.append("  " + " ".join(str(i) for i in range(size)))
        lines.append("  " + "-" * (size * 2 - 1))
    for r in range(size):
        prefix = f"{r}|" if show_coords else ""
        row = " ".join(FILLED if board[r, c] else EMPTY for c in range(size))
        lines.append(prefix + row)
    if show_coords:
        lines.append("  " + "-" * (size * 2 - 1))
    return "\n".join(lines)


def piece_shape_array(piece_id: int) -> np.ndarray:
    """The piece's minimal bounding box as an int8 0/1 array, built from
    its offsets (bbx's `engine/pieces.py:piece_shape_array`)."""
    arr = np.zeros((int(P.PIECE_HEIGHTS[piece_id]), int(P.PIECE_WIDTHS[piece_id])),
                   dtype=np.int8)
    for r, c in P.PIECE_OFFSETS[piece_id]:
        arr[r, c] = 1
    return arr


def render_piece(piece_id: int) -> str:
    """Minimal bounding-box view of one piece."""
    return "\n".join(
        "".join("□" if c else " " for c in row) for row in piece_shape_array(piece_id)
    )


def render_pieces(piece_ids: Sequence[int], used: Sequence[bool]) -> str:
    """The 3 current pieces side by side with used markers."""
    blocks = []
    for i, (pid, u) in enumerate(zip(piece_ids, used)):
        name = P.PIECE_NAMES[pid]
        header = f"[{i}] {name}" + (" (USED)" if u else "")
        art = render_piece(pid) if not u else "(used)"
        blocks.append(header + "\n" + art)
    return "\n\n".join(blocks)


def render_board_with_placement(board, piece_id: int, row: int, col: int) -> str:
    """Ghost preview of a prospective placement (`○` where it fits, `✗`
    on every cell when it does not)."""
    board = _host(board)
    size = board.shape[0]
    ghost = set()
    ok = True
    for dr, dc in P.PIECE_OFFSETS[piece_id]:
        r, c = row + dr, col + dc
        if not (0 <= r < size and 0 <= c < size) or board[r, c]:
            ok = False
        if 0 <= r < size and 0 <= c < size:
            ghost.add((r, c))
    mark = GHOST if ok else BAD
    lines = ["  " + " ".join(str(i) for i in range(size)),
             "  " + "-" * (size * 2 - 1)]
    for r in range(size):
        cells = []
        for c in range(size):
            if (r, c) in ghost and not board[r, c]:
                cells.append(mark)
            else:
                cells.append(FILLED if board[r, c] else EMPTY)
        lines.append(f"{r}|" + " ".join(cells))
    lines.append("  " + "-" * (size * 2 - 1))
    return "\n".join(lines)


def render_game_state(
    board,
    piece_ids: Sequence[int],
    used: Sequence[bool],
    score: int = 0,
    moves: int = 0,
    combo: int = 0,
    game_over: bool = False,
) -> str:
    """Full frame: board, status line and the available pieces."""
    status = "game_over" if game_over else "playing"
    parts = [
        render_board(board),
        f"\nScore: {score} | Moves: {moves} | Combo: {combo} | "
        f"Status: {status}",
        "\nAvailable pieces:",
    ]
    for i, (pid, u) in enumerate(zip(piece_ids, used)):
        tag = "USED" if u else "available"
        parts.append(f"  [{i}] {P.PIECE_NAMES[pid]} ({tag})")
    return "\n".join(parts)
