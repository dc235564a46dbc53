"""Parity mode: the port's engine driven by the reference's NumPy RNG.

Counterpart of `bbx/engine/parity.py`.  `ParityEngine` plays one game with
piece draws from ``np.random.default_rng(seed).choice(37, size=3,
replace=True)``, the accept/retry loop of the reference (cap 100, last draw
kept on exhaustion), and placement / clears / scoring through the same
`_move_core` as production.  Two engines given one seed and one move
sequence play the same game, which is how the tests hold the port's step
and regen against `bbx` move for move.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .solvability import (
    board_bits,
    solvable_disjoint_bits,
    solvable_exact_bits,
    valid3_bits,
)
from .state import MAX_REGEN_ATTEMPTS, from_components
from .step import _move_core
from .tables import BOARD_SIZE, NUM_PIECE_TYPES, PIECES_PER_TURN


class ParityEngine:
    """Single game with reference-identical RNG consumption.

    Exposes the reference `GameEngine` observables: board, current piece
    ids, used flags, score, combo_count (streak), moves_made,
    total_lines_cleared, max_combo, total_blocks_placed, game_over.
    """

    def __init__(self, seed: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.reset(seed)

    def reset(self, seed: Optional[int] = None) -> None:
        self.rng = np.random.default_rng(seed)
        self.board = np.zeros((BOARD_SIZE, BOARD_SIZE), np.uint8)
        self.piece_ids = np.zeros(PIECES_PER_TURN, np.int32)
        self.used = np.zeros(PIECES_PER_TURN, bool)
        self.score = 0
        self.combo_count = 0
        self.moves_made = 0
        self.total_lines_cleared = 0
        self.max_combo = 0
        self.total_blocks_placed = 0
        self.game_over = False
        self._generate_new_pieces()
        self._update_game_over()

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                               device=self.device)

    def _generate_new_pieces(self) -> None:
        """iid draws from the PCG64 stream until the exact solvability
        predicate accepts, keeping the last draw after MAX_REGEN_ATTEMPTS
        failures."""
        bits = board_bits(self._tensor(self.board, torch.uint8))
        for _ in range(MAX_REGEN_ATTEMPTS):
            ids = self.rng.choice(NUM_PIECE_TYPES, size=PIECES_PER_TURN,
                                  replace=True)
            self.piece_ids = ids.astype(np.int32)
            self.used = np.zeros(PIECES_PER_TURN, bool)
            tids = self._tensor(self.piece_ids, torch.int32)
            v3 = valid3_bits(bits, tids)
            if bool(solvable_disjoint_bits(bits, tids, v3)[0]) or bool(
                    solvable_exact_bits(bits, tids, v3)[0]):
                return

    def _update_game_over(self) -> None:
        self.game_over = not bool(self.get_action_mask().any())

    def get_action_mask(self) -> np.ndarray:
        """[3, 8, 8] bool."""
        bits = board_bits(self._tensor(self.board, torch.uint8))
        v3 = valid3_bits(bits, self._tensor(self.piece_ids, torch.int32))
        m = v3[0] & ~self._tensor(self.used, torch.bool)[0][:, None]
        return m.cpu().numpy().reshape(PIECES_PER_TURN, BOARD_SIZE, BOARD_SIZE)

    def make_move(self, piece_index: int, row: int, col: int) -> bool:
        """Place a piece; returns success."""
        if self.game_over:
            return False
        state = from_components(
            self.board[None], self.piece_ids[None], self.used[None],
            score=[self.score], streak=[self.combo_count], device=self.device,
        )
        action = piece_index * 64 + row * BOARD_SIZE + col
        (valid, _piece, nblocks, new_board, lines, _rows, _cols, _cleared,
         streak, _mult, gained, used, *_stats) = _move_core(
            state, torch.tensor([action], device=self.device))
        if not bool(valid[0]):
            return False
        self.board = new_board[0].cpu().numpy().astype(np.uint8)
        self.used = used[0].cpu().numpy()
        self.score += int(gained[0])
        self.combo_count = int(streak[0])
        self.max_combo = max(self.max_combo, self.combo_count)
        self.moves_made += 1
        self.total_lines_cleared += int(lines[0])
        self.total_blocks_placed += int(nblocks[0])
        if self.used.all():
            self._generate_new_pieces()
        self._update_game_over()
        return True

    def get_valid_moves(self):
        """(piece, row, col) triples with the mask set."""
        mask = self.get_action_mask()
        return [tuple(int(x) for x in idx) for idx in np.argwhere(mask)]
