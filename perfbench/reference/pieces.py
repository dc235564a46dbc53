"""The 37 Block Blast shapes and the dense tables the reference reads.

The shapes and their order are game facts: a piece id is a position in
this list, and the network's inputs and the piece draws are indexed by it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

BOARD = 8
CELLS = 64
SLOTS = 3
ACTIONS = SLOTS * CELLS

# '#' a block, '.' empty, rows separated by '/'.  Order is load-bearing.
SHAPES = (
    "#", "##", "#/#", "#./.#", ".#/#.", "###", "#/#/#", "#../.#./..#",
    "..#/.#./#..", "#./##", "##/.#", "##/#.", ".#/##", "####", "#/#/#/#",
    "#####", "#/#/#/#/#", "##/##", ".#./###", "###/.#.", "#./##/#.",
    ".#/##/.#", ".##/##.", "#./##/.#", "##./.##", ".#/##/#.", "#./#./##",
    "###/#..", "##/.#/.#", "..#/###", ".#/.#/##", "#../###", "##/#./#.",
    "###/..#", "###/###", "##/##/##", "###/###/###",
)
NUM_PIECES = len(SHAPES)


def _cells(art: str):
    return [(r, c) for r, row in enumerate(art.split("/"))
            for c, ch in enumerate(row) if ch == "#"]


def _tables():
    n = NUM_PIECES
    masks = np.zeros((n, BOARD, BOARD), np.float32)
    nblocks = np.zeros(n, np.int32)
    anchor_ok = np.zeros((n, CELLS), bool)
    # shifted[p, a]: the cells of piece p anchored (top-left) at a that lie
    # on the board; for an in-bounds anchor, its whole placement.
    shifted = np.zeros((n, CELLS, CELLS), bool)
    for p, art in enumerate(SHAPES):
        cells = _cells(art)
        nblocks[p] = len(cells)
        h = max(r for r, _ in cells) + 1
        w = max(c for _, c in cells) + 1
        for r, c in cells:
            masks[p, r, c] = 1.0
        for ar in range(BOARD):
            for ac in range(BOARD):
                a = ar * BOARD + ac
                anchor_ok[p, a] = ar + h <= BOARD and ac + w <= BOARD
                for r, c in cells:
                    if ar + r < BOARD and ac + c < BOARD:
                        shifted[p, a, (ar + r) * BOARD + ac + c] = True
    placement = shifted & anchor_ok[:, :, None]
    occ = placement.reshape(n * CELLS, CELLS).astype(np.int32)
    conflict = ((occ @ occ.T) > 0).reshape(n, CELLS, n, CELLS).transpose(0, 2, 1, 3)
    return dict(masks=masks, nblocks=nblocks, anchor_ok=anchor_ok, shifted=shifted,
                placement=placement, conflict=np.ascontiguousarray(conflict))


_NP = _tables()


class Tables:
    """The tables as tensors on one device."""

    def __init__(self, device):
        def t(name, dtype):
            return torch.as_tensor(_NP[name]).to(device=device, dtype=dtype)

        self.masks = t("masks", torch.float32)          # [37, 8, 8]
        self.nblocks = t("nblocks", torch.int32)        # [37]
        self.anchor_ok = t("anchor_ok", torch.bool)     # [37, 64]
        self.shifted = t("shifted", torch.float32)      # [37, 64, 64]
        self.placement = t("placement", torch.bool)     # [37, 64, 64]
        self.conflict = t("conflict", torch.bool)       # [37, 37, 64, 64]


@functools.lru_cache(maxsize=None)
def tables(device) -> Tables:
    return Tables(torch.device(device))
