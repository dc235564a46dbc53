"""Device-resident constant tables derived from the piece catalogue.

Counterpart of `bbx/engine/tables.py`: the NumPy tables of
`bbx_torch.engine.pieces` as tensors on one device, built once per device
and cached.  `tables` holds what the step path and its kernels read;
`dense_tables` holds the dense forms that only the all-pieces validity
product and the dense disjoint oracle read, both off the step path, so a
process that only steps never builds them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import pieces as P

BOARD_SIZE = P.BOARD_SIZE
NUM_CELLS = P.NUM_CELLS
PIECES_PER_TURN = P.PIECES_PER_TURN
NUM_ACTIONS = P.NUM_ACTIONS
NUM_PIECE_TYPES = P.NUM_PIECE_TYPES
MAX_PIECE_CELLS = P.MAX_PIECE_CELLS


@dataclass(frozen=True)
class Tables:
    PIECE_MASKS: torch.Tensor       # [37, 8, 8] f32
    PIECE_NBLOCKS: torch.Tensor     # [37] i32
    ANCHOR_OK: torch.Tensor         # [37, 64] bool
    PLACEMENT: torch.Tensor         # [37, 64, 64] bool
    # Bitboard words ([..., 2] int64, values in [0, 2**32)).
    PLACE_BITS: torch.Tensor        # [37, 64, 2]
    NO_CONFLICT_BITS: torch.Tensor  # [37, 37, 64, 2]
    PIECE_SHIFTS: torch.Tensor      # [37, 9] i64
    ANCHOR_OK_BITS: torch.Tensor    # [37, 2]
    # The same geometry in the CUDA kernels' layouts.
    PLACE_U64: torch.Tensor         # [37, 64] i64 (u64 bit patterns)
    NO_CONFLICT_U64: torch.Tensor   # [37, 37, 64] i64 (u64 bit patterns)
    ANCHOR_OK_U64: torch.Tensor     # [37] i64 (u64 bit patterns)
    PIECE_SHIFTS_I32: torch.Tensor  # [37, 9] i32


@dataclass(frozen=True)
class DenseTables:
    PAIR_CONFLICT: torch.Tensor     # [37, 37, 64, 64] bool
    OCC_T_BF16: torch.Tensor        # [64, 37*64] bf16, transposed occupancy


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tables(device) -> Tables:
    """The constant tables on `device` (built on first use, then cached)."""
    return _tables_on(_canonical(device))


def dense_tables(device) -> DenseTables:
    """The dense tables on `device` (built on first use, then cached)."""
    return _dense_tables_on(_canonical(device))


def _on(device: torch.device, a, dtype) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> Tables:
    def t(a, dtype):
        return _on(device, a, dtype)

    return Tables(
        PIECE_MASKS=t(P.PIECE_MASKS, torch.float32),
        PIECE_NBLOCKS=t(P.PIECE_NBLOCKS, torch.int32),
        ANCHOR_OK=t(P.ANCHOR_OK, torch.bool),
        PLACEMENT=t(P.PLACEMENT, torch.bool),
        PLACE_BITS=t(P.PLACE_BITS.astype("int64"), torch.int64),
        NO_CONFLICT_BITS=t(P.NO_CONFLICT_BITS.astype("int64"), torch.int64),
        PIECE_SHIFTS=t(P.PIECE_SHIFTS, torch.int64),
        ANCHOR_OK_BITS=t(P.ANCHOR_OK_BITS.astype("int64"), torch.int64),
        PLACE_U64=t(P.PLACE_U64, torch.int64),
        NO_CONFLICT_U64=t(P.NO_CONFLICT_U64, torch.int64),
        ANCHOR_OK_U64=t(P.ANCHOR_OK_U64, torch.int64),
        PIECE_SHIFTS_I32=t(P.PIECE_SHIFTS, torch.int32),
    )


@functools.lru_cache(maxsize=None)
def _dense_tables_on(device: torch.device) -> DenseTables:
    return DenseTables(
        PAIR_CONFLICT=_on(device, P.PAIR_CONFLICT, torch.bool),
        OCC_T_BF16=_on(device, P.PLACEMENT.reshape(-1, NUM_CELLS).T, torch.bfloat16),
    )
