"""Piece-triple solvability on bitboards: can all 3 drawn pieces be placed
in some order, with line clears between placements?

Counterpart of `bbx/engine/solvability.py`.  Two tiers, as in `bbx`:
`solvable_disjoint_bits` is sufficient (pairwise-disjoint valid placements
exist, so any order works), `solvable_exact_bits` is the exhaustive search;
``fast | exact`` is the game's predicate.  The dense formulations
`solvable_disjoint` and `solvable_full` (unpacked boards, float32 products
of 0/1 planes, exact) are the test oracles of the verdict, off the step
path.

Boards are two words ``[..., 2]`` int64 holding u32 values (cell i -> word
i // 32, bit i % 32): PyTorch on the CPU has no shifts for unsigned types,
and values below 2**32 keep a signed shift from leaking bit 63.

`valid3_bits`, `solvable_disjoint_bits` and `solvable_exact_bits` dispatch
on the device of their input: the plain PyTorch version below (``*_plain``)
for CPU tensors, the CUDA kernel (`bbx_torch/csrc/`) for CUDA tensors, with
no fallback between the two.  Each counts its kernel launches in its
``launches`` attribute.
"""
from __future__ import annotations

import torch

from ..ops import build
from .kernel import clear_lines_flat
from .tables import MAX_PIECE_CELLS, NUM_CELLS, PIECES_PER_TURN, dense_tables, tables

_M32 = 0xFFFFFFFF
_BYTE = 0xFF


def pack_cells(flat: torch.Tensor) -> torch.Tensor:
    """Pack a trailing [64] bool/int axis into [2] int64 words (u32 values)."""
    b = (flat != 0).to(torch.int64).reshape(*flat.shape[:-1], 2, 32)
    w = torch.arange(32, device=flat.device, dtype=torch.int64)
    return (b << w).sum(dim=-1)


def unpack_cells(bits: torch.Tensor) -> torch.Tensor:
    """[..., 2] words -> [..., 64] bool."""
    w = torch.arange(32, device=bits.device, dtype=torch.int64)
    u = (bits[..., :, None] >> w) & 1
    return u.reshape(*bits.shape[:-1], NUM_CELLS).to(torch.bool)


def board_bits(board: torch.Tensor) -> torch.Tensor:
    """[N, 8, 8] uint8 -> [N, 2] int64 bitboards."""
    return pack_cells(board.reshape(*board.shape[:-2], NUM_CELLS))


def _clear_lines_words(b0: torch.Tensor, b1: torch.Tensor):
    """Zero all complete rows and columns of boards held as two words.

    Word 0 holds rows 0-3 (row r = byte r), word 1 rows 4-7; column c is bit
    c of every byte.
    """
    def rowmask(b):
        m = torch.zeros_like(b)
        for k in range(4):
            full = ((b >> (8 * k)) & _BYTE) == _BYTE
            m = m | torch.where(full, _BYTE << (8 * k), 0)
        return m

    def colbits(b):
        cm = b & (b >> 8)
        cm = cm & (cm >> 16)
        return cm & _BYTE

    colmask = (colbits(b0) & colbits(b1)) * 0x01010101
    return b0 & ~(rowmask(b0) | colmask), b1 & ~(rowmask(b1) | colmask)


def clear_lines_bits(bits: torch.Tensor) -> torch.Tensor:
    """Zero all complete rows and columns of packed boards ([..., 2])."""
    c0, c1 = _clear_lines_words(bits[..., 0], bits[..., 1])
    return torch.stack([c0, c1], dim=-1)


def _shr64(b0: torch.Tensor, b1: torch.Tensor, s: torch.Tensor):
    """Logical right shift by s in [0, 63] of a 64-bit board held as two
    u32 words, carrying bits from word 1 into word 0."""
    big = s >= 32
    sm = torch.where(big, s - 32, s)                 # in [0, 31]
    carry = torch.where(sm > 0, (b1 << ((32 - sm) & 31)) & _M32, 0)
    r0 = torch.where(big, b1 >> sm, (b0 >> sm) | carry)
    r1 = torch.where(big, 0, b1 >> sm)
    return r0, r1


def piece_fit_words(b0: torch.Tensor, b1: torch.Tensor,
                    piece_id: torch.Tensor):
    """Valid-anchor bitmask of one piece per board, by shift-OR dilation:
    ``ANCHOR_OK_BITS[p] & ~OR_o(board >> PIECE_SHIFTS[p, o])``.

    Args:
      b0, b1: board words, shape ``piece_id.shape + extra``.
      piece_id: integer ids, a prefix of the boards' shape.
    Returns:
      (f0, f1) valid-anchor words, same shape as b0/b1.
    """
    tb = tables(b0.device)
    pid = piece_id.long()
    sh = tb.PIECE_SHIFTS[pid]                        # [*pid, 9]
    aok = tb.ANCHOR_OK_BITS[pid]                     # [*pid, 2]
    shape = tuple(pid.shape) + (1,) * (b0.dim() - pid.dim())
    m0 = torch.zeros_like(b0)
    m1 = torch.zeros_like(b1)
    for o in range(MAX_PIECE_CELLS):
        r0, r1 = _shr64(b0, b1, sh[..., o].reshape(shape))
        m0 = m0 | r0
        m1 = m1 | r1
    return (aok[..., 0].reshape(shape) & ~m0,
            aok[..., 1].reshape(shape) & ~m1)


# ---------------------------------------------------------------------------
# K1: valid-anchor masks of the three drawn pieces.
# ---------------------------------------------------------------------------

def valid3_bits_plain(bits: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of `valid3_bits`."""
    k = piece_ids.shape[0]
    b0 = bits[:, None, 0].expand(k, PIECES_PER_TURN)
    b1 = bits[:, None, 1].expand(k, PIECES_PER_TURN)
    f0, f1 = piece_fit_words(b0, b1, piece_ids)
    return unpack_cells(torch.stack([f0, f1], dim=-1))


def valid3_bits(bits: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    """Validity of each drawn piece at every anchor.

    Args:
      bits: [K, 2] int64 boards.
      piece_ids: [K, 3] int32.
    Returns:
      [K, 3, 64] bool.
    """
    if not bits.is_cuda:
        return valid3_bits_plain(bits, piece_ids)
    return _valid3_bits_cuda(bits, piece_ids)


def _valid3_bits_cuda(bits: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    k = bits.shape[0]
    build.require("valid3_bits: bits", bits, torch.int64, (k, 2))
    build.require("valid3_bits: piece_ids", piece_ids, torch.int32,
                  (k, PIECES_PER_TURN))
    tb = tables(bits.device)
    out = torch.empty((k, PIECES_PER_TURN, NUM_CELLS), dtype=torch.bool,
                      device=bits.device)
    err = build.function("valid3")(
        bits.data_ptr(), piece_ids.data_ptr(), tb.PIECE_SHIFTS_I32.data_ptr(),
        tb.ANCHOR_OK_U64.data_ptr(), out.data_ptr(), k,
        build.stream_of(bits))
    build.check("valid3", err)
    valid3_bits.launches += 1
    return out


valid3_bits.launches = 0


# ---------------------------------------------------------------------------
# K2: the disjoint (sufficient) tier.
# ---------------------------------------------------------------------------

def solvable_disjoint_bits_plain(bits: torch.Tensor, piece_ids: torch.Tensor,
                                 valid3: torch.Tensor) -> torch.Tensor:
    """Plain version of `solvable_disjoint_bits`.

    The OR-reduce over first-piece anchors a1 is a boolean matrix product,
    computed as a float32 batched matmul of 0/1 planes (sums <= 64, exact).
    """
    del bits  # the verdict needs only the validity planes
    tb = tables(piece_ids.device)
    pid = piece_ids.long()
    p0, p1, p2 = pid[:, 0], pid[:, 1], pid[:, 2]
    v1b = pack_cells(valid3[:, 1])                        # [K, 2] over a1
    m01 = unpack_cells(tb.NO_CONFLICT_BITS[p0, p1] & v1b[:, None, :])  # [K,a0,a1]
    nc12 = unpack_cells(tb.NO_CONFLICT_BITS[p1, p2])      # [K, a1, a2]
    t = torch.bmm(m01.float(), nc12.float()) > 0.5        # [K, a0, a2]
    nc02 = unpack_cells(tb.NO_CONFLICT_BITS[p0, p2])      # [K, a0, a2]
    hit = (t & nc02 & valid3[:, None, 2, :]).any(dim=2)   # [K, a0]
    return (valid3[:, 0] & hit).any(dim=1)


def solvable_disjoint_bits(bits: torch.Tensor, piece_ids: torch.Tensor,
                           valid3: torch.Tensor) -> torch.Tensor:
    """Do pairwise-disjoint valid anchors of the three pieces exist?

    Args:
      bits: [K, 2] int64 boards.
      piece_ids: [K, 3] int32.
      valid3: [K, 3, 64] bool from `valid3_bits`; on the card 16-byte
        aligned (the kernel reads it in 16-byte loads; the wrapper raises
        ValueError otherwise).
    Returns:
      [K] bool.
    """
    if not bits.is_cuda:
        return solvable_disjoint_bits_plain(bits, piece_ids, valid3)
    return _solvable_disjoint_bits_cuda(bits, piece_ids, valid3)


def _solvable_disjoint_bits_cuda(bits, piece_ids, valid3) -> torch.Tensor:
    k = bits.shape[0]
    build.require("solvable_disjoint_bits: bits", bits, torch.int64, (k, 2))
    build.require("solvable_disjoint_bits: piece_ids", piece_ids, torch.int32,
                  (k, PIECES_PER_TURN))
    build.require("solvable_disjoint_bits: valid3", valid3, torch.bool,
                  (k, PIECES_PER_TURN, NUM_CELLS))
    if valid3.data_ptr() % 16:
        raise ValueError("solvable_disjoint_bits: valid3 must be 16-byte aligned")
    tb = tables(bits.device)
    out = torch.empty(k, dtype=torch.bool, device=bits.device)
    err = build.function("solvable_disjoint")(
        piece_ids.data_ptr(), valid3.data_ptr(), tb.NO_CONFLICT_U64.data_ptr(),
        out.data_ptr(), k, build.stream_of(bits))
    build.check("solvable_disjoint", err)
    solvable_disjoint_bits.launches += 1
    return out


solvable_disjoint_bits.launches = 0


# ---------------------------------------------------------------------------
# K3: the exact tier.
# ---------------------------------------------------------------------------

def solvable_exact_bits_plain(bits: torch.Tensor, piece_ids: torch.Tensor,
                              valid3: torch.Tensor) -> torch.Tensor:
    """Plain version of `solvable_exact_bits`: every order, every (a1, a2)
    pair evaluated in full as [K, 64, 64] word planes."""
    tb = tables(bits.device)
    pid = piece_ids.long()
    pb = tb.PLACE_BITS[pid]                               # [K, 3, 64, 2]
    pb0, pb1 = pb[..., 0], pb[..., 1]                     # [K, 3, 64]
    ok = torch.zeros(bits.shape[0], dtype=torch.bool, device=bits.device)
    for i in range(3):
        # Boards after piece i at every anchor, clears applied.
        s1_0, s1_1 = _clear_lines_words(bits[:, None, 0] | pb0[:, i],
                                        bits[:, None, 1] | pb1[:, i])  # [K, a1]
        for j in range(3):
            if j == i:
                continue
            h = 3 - i - j
            f2_0, f2_1 = piece_fit_words(s1_0, s1_1, pid[:, j])
            v2 = unpack_cells(torch.stack([f2_0, f2_1], -1))  # [K, a1, a2]
            s2_0, s2_1 = _clear_lines_words(
                s1_0[:, :, None] | pb0[:, j][:, None, :],
                s1_1[:, :, None] | pb1[:, j][:, None, :],
            )                                                 # [K, a1, a2]
            f3_0, f3_1 = piece_fit_words(s2_0, s2_1, pid[:, h])
            fits3 = (f3_0 | f3_1) != 0
            ok = ok | (valid3[:, i][:, :, None] & v2 & fits3).any(dim=(1, 2))
    return ok


def solvable_exact_bits(bits: torch.Tensor, piece_ids: torch.Tensor,
                        valid3: torch.Tensor) -> torch.Tensor:
    """Exact solvability by exhaustive search (all 6 orders, all anchor
    pairs, line clears simulated between placements).

    Args:
      bits: [K, 2] int64 boards.
      piece_ids: [K, 3] int32.
      valid3: [K, 3, 64] bool from `valid3_bits` (stage 1's masks; stages
        2 and 3 come from the board); on the card 16-byte aligned (the
        kernel reads it in 16-byte loads; the wrapper raises ValueError
        otherwise).
    Returns:
      [K] bool.
    """
    if not bits.is_cuda:
        return solvable_exact_bits_plain(bits, piece_ids, valid3)
    return _solvable_exact_bits_cuda(bits, piece_ids, valid3)


def _solvable_exact_bits_cuda(bits, piece_ids, valid3) -> torch.Tensor:
    k = bits.shape[0]
    build.require("solvable_exact_bits: bits", bits, torch.int64, (k, 2))
    build.require("solvable_exact_bits: piece_ids", piece_ids, torch.int32,
                  (k, PIECES_PER_TURN))
    build.require("solvable_exact_bits: valid3", valid3, torch.bool,
                  (k, PIECES_PER_TURN, NUM_CELLS))
    if valid3.data_ptr() % 16:
        raise ValueError("solvable_exact_bits: valid3 must be 16-byte aligned")
    tb = tables(bits.device)
    out = torch.empty(k, dtype=torch.bool, device=bits.device)
    err = build.function("solvable_exact")(
        bits.data_ptr(), piece_ids.data_ptr(), valid3.data_ptr(),
        tb.PLACE_U64.data_ptr(), tb.PIECE_SHIFTS_I32.data_ptr(),
        tb.ANCHOR_OK_U64.data_ptr(), out.data_ptr(), k,
        build.stream_of(bits))
    build.check("solvable_exact", err)
    solvable_exact_bits.launches += 1
    return out


solvable_exact_bits.launches = 0


# ---------------------------------------------------------------------------
# Dense oracles (`bbx/engine/solvability.py:286,337`).
# ---------------------------------------------------------------------------

def solvable_disjoint(valid3: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    """Sufficient check: three pairwise-disjoint valid placements exist.

    Args:
      valid3: [N, 3, 64] bool validity of each drawn piece on the board.
      piece_ids: [N, 3] int32.
    Returns:
      [N] bool.
    """
    tb = dense_tables(piece_ids.device)
    pid = piece_ids.long()
    p0, p1, p2 = pid[:, 0], pid[:, 1], pid[:, 2]
    v0, v1, v2 = valid3[:, 0], valid3[:, 1], valid3[:, 2]
    m01 = v0[:, :, None] & v1[:, None, :] & ~tb.PAIR_CONFLICT[p0, p1]
    nc12 = ~tb.PAIR_CONFLICT[p1, p2]
    t = torch.bmm(m01.float(), nc12.float())                 # [N, a0, a2]
    ok = (t > 0.5) & v2[:, None, :] & ~tb.PAIR_CONFLICT[p0, p2]
    return ok.any(dim=2).any(dim=1)


def _valid_on_flat(flat: torch.Tensor, piece_id: torch.Tensor) -> torch.Tensor:
    """Validity [N, 64] of one piece per flat board [N, 64]."""
    tb = tables(flat.device)
    pid = piece_id.long()
    overlap = torch.bmm(tb.PLACEMENT[pid].float(), flat.float()[:, :, None])[..., 0]
    return tb.ANCHOR_OK[pid] & (overlap < 0.5)


def solvable_full(board: torch.Tensor, piece_ids: torch.Tensor) -> torch.Tensor:
    """Exact check with simulated line clears between placements: for each
    ordered (first, second) slot pair, place the first piece at every
    anchor and clear, place the second at every anchor and clear, and ask
    whether the third piece has any valid anchor left.  Evaluated in full
    ([N, 64, 64, 64] overlap counts per order).

    Args:
      board: [N, 8, 8] uint8.
      piece_ids: [N, 3] int32.
    Returns:
      [N] bool.
    """
    tb = tables(board.device)
    n = board.shape[0]
    pid = piece_ids.long()
    flat = board.reshape(n, NUM_CELLS).to(torch.uint8)
    ok = torch.zeros(n, dtype=torch.bool, device=board.device)
    for i in range(3):
        p = pid[:, i]
        v1 = _valid_on_flat(flat, p)                               # [N, a1]
        b1 = clear_lines_flat(flat[:, None, :] | tb.PLACEMENT[p].to(torch.uint8))
        rest = [j for j in range(3) if j != i]
        for j in rest:
            k = rest[0] if rest[1] == j else rest[1]
            q, r = pid[:, j], pid[:, k]
            occ2 = tb.PLACEMENT[q]                                 # [N, a2, 64]
            ov2 = torch.bmm(b1.float(), occ2.float().transpose(1, 2))  # [N, a1, a2]
            v2 = tb.ANCHOR_OK[q][:, None, :] & (ov2 < 0.5) & v1[:, :, None]
            b2 = clear_lines_flat(b1[:, :, None, :] | occ2[:, None].to(torch.uint8))
            ov3 = torch.bmm(b2.reshape(n, NUM_CELLS * NUM_CELLS, NUM_CELLS).float(),
                            tb.PLACEMENT[r].float().transpose(1, 2))
            ov3 = ov3.reshape(n, NUM_CELLS, NUM_CELLS, NUM_CELLS)  # [N, a1, a2, a3]
            fits3 = (tb.ANCHOR_OK[r][:, None, None, :] & (ov3 < 0.5)).any(dim=3)
            ok = ok | (v2 & fits3).any(dim=2).any(dim=1)
    return ok
