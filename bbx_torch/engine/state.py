"""Environment state, piece generation and reset.

Counterpart of `bbx/engine/state.py`.  `EnvState` is a dataclass of tensors
with a leading ``[N]`` lane dimension on one device, plus the fleet's
`torch.Generator` (on the same device) that every piece draw comes from.
The draws match `bbx`'s threefry streams in distribution, not bit for bit.

Regen (`regen_pieces`) dispatches on the device of its input: the plain
round loop `regen_pieces_plain` for CPU tensors, the fused CUDA kernel K7
(`csrc/regen.cu`, one block for each chunk of 32 lanes)
for CUDA tensors, counting its launches in ``regen_pieces.launches``.
Its draws are a counter-based hash of (seed, lane, attempt), `regen_draw`,
which both versions compute: one seed per `step` comes from the fleet's
generator as a device tensor, so a resumed generator resumes the draws.

A fleet may be one rank's shard of a fleet sharded over ranks
(`bbx_torch.parallel`): `EnvState.lane_base` is the global index of its
first lane and `EnvState.global_lanes` the global lane count (0 and its own
N for a whole fleet).  Every rank then draws its fresh triples at the
global shape and keeps its rows, and regen hashes the global lane, so rank
r's lanes draw what lanes [lane_base, lane_base + N) draw in one process
and the ranks' generators stay in lockstep.  The hash is a 32-bit xorshift-multiply mix
with multipliers below 2**31, because PyTorch on the CPU has no right
shift for unsigned types and the plain version must keep its int64
products below 2**63; a word becomes a shape by ``(w * 37) >> 32``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..ops import build
from .hashing import lane_keys, mix32
from .kernel import empty_boards
from .solvability import (
    solvable_disjoint_bits_plain,
    solvable_exact_bits_plain,
    valid3_bits_plain,
)
from .tables import NUM_PIECE_TYPES, PIECES_PER_TURN, tables

MAX_REGEN_ATTEMPTS = 100  # reference cap, `engine.py:161`


@dataclass
class EnvState:
    """Batched Block Blast game state ([N] leading dim everywhere)."""

    board: torch.Tensor         # [N, 8, 8] uint8
    piece_ids: torch.Tensor     # [N, 3] int32
    used: torch.Tensor          # [N, 3] bool
    score: torch.Tensor         # [N] int32
    streak: torch.Tensor        # [N] int32 -- consecutive clearing moves
    moves: torch.Tensor         # [N] int32
    lines_total: torch.Tensor   # [N] int32
    max_streak: torch.Tensor    # [N] int32
    blocks_total: torch.Tensor  # [N] int32 -- total blocks placed
    done: torch.Tensor          # [N] bool -- game over
    prev_holes: torch.Tensor    # [N] int32 -- reward-shaping tracker
    prev_center: torch.Tensor   # [N] f32 -- reward-shaping tracker
    ep_return: torch.Tensor     # [N] f32 -- running episode reward
    ep_len: torch.Tensor        # [N] int32
    rng: Optional[torch.Generator]  # the fleet's generator, on its device

    # The fleet's place in a fleet sharded over ranks: the global index of
    # its first lane, and the global lane count (None: its own N).  Plain
    # class attributes, not dataclass fields, which are the per-lane
    # tensors and the generator; `replace` and `step` carry them.
    lane_base = 0
    _global_lanes = None

    @property
    def num_envs(self) -> int:
        return self.board.shape[0]

    @property
    def global_lanes(self) -> int:
        return self._global_lanes or self.num_envs

    @property
    def device(self) -> torch.device:
        return self.board.device

    def sharded(self, lane_base: int, global_lanes: int) -> "EnvState":
        """This state as lanes [lane_base, lane_base + N) of a fleet of
        `global_lanes` (in place; returns self)."""
        if not 0 <= lane_base <= global_lanes - self.num_envs:
            raise ValueError(f"lanes [{lane_base}, {lane_base + self.num_envs}) "
                             f"outside a fleet of {global_lanes}")
        self.lane_base = lane_base
        self._global_lanes = global_lanes
        return self

    def with_shard_of(self, other: "EnvState") -> "EnvState":
        """This state placed where `other` is (in place; returns self)."""
        self.lane_base, self._global_lanes = other.lane_base, other._global_lanes
        return self

    def replace(self, **changes) -> "EnvState":
        return replace(self, **changes).with_shard_of(self)


def make_generator(seed: int, device) -> torch.Generator:
    """The fleet's generator on `device`, seeded."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def _draw(n: int, rng: torch.Generator, device) -> torch.Tensor:
    """n uniform-iid triples of piece ids ([n, 3] int32), as the reference's
    ``rng.choice(37, size=3, replace=True)``."""
    return torch.randint(0, NUM_PIECE_TYPES, (n, PIECES_PER_TURN),
                         generator=rng, device=device, dtype=torch.int32)


def fresh_pieces(n: int, rng: torch.Generator, device, lane_base: int = 0,
                 global_lanes: Optional[int] = None) -> torch.Tensor:
    """Piece draw for an *empty* board: lanes [lane_base, lane_base + n) of
    a draw for `global_lanes` lanes (default n).

    On an empty board every triple of the 37 shapes admits three pairwise-
    disjoint placements (checked exhaustively in the tests), so the retry
    loop would accept the first draw: one unchecked draw is identical.
    """
    if not global_lanes or global_lanes == n:
        return _draw(n, rng, device)
    return _draw(global_lanes, rng, device)[lane_base:lane_base + n]


# ---------------------------------------------------------------------------
# Regen draws: a counter-based hash of (seed, lane, attempt).
# ---------------------------------------------------------------------------

_SLOT_SALTS = (0x9E3779B9, 0x3C6EF372, 0xDAA66D2B)


def _attempt_draws(keys: torch.Tensor, attempt) -> torch.Tensor:
    """Draw `attempt` of each lane key: [..., 3] int32 piece ids, each slot
    word mapped to [0, 37) by ``(w * 37) >> 32`` (bias below 1e-8)."""
    k = mix32(keys ^ attempt)
    slots = [((mix32(k ^ salt) * NUM_PIECE_TYPES) >> 32)
             for salt in _SLOT_SALTS]
    return torch.stack(slots, dim=-1).to(torch.int32)


def regen_draw(seed: torch.Tensor, lane, attempt) -> torch.Tensor:
    """Draw `attempt` of `lane`'s regen event under `seed`: [..., 3] int32
    piece ids, uniform over the 37 shapes, a pure function of its inputs.

    `seed` is an int64 tensor (one per `step`, drawn from the fleet's
    generator); `lane` and `attempt` are integers or int64 tensors that
    broadcast.  Both K7 and `regen_pieces_plain` draw through this
    function, so the two agree bit for bit.
    """
    dev = seed.device
    lane = torch.as_tensor(lane, dtype=torch.int64, device=dev)
    attempt = torch.as_tensor(attempt, dtype=torch.int64, device=dev)
    return _attempt_draws(lane_keys(seed, lane), attempt)


def regen_seed(rng: torch.Generator, device) -> torch.Tensor:
    """The regen seed of one `step`: a 0-dim int64 tensor in [0, 2**32) on
    `device`, drawn from the fleet's generator (no host round trip)."""
    return torch.randint(0, 2**32, (), generator=rng, device=device,
                         dtype=torch.int64)


# ---------------------------------------------------------------------------
# K7: regen.
# ---------------------------------------------------------------------------

def _verdict_plain(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Exact solvability of candidate draws ([M] bool), as `_verdict_flat`
    (`bbx/engine/state.py:83`): the disjoint tier on every candidate, the
    exact tier on the candidates it does not accept (plain K1-K3)."""
    v3 = valid3_bits_plain(bits, ids)
    ok = solvable_disjoint_bits_plain(bits, ids, v3)
    rest = (~ok).nonzero().squeeze(1)
    if rest.numel():
        ok[rest] = solvable_exact_bits_plain(bits[rest], ids[rest], v3[rest])
    return ok


def regen_pieces_plain(bits: torch.Tensor, piece_ids: torch.Tensor,
                       seed: torch.Tensor, need: torch.Tensor, lane_base: int = 0):
    """Plain version of `regen_pieces`: a round loop, each round drawing
    attempt j for every lane still in need (compacted with `nonzero`) and
    keeping the lanes whose draw the verdict rejects."""
    n = bits.shape[0]
    ids = piece_ids.clone()
    attempts = torch.zeros(n, dtype=torch.int32, device=bits.device)
    todo = need.nonzero().squeeze(1)
    keys = lane_keys(seed, todo + lane_base)
    for j in range(MAX_REGEN_ATTEMPTS):
        if todo.numel() == 0:
            break
        draws = _attempt_draws(keys, j)
        ids[todo] = draws
        attempts[todo] = j + 1
        ok = _verdict_plain(bits[todo], draws)
        todo, keys = todo[~ok], keys[~ok]
    return ids, attempts


def regen_pieces(bits: torch.Tensor, piece_ids: torch.Tensor,
                 seed: torch.Tensor, need: torch.Tensor, lane_base: int = 0):
    """Redraw piece triples until solvable, for the lanes in `need`.

    Faithful to the reference's `_generate_new_pieces`: up to
    `MAX_REGEN_ATTEMPTS` iid draws per lane, the first solvable draw (by
    attempt index) wins, and if none passes the 100th draw is kept (the
    game then ends).  Draw j of lane i is ``regen_draw(seed, lane_base + i,
    j)``: `lane_base` is the global index of lane 0 (`EnvState.lane_base`).

    Args:
      bits: [N, 2] int64 bitboards of the new boards (fixed during the
        retry loop).
      piece_ids: [N, 3] int32 (returned untouched where ~need).
      seed: 0-dim int64 tensor on the boards' device (`regen_seed`).
      need: [N] bool.
      lane_base: int, the global index of lane 0.
    Returns:
      (ids [N, 3] int32, attempts [N] int32: the draws each lane used, 0
      where ~need).
    """
    if not bits.is_cuda:
        return regen_pieces_plain(bits, piece_ids, seed, need, lane_base)
    return _regen_pieces_cuda(bits, piece_ids, seed, need, lane_base)


def _regen_pieces_cuda(bits, piece_ids, seed, need, lane_base=0):
    """K7 on the card: one block for each chunk of 32 lanes."""
    n = bits.shape[0]
    seed = seed.reshape(())
    build.require_many((
        ("regen_pieces: bits", bits, torch.int64, (n, 2)),
        ("regen_pieces: piece_ids", piece_ids, torch.int32, (n, PIECES_PER_TURN)),
        ("regen_pieces: need", need, torch.bool, (n,)),
        ("regen_pieces: seed", seed, torch.int64, ())))
    return _launch_regen(bits.data_ptr(), piece_ids.data_ptr(), need.data_ptr(),
                         seed.data_ptr(), n, bits.device, build.stream_of(bits),
                         tables(bits.device), lane_base)


def _launch_regen(bits, piece_ids, need, seed, n, device, stream, tb, lane_base=0):
    """K7 on checked inputs given as device pointers: (ids, attempts)."""
    if lane_base < 0 or lane_base + n >= 2**31:
        raise ValueError(f"regen_pieces: lanes [{lane_base}, {lane_base + n}) outside "
                         "K7's int32 lane index")
    ids = torch.empty((n, PIECES_PER_TURN), dtype=torch.int32, device=device)
    attempts = torch.empty(n, dtype=torch.int32, device=device)
    err = build.function("regen")(
        bits, piece_ids, need, seed, tb.PLACE_U64.data_ptr(),
        tb.PIECE_SHIFTS_I32.data_ptr(), tb.ANCHOR_OK_U64.data_ptr(),
        tb.NO_CONFLICT_U64.data_ptr(), ids.data_ptr(), attempts.data_ptr(), n,
        lane_base, stream)
    build.check("regen", err)
    if n:
        regen_pieces.launches += 1
    return ids, attempts


regen_pieces.launches = 0


def reset(num_envs: int, rng: torch.Generator, device, lane_base: int = 0,
          global_lanes: Optional[int] = None) -> EnvState:
    """Fresh batch of `num_envs` games on `device`: lanes [lane_base,
    lane_base + num_envs) of a fleet of `global_lanes` (default num_envs),
    whose fresh triples are drawn at the global shape."""
    n = num_envs
    z = torch.zeros(n, dtype=torch.int32, device=device)
    state = EnvState(
        board=empty_boards(n, device),
        piece_ids=fresh_pieces(n, rng, device, lane_base, global_lanes),
        used=torch.zeros((n, PIECES_PER_TURN), dtype=torch.bool, device=device),
        score=z,
        streak=z.clone(),
        moves=z.clone(),
        lines_total=z.clone(),
        max_streak=z.clone(),
        blocks_total=z.clone(),
        done=torch.zeros(n, dtype=torch.bool, device=device),
        prev_holes=z.clone(),
        prev_center=torch.ones(n, dtype=torch.float32, device=device),
        ep_return=torch.zeros(n, dtype=torch.float32, device=device),
        ep_len=z.clone(),
        rng=rng,
    )
    return state.sharded(lane_base, global_lanes or n)


def from_components(board, piece_ids, used, score=None, streak=None,
                    moves=None, lines_total=None, max_streak=None,
                    blocks_total=None, done=None, prev_holes=None,
                    prev_center=None, rng=None, *, device) -> EnvState:
    """Build a batched EnvState from raw arrays; unspecified counters
    default to zero (the reference's ``set_state``)."""
    board = torch.as_tensor(board, dtype=torch.uint8, device=device)
    if board.dim() == 2:
        board = board[None]
    n = board.shape[0]

    def arr(x, default, dtype):
        if x is None:
            return torch.full((n,), default, dtype=dtype, device=device)
        return torch.as_tensor(x, dtype=dtype, device=device).reshape(n)

    return EnvState(
        board=board.contiguous(),
        piece_ids=torch.as_tensor(piece_ids, dtype=torch.int32, device=device
                                  ).reshape(n, PIECES_PER_TURN).contiguous(),
        used=torch.as_tensor(used, dtype=torch.bool, device=device
                             ).reshape(n, PIECES_PER_TURN),
        score=arr(score, 0, torch.int32),
        streak=arr(streak, 0, torch.int32),
        moves=arr(moves, 0, torch.int32),
        lines_total=arr(lines_total, 0, torch.int32),
        max_streak=arr(max_streak, 0, torch.int32),
        blocks_total=arr(blocks_total, 0, torch.int32),
        done=arr(done, False, torch.bool),
        prev_holes=arr(prev_holes, 0, torch.int32),
        prev_center=arr(prev_center, 1.0, torch.float32),
        ep_return=torch.zeros(n, dtype=torch.float32, device=device),
        ep_len=torch.zeros(n, dtype=torch.int32, device=device),
        rng=rng,
    )
