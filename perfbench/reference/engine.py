"""The game's rules, plainly: place, clear, score, shaped reward, regen
under the exact solvability verdict, game over and auto-reset.

Boards are dense ([N, 64] bool) and every rule is one tensor expression,
so this file shares no formulation with the bitboard kernels it judges.
What must agree bit for bit with the measured program is fixed by the
game, not by an implementation: the rules themselves, the draws (the
fleet's `torch.Generator`, drawn in the order the game draws: the fresh
triples at reset, then each step one regen seed and, with auto-reset, the
fresh triples of every lane), the regen hash of (seed, lane, attempt), and
the shaped reward's float32 sum, added left to right.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from .pieces import BOARD, CELLS, NUM_PIECES, SLOTS, tables

MAX_REGEN_ATTEMPTS = 100
INVALID_REWARD = -10.0
M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x2C1B3C6D, 0x297A2D39
_SLOT_SALTS = (0x9E3779B9, 0x3C6EF372, 0xDAA66D2B)


@dataclass(frozen=True)
class Rewards:
    """The shaped reward's coefficients (the game's defaults)."""

    line_clear_base: float = 1.0
    block_placed: float = 0.01
    game_over_penalty: float = -1.0
    hole_penalty: float = -0.05
    center_bonus: float = 0.02
    combo_multiplier_bonus: float = 0.5
    survival_bonus: float = 0.001


@dataclass
class Game:
    """N games: the board [N, 64] bool and every per-lane counter."""

    board: torch.Tensor
    ids: torch.Tensor         # [N, 3] int32
    used: torch.Tensor        # [N, 3] bool
    score: torch.Tensor
    streak: torch.Tensor
    moves: torch.Tensor
    lines_total: torch.Tensor
    max_streak: torch.Tensor
    blocks_total: torch.Tensor
    done: torch.Tensor
    prev_holes: torch.Tensor
    prev_center: torch.Tensor  # float32
    ep_return: torch.Tensor    # float32
    ep_len: torch.Tensor

    def repeat(self, width: int) -> "Game":
        """Each lane repeated `width` times in a row."""
        return Game(**{f.name: getattr(self, f.name).repeat_interleave(width, 0)
                       for f in fields(self)})


def mix32(x):
    x = x ^ (x >> 15)
    x = (x * _MIX1) & M32
    x = x ^ (x >> 12)
    x = (x * _MIX2) & M32
    return x ^ (x >> 15)


def regen_draw(seed: torch.Tensor, lanes: torch.Tensor, attempt: int) -> torch.Tensor:
    """Draw `attempt` of each lane's regen under the step's seed: [K, 3]."""
    keys = mix32(mix32(seed.to(torch.int64) & M32) ^ lanes.to(torch.int64))
    k = mix32(keys ^ attempt)
    return torch.stack([(mix32(k ^ s) * NUM_PIECES) >> 32 for s in _SLOT_SALTS],
                       dim=-1).to(torch.int32)


def reset(n: int, gen: torch.Generator, device) -> Game:
    z = torch.zeros(n, dtype=torch.int32, device=device)
    return Game(
        board=torch.zeros((n, CELLS), dtype=torch.bool, device=device),
        ids=torch.randint(0, NUM_PIECES, (n, SLOTS), generator=gen, device=device,
                          dtype=torch.int32),
        used=torch.zeros((n, SLOTS), dtype=torch.bool, device=device),
        score=z, streak=z.clone(), moves=z.clone(), lines_total=z.clone(),
        max_streak=z.clone(), blocks_total=z.clone(),
        done=torch.zeros(n, dtype=torch.bool, device=device), prev_holes=z.clone(),
        prev_center=torch.ones(n, dtype=torch.float32, device=device),
        ep_return=torch.zeros(n, dtype=torch.float32, device=device), ep_len=z.clone())


def validity(board: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[N, 3, 64]: piece ids[n, s] fits at each anchor of board n."""
    tb = tables(board.device)
    occ = tb.placement[ids.long()].float()                       # [N, 3, 64, 64]
    overlap = occ @ board.float()[:, None, :, None]
    return tb.anchor_ok[ids.long()] & (overlap[..., 0] < 0.5)


def clear(board: torch.Tensor):
    """Clear every full row and column of [..., 64] boards at once:
    (cleared boards, rows cleared, columns cleared)."""
    g = board.reshape(*board.shape[:-1], BOARD, BOARD)
    rows = g.all(dim=-1)
    cols = g.all(dim=-2)
    keep = ~(rows[..., :, None] | cols[..., None, :])
    return ((g & keep).reshape(board.shape), rows.sum(-1, dtype=torch.int32),
            cols.sum(-1, dtype=torch.int32))


def solvable(board: torch.Tensor, ids: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """[K]: can the three pieces be placed in some order, with the clears
    between placements?  Pairwise-disjoint placements decide most lanes;
    the rest are searched in full."""
    tb = tables(board.device)
    pid = ids.long()
    v = validity(board, ids)
    c = tb.conflict
    m01 = v[:, 0, :, None] & v[:, 1, None, :] & ~c[pid[:, 0], pid[:, 1]]
    t = torch.bmm(m01.float(), (~c[pid[:, 1], pid[:, 2]]).float()) > 0.5
    ok = (t & v[:, None, 2, :] & ~c[pid[:, 0], pid[:, 2]]).flatten(1).any(1)
    rest = (~ok).nonzero().squeeze(1)
    for start in range(0, rest.numel(), chunk):
        lanes = rest[start:start + chunk]
        ok[lanes] = _solvable_full(board[lanes], pid[lanes])
    return ok


def _solvable_full(board, pid):
    tb = tables(board.device)
    k = board.shape[0]
    ok = torch.zeros(k, dtype=torch.bool, device=board.device)
    for i in range(SLOTS):
        v1 = validity(board, pid[:, i:i + 1].int())[:, 0]                 # [K, a1]
        b1, _, _ = clear(board[:, None, :] | tb.placement[pid[:, i]])      # [K, a1, 64]
        for j in range(SLOTS):
            if j == i:
                continue
            h = 3 - i - j
            occ2 = tb.placement[pid[:, j]]                                 # [K, a2, 64]
            ov2 = torch.bmm(b1.float(), occ2.float().transpose(1, 2))      # [K, a1, a2]
            v2 = tb.anchor_ok[pid[:, j]][:, None, :] & (ov2 < 0.5) & v1[:, :, None]
            b2, _, _ = clear(b1[:, :, None, :] | occ2[:, None])            # [K, a1, a2, 64]
            ov3 = torch.bmm(b2.reshape(k, CELLS * CELLS, CELLS).float(),
                            tb.placement[pid[:, h]].float().transpose(1, 2))
            fits3 = (tb.anchor_ok[pid[:, h]][:, None, :] & (ov3 < 0.5)).any(-1)
            ok = ok | (v2 & fits3.reshape(k, CELLS, CELLS)).flatten(1).any(1)
    return ok


def regen(board, ids, seed, need, lane_base: int = 0):
    """Redraw the triple of each lane in `need`: the first of up to 100
    hashed draws that is solvable, else the 100th."""
    ids = ids.clone()
    todo = need.nonzero().squeeze(1)
    lanes = todo + lane_base
    for attempt in range(MAX_REGEN_ATTEMPTS):
        if todo.numel() == 0:
            break
        draws = regen_draw(seed, lanes, attempt)
        ids[todo] = draws
        ok = solvable(board[todo], draws)
        todo, lanes = todo[~ok], lanes[~ok]
    return ids


def holes(board: torch.Tensor) -> torch.Tensor:
    g = board.reshape(-1, BOARD, BOARD)
    p = torch.nn.functional.pad(g, (1, 1, 1, 1), value=True)
    h = ~g & p[:, :-2, 1:-1] & p[:, 2:, 1:-1] & p[:, 1:-1, :-2] & p[:, 1:-1, 2:]
    return h.sum(dim=(1, 2), dtype=torch.int32)


def center_openness(board: torch.Tensor) -> torch.Tensor:
    g = board.reshape(-1, BOARD, BOARD)[:, 2:6, 2:6].to(torch.float32)
    return 1.0 - g.sum(dim=(1, 2)) / 16.0


def observe(game: Game, valid3=None) -> dict:
    """The network's observation: board [N, 8, 8] f32, the unused pieces'
    masks [N, 3, 8, 8] f32 and the action mask [N, 192] bool."""
    tb = tables(game.board.device)
    if valid3 is None:
        valid3 = validity(game.board, game.ids)
    mask = valid3 & ~game.used[:, :, None] & ~game.done[:, None, None]
    pieces = tb.masks[game.ids.long()] * (~game.used[:, :, None, None]).float()
    return {"board": game.board.reshape(-1, BOARD, BOARD).float(), "pieces": pieces,
            "action_mask": mask.reshape(-1, SLOTS * CELLS)}


def step(game: Game, actions: torch.Tensor, rc: Rewards, gen: torch.Generator,
         auto_reset: bool, lane_base: int = 0):
    """One move in every lane: (new game, obs, reward, game over now, info)."""
    tb = tables(game.board.device)
    n = game.board.shape[0]
    a = actions.long()
    slot, anchor = a // CELLS, a % CELLS
    piece = torch.gather(game.ids, 1, slot[:, None])[:, 0].long()
    occ = tb.placement[piece, anchor]
    slot_used = torch.gather(game.used, 1, slot[:, None])[:, 0]
    valid = (tb.anchor_ok[piece, anchor] & ~(occ & game.board).any(1) & ~slot_used
             & ~game.done)
    cleared, rows, cols = clear(game.board | occ)
    board = torch.where(valid[:, None], cleared, game.board)
    lines = torch.where(valid, rows + cols, 0)
    cleared_any = lines > 0
    streak = torch.where(valid, torch.where(cleared_any, game.streak + 1, 0), game.streak)
    nb = tb.nblocks[piece]
    combo = torch.clamp(lines, max=4)
    points = lines * BOARD * 10 * combo * torch.clamp(streak + 1, max=8)
    gained = torch.where(valid, nb + torch.where(cleared_any, points, 0), 0)
    one_hot = torch.nn.functional.one_hot(slot, SLOTS).bool()
    used = torch.where(valid[:, None], game.used | one_hot, game.used)
    holes_now, center_now = holes(board), center_openness(board)
    need = used.all(1) & valid

    seed = torch.randint(0, 2**32, (), generator=gen, device=board.device,
                         dtype=torch.int64)
    ids = regen(board, game.ids, seed, need, lane_base)
    fresh = (torch.randint(0, NUM_PIECES, (n, SLOTS), generator=gen, device=board.device,
                           dtype=torch.int32) if auto_reset else None)

    used = torch.where(need[:, None], False, used)
    valid3 = validity(board, ids)
    no_moves = ~(valid3 & ~used[:, :, None]).flatten(1).any(1)
    done = torch.where(valid, no_moves, game.done)
    over = valid & no_moves & ~game.done

    f32 = torch.float32
    hole_delta = holes_now - game.prev_holes
    combo_f = combo.to(f32)
    reward = (
        nb.to(f32) * rc.block_placed
        + rc.survival_bonus
        + torch.where(cleared_any,
                      lines.to(f32) * rc.line_clear_base * combo_f
                      + torch.where(combo > 1, (combo_f - 1.0) * rc.combo_multiplier_bonus,
                                    0.0),
                      0.0)
        + torch.where(over, rc.game_over_penalty, 0.0)
        + torch.where(hole_delta > 0, hole_delta.to(f32) * rc.hole_penalty, 0.0)
        + torch.where(center_now >= game.prev_center, rc.center_bonus * 0.1, 0.0)
    )
    reward = torch.where(valid, reward, INVALID_REWARD).to(f32)
    new = Game(
        board=board, ids=ids, used=used, score=game.score + gained,
        streak=streak, moves=game.moves + valid.int(),
        lines_total=game.lines_total + lines,
        max_streak=torch.maximum(game.max_streak, streak),
        blocks_total=game.blocks_total + torch.where(valid, nb, 0), done=done,
        prev_holes=torch.where(valid, holes_now, game.prev_holes),
        prev_center=torch.where(valid, center_now, game.prev_center),
        ep_return=game.ep_return + reward, ep_len=game.ep_len + 1)
    info = {"final_score": new.score, "final_length": new.ep_len,
            "final_lines": new.lines_total, "final_max_combo": new.max_streak,
            "invalid_action": ~valid}
    if auto_reset:
        d = over
        fresh_game = reset_lanes(new, d, fresh)
        valid3 = torch.where(d[:, None, None], tb.anchor_ok[fresh.long()], valid3)
        new = fresh_game
    return new, observe(new, valid3), reward, over, info


def reset_lanes(game: Game, d: torch.Tensor, fresh: torch.Tensor) -> Game:
    """`game` with the lanes in `d` started afresh on the triples `fresh`."""
    def z(x, v):
        return torch.where(d.reshape(-1, *([1] * (x.dim() - 1))), v, x)

    return replace(
        game, board=z(game.board, False), ids=z(game.ids, fresh), used=z(game.used, False),
        score=z(game.score, 0), streak=z(game.streak, 0), moves=z(game.moves, 0),
        lines_total=z(game.lines_total, 0), max_streak=z(game.max_streak, 0),
        blocks_total=z(game.blocks_total, 0), done=torch.zeros_like(game.done),
        prev_holes=z(game.prev_holes, 0), prev_center=z(game.prev_center, 1.0),
        ep_return=z(game.ep_return, 0.0), ep_len=z(game.ep_len, 0))
