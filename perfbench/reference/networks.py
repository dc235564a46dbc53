"""The two networks, plainly, in float32 (or, for the control, with every
product's operands rounded to fp8).

Each takes its weights as a dict under the parameter names of the
configuration's network (the harness draws them from the seed and hands
the same dict to both sides) and computes, from the observation:

* the afterstate network: all 192 post-move boards of each observation
  (piece shifted to the anchor, cells off the board dropped, full rows and
  columns cleared at once), each scored by one small CNN with three
  per-move features and a context of the other two pieces; the scores are
  the logits.  A separate CNN gives the value.
* the flat CNN: a residual CNN over the board and piece planes, BatchNorm
  as Flax computes it (E[x^2] - E[x]^2, eps 1e-5, running statistics moved
  0.9 / 0.1 in train mode), dropout 0.1 after each dense layer of the trunk
  in train mode, then policy and value heads.

Invalid actions get the logit -1e9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .pieces import BOARD, CELLS, SLOTS

MASKED = -1e9
BN_EPS = 1e-5
DROPOUT = 0.1
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 type under one per-tensor scale, in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class Fp8(torch.autograd.Function):
    """An fp8 training step's rounding: the forward's operand to e4m3, the
    gradient that flows back through it to e5m2, each under a per-tensor
    scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return Fp8.apply(x)


class Precision:
    """Where the products' operands are rounded: nowhere (float32) or to
    fp8 (the control)."""

    def __init__(self, low: bool = False):
        self.low = low

    def q(self, x):
        return fp8(x) if self.low else x

    def conv(self, x, w, b):
        return F.conv2d(self.q(x), self.q(w), b, padding=1)

    def dense(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b)


def _shift_matrix(device) -> torch.Tensor:
    """[64 anchors, 64 cells, 64 cells]: cell (r, c) of a piece plane to
    cell (r + ar, c + ac), 0 where it leaves the board."""
    m = torch.zeros(CELLS, CELLS, CELLS)
    for a in range(CELLS):
        ar, ac = divmod(a, BOARD)
        for r in range(BOARD - ar):
            for c in range(BOARD - ac):
                m[a, r * BOARD + c, (r + ar) * BOARD + c + ac] = 1.0
    return m.to(device)


_SHIFTS = {}


def afterstates(board: torch.Tensor, pieces: torch.Tensor):
    """(planes [B * 192, 2, 8, 8]: post-clear board and the placed piece;
    feats [B * 192, 3]: lines / 4, lines > 0, blocks placed / 5)."""
    dev = board.device
    if dev not in _SHIFTS:
        _SHIFTS[dev] = _shift_matrix(dev)
    b = board.shape[0]
    placed = torch.einsum("bsi,aij->bsaj", pieces.reshape(b, SLOTS, CELLS), _SHIFTS[dev])
    placed = placed.reshape(b * SLOTS * CELLS, BOARD, BOARD)
    pre = torch.clamp(board.repeat_interleave(SLOTS * CELLS, 0) + placed, 0.0, 1.0)
    rows = (pre > 0.5).all(dim=2)
    cols = (pre > 0.5).all(dim=1)
    after = pre * (~(rows[:, :, None] | cols[:, None, :])).float()
    lines = (rows.sum(1) + cols.sum(1)).float()
    feats = torch.stack([lines * 0.25, (lines > 0).float(), placed.sum((1, 2)) * 0.2], 1)
    return torch.stack([after, placed], 1), feats


def afterstate_forward(p: dict, board, pieces, mask, prec: Precision):
    """The afterstate network: (masked logits [B, 192], value [B])."""
    b = board.shape[0]
    planes, feats = afterstates(board, pieces)
    e = prec.dense(pieces.reshape(b, SLOTS, CELLS), p["ctx.weight"], p["ctx.bias"])
    ctx = (e.sum(1, keepdim=True) - e).repeat_interleave(CELLS, 1).reshape(b * SLOTS * CELLS, -1)
    x = planes
    for i in range(2):
        x = F.relu(prec.conv(x, p[f"evaluator.convs.{i}.weight"], p[f"evaluator.convs.{i}.bias"]))
    x = torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), feats, ctx], 1)
    x = F.relu(prec.dense(x, p["evaluator.dense0.weight"], p["evaluator.dense0.bias"]))
    logits = prec.dense(x, p["evaluator.dense1.weight"], p["evaluator.dense1.bias"])
    logits = torch.where(mask, logits.reshape(b, SLOTS * CELLS), MASKED)
    return logits, afterstate_value(p, board, pieces, prec)


def afterstate_value(p: dict, board, pieces, prec: Precision):
    x = torch.cat([board[:, None], pieces], 1)
    for i in range(2):
        x = F.relu(prec.conv(x, p[f"value_convs.{i}.weight"], p[f"value_convs.{i}.bias"]))
    x = F.relu(prec.dense(x.reshape(x.shape[0], -1), p["value_dense0.weight"],
                          p["value_dense0.bias"]))
    return prec.dense(x, p["value_dense1.weight"], p["value_dense1.bias"])[:, 0]


class FlatState:
    """The flat CNN's running BatchNorm statistics and its dropout
    generator, which move as the network runs."""

    def __init__(self, buffers: dict, dropout_gen):
        self.stats = {k: v.clone() for k, v in buffers.items()}
        self.gen = dropout_gen


def _norm(p, s: FlatState, name, x, train):
    if train:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            for key, v in (("running_mean", mean), ("running_var", var)):
                s.stats[f"{name}.{key}"] = 0.9 * s.stats[f"{name}.{key}"] + 0.1 * v.detach()
    else:
        mean, var = s.stats[f"{name}.running_mean"], s.stats[f"{name}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] + p[f"{name}.bias"][:, None, None]


def _flat_trunk(p, s: FlatState, board, pieces, train, prec: Precision):
    x = torch.cat([board[:, None], pieces], 1)
    for i in range(3):
        x = F.relu(_norm(p, s, f"norms.{i}",
                         prec.conv(x, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"]), train))
        if i > 0:
            blk = f"blocks.{i - 1}"
            y = F.relu(_norm(p, s, f"{blk}.norm0", prec.conv(
                x, p[f"{blk}.conv0.weight"], p[f"{blk}.conv0.bias"]), train))
            y = _norm(p, s, f"{blk}.norm1", prec.conv(
                y, p[f"{blk}.conv1.weight"], p[f"{blk}.conv1.bias"]), train)
            x = F.relu(y + x)
    x = x.reshape(x.shape[0], -1)
    for i in range(2):
        x = F.relu(prec.dense(x, p[f"fc.{i}.weight"], p[f"fc.{i}.bias"]))
        if train:
            keep = torch.rand(x.shape, generator=s.gen, device=x.device) < 1.0 - DROPOUT
            x = torch.where(keep, x / (1.0 - DROPOUT), 0.0)
    return x


def _flat_value(p, x, prec):
    v = F.relu(prec.dense(x, p["value_hidden.weight"], p["value_hidden.bias"]))
    return prec.dense(v, p["value_out.weight"], p["value_out.bias"])[:, 0]


def flat_forward(p: dict, s: FlatState, board, pieces, mask, train: bool, prec: Precision):
    """The flat CNN: (masked logits [B, 192], value [B])."""
    x = _flat_trunk(p, s, board, pieces, train, prec)
    h = F.relu(prec.dense(x, p["policy_hidden.weight"], p["policy_hidden.bias"]))
    logits = prec.dense(h, p["policy_out.weight"], p["policy_out.bias"])
    return torch.where(mask, logits, MASKED), _flat_value(p, x, prec)


def flat_value(p: dict, s: FlatState, board, pieces, prec: Precision):
    """The value alone, in eval mode (what the one-ply search reads)."""
    return _flat_value(p, _flat_trunk(p, s, board, pieces, False, prec), prec)


class Net:
    """One of the two networks behind one interface: `forward(board,
    pieces, mask, train)` and `value(board, pieces)` (eval mode)."""

    def __init__(self, kind: str, params: dict, buffers: dict, dropout_gen, prec: Precision):
        self.kind, self.p, self.prec = kind, params, prec
        self.state = FlatState(buffers, dropout_gen) if kind == "cnn" else None

    def forward(self, board, pieces, mask, train: bool):
        if self.kind == "afterstate":
            return afterstate_forward(self.p, board, pieces, mask, self.prec)
        return flat_forward(self.p, self.state, board, pieces, mask, train, self.prec)

    def value(self, board, pieces):
        if self.kind == "afterstate":
            return afterstate_value(self.p, board, pieces, self.prec)
        return flat_value(self.p, self.state, board, pieces, self.prec)
