"""Afterstate policy/value network.

Counterpart of `bbx/models/afterstate.py`.  The forward pass

  1. expands the observation into all 192 post-move boards with a fixed,
     parameter-free map (shift -> union -> simultaneous row/col clears):
     `afterstate_planes`, the CUDA kernel K4 on the card;
  2. scores every afterboard with one shared evaluator (small CNN + per-move
     scalar features + a remaining-pieces context), under activation
     checkpointing when gradients are on (bbx's ``nn.remat``);
  3. returns those scores as the 192 policy logits (masked), plus a value
     head on the current state.

Layouts follow PyTorch (NCHW).  Parameters are float32; each layer casts
its input and weights to ``compute_dtype`` (bf16 or f32), as Flax's
``dtype=`` does, and the evaluator's last Dense emits the compute type
before the float32 cast.  Weights converted from Flax
(`bbx_torch.models.convert`) have the Dense rows that follow a conv flatten
permuted from NHWC to NCHW order, so no activation is transposed here.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import build
from .distributions import mask_logits

BOARD = 8
NUM_SLOTS = 3
NUM_ANCHORS = 64
NUM_ACTIONS = NUM_SLOTS * NUM_ANCHORS
NUM_FEATS = 3  # lines / 4, lines > 0, nblocks / 5 (then the context)


# ---------------------------------------------------------------------------
# K4: the afterstate expansion.
# ---------------------------------------------------------------------------

def afterstate_buffer_plain(board: torch.Tensor, pieces: torch.Tensor):
    """Plain version of `afterstate_buffer`, op for op as `bbx`'s
    `afterstate_planes`."""
    b = board.shape[0]
    # All 64 anchor shifts of each piece plane: pad 7 zeros before each
    # spatial dim; the window starting at (7 - r, 7 - c) is the piece
    # anchored at (r, c).
    padded = F.pad(pieces, (7, 0, 7, 0))                        # [B,3,15,15]
    win = padded.unfold(2, BOARD, 1).unfold(3, BOARD, 1)        # [B,3,8,8,8,8]
    placed = win.flip(2, 3).reshape(b, NUM_ACTIONS, BOARD, BOARD)

    nblocks = pieces.sum(dim=(2, 3))                            # [B, 3]
    kept = placed.sum(dim=(2, 3))                               # [B, 192]
    lost = kept < nblocks.repeat_interleave(NUM_ANCHORS, dim=1)

    board_e = board[:, None]
    collide = (placed * board_e).sum(dim=(2, 3)) > 0
    overlap = collide | lost

    pre = torch.clamp(board_e + placed, 0.0, 1.0)
    row_full = (pre > 0.5).all(dim=3)                           # [B, 192, 8]
    col_full = (pre > 0.5).all(dim=2)                           # [B, 192, 8]
    keep = ~(row_full[:, :, :, None] | col_full[:, :, None, :])
    after = pre * keep.to(pre.dtype)
    lines = (row_full.sum(dim=2) + col_full.sum(dim=2)).to(torch.float32)
    return torch.stack([after, placed], dim=2), lines, overlap


def afterstate_buffer(board: torch.Tensor, pieces: torch.Tensor):
    """The 192 afterstates of each lane in the evaluator's input layout.

    Args:
      board: [B, 8, 8] float32 0/1.
      pieces: [B, 3, 8, 8] float32 0/1 piece masks anchored at the top-left
        (zeroed for used slots, as `observe` emits them).
    Returns:
      planes: [B, 192, 2, 8, 8] float32 -- channel 0 the post-clear
        afterboard, channel 1 the shifted piece alone (action =
        slot*64 + r*8 + c); reshapes without a copy to the evaluator's
        NCHW [B*192, 2, 8, 8] input.
      lines: [B, 192] float32 rows + columns cleared by the move.
      overlap: [B, 192] bool -- the placement collides with the board or
        loses cells off its edge.
    """
    if not board.is_cuda:
        return afterstate_buffer_plain(board, pieces)
    return _afterstate_buffer_cuda(board, pieces)


def _afterstate_buffer_cuda(board: torch.Tensor, pieces: torch.Tensor):
    b = board.shape[0]
    build.require("afterstate: board", board, torch.float32, (b, BOARD, BOARD))
    build.require("afterstate: pieces", pieces, torch.float32,
                  (b, NUM_SLOTS, BOARD, BOARD))
    dev = board.device
    planes = torch.empty((b, NUM_ACTIONS, 2, BOARD, BOARD),
                         dtype=torch.float32, device=dev)
    lines = torch.empty((b, NUM_ACTIONS), dtype=torch.float32, device=dev)
    overlap = torch.empty((b, NUM_ACTIONS), dtype=torch.bool, device=dev)
    err = build.function("afterstate")(
        board.data_ptr(), pieces.data_ptr(), planes.data_ptr(),
        lines.data_ptr(), overlap.data_ptr(), b, build.stream_of(board))
    build.check("afterstate", err)
    afterstate_buffer.launches += 1
    return planes, lines, overlap


afterstate_buffer.launches = 0


def afterstate_planes(board: torch.Tensor, pieces: torch.Tensor):
    """`bbx`'s contract: (after, placed [B,192,8,8], lines [B,192] f32,
    overlap [B,192] bool); after and placed are views of one buffer."""
    planes, lines, overlap = afterstate_buffer(board, pieces)
    return planes[:, :, 0], planes[:, :, 1], lines, overlap


# ---------------------------------------------------------------------------
# The network.
# ---------------------------------------------------------------------------

def _kaiming_uniform_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """variance_scaling(2.0, "fan_in", "uniform"): U(-b, b), b = sqrt(6/fan_in)."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=g)


def _conv(x, layer: nn.Conv2d, dt):
    return F.conv2d(x.to(dt), layer.weight.to(dt), layer.bias.to(dt), padding=1)


def _dense(x, layer: nn.Linear, dt):
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class _Evaluator(nn.Module):
    """Shared per-afterstate scorer: small CNN + scalar features + context."""

    def __init__(self, channels: Sequence[int], hidden: int, feat_dim: int):
        super().__init__()
        chans = [2, *channels]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.dense0 = nn.Linear(chans[-1] * BOARD * BOARD + feat_dim, hidden)
        self.dense1 = nn.Linear(hidden, 1)

    def forward(self, boards, feats, dt):
        # boards: [M, 2, 8, 8]; feats: [M, F]
        x = boards
        for conv in self.convs:
            x = F.relu(_conv(x, conv, dt))
        x = torch.cat([x.reshape(x.shape[0], -1), feats.to(dt)], dim=-1)
        x = F.relu(_dense(x, self.dense0, dt))
        return _dense(x, self.dense1, dt)[:, 0]


class AfterstateNetwork(nn.Module):
    """Policy = learned evaluation of each action's deterministic afterstate.

    ``forward(board [B,8,8], pieces [B,3,8,8], action_mask [B,192] | None)
    -> (logits [B,192] f32, value [B] f32)``.  The network has no dropout
    and no BatchNorm, so train and eval mode are the same function and the
    ``generator`` argument that `BlockBlastNetwork` takes is unused.
    """

    def __init__(self, eval_channels: Sequence[int] = (24, 24),
                 eval_hidden: int = 96, ctx_dim: int = 32,
                 value_channels: Sequence[int] = (48, 64),
                 value_hidden: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ctx = nn.Linear(BOARD * BOARD, ctx_dim)
        self.evaluator = _Evaluator(eval_channels, eval_hidden,
                                    NUM_FEATS + ctx_dim)
        chans = [1 + NUM_SLOTS, *value_channels]
        self.value_convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.value_dense0 = nn.Linear(chans[-1] * BOARD * BOARD, value_hidden)
        self.value_dense1 = nn.Linear(value_hidden, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-uniform weights (ReLU gain) and zero biases, drawn from
        `generator` (a fresh one seeded 0 if None)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                _kaiming_uniform_(w, m.weight[0].numel(), g)
                with torch.no_grad():
                    m.weight.copy_(w)
                    m.bias.zero_()

    def forward(self, board: torch.Tensor, pieces: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del generator  # no dropout
        dt = self.compute_dtype
        b = board.shape[0]
        board = board.to(torch.float32).contiguous()
        pieces = pieces.to(torch.float32).contiguous()
        planes, lines, _ = afterstate_buffer(board, pieces)

        # Remaining-pieces context per slot by the set-sum trick: context of
        # slot s = sum of the three embeddings - e_s.
        e = _dense(pieces.reshape(b, NUM_SLOTS, BOARD * BOARD), self.ctx, dt)
        ctx = e.sum(dim=1, keepdim=True) - e                       # [B, 3, D]
        ctx = ctx.repeat_interleave(NUM_ANCHORS, dim=1)             # [B, 192, D]

        nblocks = planes[:, :, 1].sum(dim=(2, 3))                   # [B, 192]
        feats = torch.cat([
            lines[..., None] / 4.0,
            (lines[..., None] > 0).to(torch.float32),
            nblocks[..., None] / 5.0,
            ctx.to(torch.float32),
        ], dim=-1)                                                  # [B, 192, F]

        m = b * NUM_ACTIONS
        boards = planes.reshape(m, 2, BOARD, BOARD)
        feats = feats.reshape(m, feats.shape[-1])
        if torch.is_grad_enabled():
            # bbx's nn.remat: keep only the evaluator's inputs for the
            # backward and recompute its activations (each conv activation
            # is [B*192, C, 8, 8]); the math is unchanged.
            scores = checkpoint(self.evaluator, boards, feats, dt,
                                use_reentrant=False)
        else:
            scores = self.evaluator(boards, feats, dt)
        logits = scores.reshape(b, NUM_ACTIONS).to(torch.float32)

        # Value head on the current state.
        x = torch.cat([board[:, None], pieces], dim=1)              # [B, 4, 8, 8]
        for conv in self.value_convs:
            x = F.relu(_conv(x, conv, dt))
        x = F.relu(_dense(x.reshape(b, -1), self.value_dense0, dt))
        value = _dense(x, self.value_dense1, dt)[:, 0].to(torch.float32)

        if action_mask is not None:
            logits = mask_logits(logits, action_mask)
        return logits, value
