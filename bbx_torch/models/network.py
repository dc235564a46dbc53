"""The flat policy/value networks: counterpart of `bbx/models/network.py`.

`BlockBlastNetwork` is a residual CNN over the (board + 3 piece-mask)
planes, a shared fully connected trunk with dropout, and separate policy
(192 masked logits) and value heads; `ActorCritic` is the lighter variant
with separate heads and orthogonal init.  Layouts follow PyTorch (NCHW);
weights converted from Flax (`bbx_torch.models.convert`) have the rows of
the first Dense after the conv flatten permuted from NHWC to NCHW order.
Parameters are float32; each layer computes in ``compute_dtype`` (bf16 by
default), as Flax's ``dtype=`` does.

The norms follow Flax, not `torch.nn`:
  * BatchNorm (`_Norm("batch")`): statistics over (N, H, W) in float32 as
    E[x^2] - E[x]^2 clamped at 0 (Flax's fast variance), eps 1e-5, and in
    train mode the running statistics move by ``0.9 * old + 0.1 * batch``
    with the *biased* batch variance (Flax momentum 0.9 == torch momentum
    0.1, but `torch.nn.BatchNorm2d` would store the unbiased variance);
    eval mode normalises with the running statistics.
  * GroupNorm: ``min(32, C)`` groups, eps 1e-6.
Dropout draws its mask from an explicit `torch.Generator` passed to
`forward` (``F.dropout`` takes none); it is live only in train mode.

Data parallelism (`bbx_torch.parallel`): `forward`'s ``shard`` (a
`BatchShard`) says which rows of a global batch this rank holds.  Train-mode
BatchNorm then takes its mean and E[x^2] over the global batch (the
per-rank sums all-reduced, differentiably, as bbx's cross-replica
BatchNorm reduces over its ``axis_name``), and each dropout mask is drawn
at the global batch's shape and this rank's rows kept.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from .afterstate import _conv, _dense, _kaiming_uniform_
from .distributions import mask_logits
from .flops import conv_layer, linear_layer

BOARD = 8
NUM_ACTIONS = 192
BN_MOMENTUM = 0.9   # Flax's convention: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5
GN_EPS = 1e-6


class _Norm(nn.Module):
    """BatchNorm, GroupNorm or nothing, behind one flag, on NCHW input in
    the compute dtype; returns the compute dtype."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        if kind not in ("batch", "group", "none"):
            raise ValueError(f"norm {kind!r}: expected 'batch', 'group' or 'none'")
        self.kind = kind
        if kind != "none":
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
        self.groups = min(32, channels)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if self.kind == "none":
            return x
        # At least float32, as Flax's `force_float32_reductions` promotes.
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.kind == "group":
            b, c, h, w = xf.shape
            g = xf.reshape(b, self.groups, -1)
            mean = g.mean(dim=2, keepdim=True)
            var = torch.clamp((g * g).mean(dim=2, keepdim=True) - mean * mean, min=0.0)
            y = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(b, c, h, w)
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
            return y.to(x.dtype)
        if self.training:
            if shard is None:
                mean = xf.mean(dim=(0, 2, 3))
                sq = (xf * xf).mean(dim=(0, 2, 3))
            else:
                c = xf.shape[1]
                sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                 (xf * xf).sum(dim=(0, 2, 3))]))
                sums = sums / (shard.total * xf.shape[2] * xf.shape[3])
                mean, sq = sums[:c], sums[c:]
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             shard=None):
    """Flax's Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate), the mask from `generator` (drawn for `shard`'s global
    batch and cut to its rows, where given)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator: pass "
                         "forward(..., generator=...)")
    keep_prob = 1.0 - rate
    shape = x.shape if shard is None else (shard.total, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    if shard is not None:
        keep = shard.take(keep)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _planes(board: torch.Tensor, pieces: torch.Tensor, dt) -> torch.Tensor:
    """[B, 8, 8] board + [B, 3, 8, 8] pieces -> NCHW [B, 4, 8, 8]."""
    return torch.cat([board[:, None].float(), pieces.float()], dim=1).to(dt)


class ResidualBlock(nn.Module):
    """conv3x3 -> norm -> relu -> conv3x3 -> norm -> +x -> relu."""

    def __init__(self, channels: int, norm: str = "batch"):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1)
        self.norm0 = _Norm(norm, channels)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.norm1 = _Norm(norm, channels)

    def forward(self, x: torch.Tensor, dt, shard=None) -> torch.Tensor:
        y = F.relu(self.norm0(_conv(x, self.conv0, dt), shard))
        y = self.norm1(_conv(y, self.conv1, dt), shard)
        return F.relu(y + x)


class BlockBlastNetwork(nn.Module):
    """Shared-trunk policy/value CNN, about 5M parameters at the defaults.

    ``forward(board [B,8,8], pieces [B,3,8,8], action_mask [B,192] | None,
    generator=None, shard=None) -> (logits [B,192] f32, value [B] f32)``;
    `generator` draws the dropout masks and is needed in train mode when
    ``dropout_rate > 0``; `shard` places the B rows in a global batch
    (module docstring).
    """

    def __init__(self, conv_channels: Sequence[int] = (64, 128, 128),
                 fc_hidden: Sequence[int] = (512, 256),
                 action_space_size: int = NUM_ACTIONS,
                 use_residual: bool = True, norm: str = "batch",
                 dropout_rate: float = 0.1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        chans = [4, *conv_channels]
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for cin, cout in zip(chans[:-1], chans[1:]))
        self.norms = nn.ModuleList(_Norm(norm, c) for c in conv_channels)
        self.blocks = nn.ModuleList(
            ResidualBlock(c, norm) for c in (conv_channels[1:] if use_residual else ()))
        widths = [conv_channels[-1] * BOARD * BOARD, *fc_hidden]
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.policy_hidden = nn.Linear(widths[-1], 256)
        self.policy_out = nn.Linear(256, action_space_size)
        self.value_hidden = nn.Linear(widths[-1], 128)
        self.value_out = nn.Linear(128, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-uniform conv and dense weights (ReLU gain) and zero
        biases from `generator` (a fresh one seeded 0 if None).  The norms
        start at scale 1, bias 0, running mean 0 and variance 1."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                _kaiming_uniform_(w, m.weight[0].numel(), g)
                with torch.no_grad():
                    m.weight.copy_(w)
                    m.bias.zero_()

    def _trunk(self, board, pieces, generator, shard=None) -> torch.Tensor:
        dt = self.compute_dtype
        x = _planes(board, pieces, dt)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = F.relu(norm(_conv(x, conv, dt), shard))
            if i > 0 and self.blocks:
                x = self.blocks[i - 1](x, dt, shard)
        x = x.flatten(1)  # a rank may hold no row of a minibatch
        for layer in self.fc:
            x = F.relu(_dense(x, layer, dt))
            if self.training and self.dropout_rate > 0.0:
                x = _dropout(x, self.dropout_rate, generator, shard)
        return x

    def flop_layers(self, batch: int, value_only: bool = False) -> list:
        """The layers' matmul and convolution FLOPs on `batch`
        observations (`bbx_torch.models.flops`), in forward order
        (`value_only`: the trunk and the value head, `value`)."""
        layers = []
        for i, conv in enumerate(self.convs):
            layers.append(conv_layer(batch, conv, i > 0))
            if i > 0 and self.blocks:
                blk = self.blocks[i - 1]
                layers += [conv_layer(batch, blk.conv0), conv_layer(batch, blk.conv1)]
        heads = () if value_only else (self.policy_hidden, self.policy_out)
        return layers + [linear_layer(batch, m) for m in (
            *self.fc, *heads, self.value_hidden, self.value_out)]

    @property
    def lockstep_forward(self) -> bool:
        """Does a train-mode forward couple the batch's rows (BatchNorm) or
        draw dropout masks?  Then every rank runs it, even on no rows, to
        join its reductions and keep its generator in lockstep."""
        return any(n.kind == "batch" for n in self.norms) or (
            self.training and self.dropout_rate > 0.0)

    def _value_head(self, x: torch.Tensor) -> torch.Tensor:
        v = F.relu(_dense(x, self.value_hidden, self.compute_dtype))
        return _dense(v, self.value_out, self.compute_dtype)[:, 0].to(torch.float32)

    def value(self, board: torch.Tensor, pieces: torch.Tensor) -> torch.Tensor:
        """`forward`'s value [B] float32, without the policy head (what the
        one-ply search reads, in eval mode)."""
        return self._value_head(self._trunk(board, pieces, None))

    def forward(self, board: torch.Tensor, pieces: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        x = self._trunk(board, pieces, generator, shard)
        p = F.relu(_dense(x, self.policy_hidden, dt))
        logits = _dense(p, self.policy_out, dt).to(torch.float32)
        value = self._value_head(x)
        if action_mask is not None:
            logits = mask_logits(logits, action_mask)
        return logits, value


class ActorCritic(nn.Module):
    """The lighter separate-head variant: a plain conv stack, then actor and
    critic MLPs, orthogonal init (gain sqrt 2).  No norm and no dropout, so
    train and eval mode are the same function."""

    def __init__(self, conv_channels: Sequence[int] = (32, 64, 64),
                 fc_hidden: int = 256, action_space_size: int = NUM_ACTIONS,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        chans = [4, *conv_channels]
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for cin, cout in zip(chans[:-1], chans[1:]))
        flat = conv_channels[-1] * BOARD * BOARD
        self.actor = nn.ModuleList([nn.Linear(flat, fc_hidden),
                                    nn.Linear(fc_hidden, fc_hidden)])
        self.actor_out = nn.Linear(fc_hidden, action_space_size)
        self.critic = nn.ModuleList([nn.Linear(flat, fc_hidden),
                                     nn.Linear(fc_hidden, fc_hidden)])
        self.critic_out = nn.Linear(fc_hidden, 1)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                with torch.no_grad():
                    nn.init.orthogonal_(m.weight, gain=math.sqrt(2.0), generator=g)
                    m.bias.zero_()

    def flop_layers(self, batch: int) -> list:
        """The layers' matmul and convolution FLOPs on `batch`
        observations (`bbx_torch.models.flops`), in forward order."""
        return [*(conv_layer(batch, c, i > 0) for i, c in enumerate(self.convs)),
                *(linear_layer(batch, m) for m in (*self.actor, self.actor_out,
                                                   *self.critic, self.critic_out))]

    def forward(self, board: torch.Tensor, pieces: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del generator, shard  # no dropout, no batch statistics
        dt = self.compute_dtype
        x = _planes(board, pieces, dt)
        for conv in self.convs:
            x = F.relu(_conv(x, conv, dt))
        x = x.reshape(x.shape[0], -1)
        a = x
        for layer in self.actor:
            a = F.relu(_dense(a, layer, dt))
        logits = _dense(a, self.actor_out, dt).to(torch.float32)
        c = x
        for layer in self.critic:
            c = F.relu(_dense(c, layer, dt))
        value = _dense(c, self.critic_out, dt)[:, 0].to(torch.float32)
        if action_mask is not None:
            logits = mask_logits(logits, action_mask)
        return logits, value


def count_parameters(module: nn.Module) -> int:
    """Total trainable parameter count (buffers such as BatchNorm's running
    statistics excluded, as Flax keeps them out of ``params``)."""
    return sum(p.numel() for p in module.parameters())
