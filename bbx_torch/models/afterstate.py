"""Afterstate policy/value network.

Counterpart of `bbx/models/afterstate.py`.  The forward pass

  1. expands the observation into all 192 post-move boards with a fixed,
     parameter-free map (shift -> union -> simultaneous row/col clears):
     `afterstate_planes`, the CUDA kernel K4 on the card;
  2. scores every afterboard with one shared evaluator (small CNN + per-move
     scalar features + a remaining-pieces context),
     `evaluator_scores_autograd`: on the card the fused CUDA kernel K8, and
     with gradients on its backward kernels, which recompute the
     activations (bbx's ``nn.remat``); on the CPU the plain evaluator,
     under activation checkpointing when gradients are on;
  3. returns those scores as the 192 policy logits (masked), plus a value
     head on the current state.

K4 writes the planes in ``compute_dtype`` in bbx's stack order, [B, 192,
8, 8, 2], with the three per-move features beside them, so the forward
casts no plane and builds no float32 feature tensor.  K8 reads them and
the [B, 3, D] context as they are.  The plain evaluator runs
channels-last: its input is a view of K4's planes, and conv2's output
flattens in (h, w, c) order as a view, Flax's order, so `evaluator.dense0`
keeps Flax's rows.  The value head runs NCHW; weights converted from Flax
(`bbx_torch.models.convert`) have its Dense rows after the flatten permuted
from NHWC to NCHW order once.  Parameters are float32; each layer casts its
input and weights to ``compute_dtype`` (bf16 or f32), as Flax's ``dtype=``
does, and the evaluator's last Dense emits the compute type before the
float32 cast.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..ops import build
from .distributions import mask_logits
from .flops import conv_layer, dense_flops, evaluator_layers, linear_layer

BOARD = 8
NUM_SLOTS = 3
NUM_ANCHORS = 64
NUM_ACTIONS = NUM_SLOTS * NUM_ANCHORS
NUM_FEATS = 3  # K4's per-move features: lines / 4, lines > 0, nblocks / 5


# ---------------------------------------------------------------------------
# K4: the afterstate expansion.
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)
_PLANES_PER_LANE = NUM_ACTIONS * BOARD * BOARD * 2
_PLANE_STRIDES = (_PLANES_PER_LANE, BOARD * BOARD * 2, BOARD * 2, 2, 1)
_FEAT_STRIDES = (NUM_ACTIONS * NUM_FEATS, NUM_FEATS, 1)


def _expand_plain(board: torch.Tensor, pieces: torch.Tensor):
    """`bbx`'s `afterstate_planes`, op for op: (after, placed [B,192,8,8]
    float32, lines [B,192] float32, overlap [B,192] bool)."""
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
    return after, placed, lines, overlap


def afterstate_buffer_plain(board: torch.Tensor, pieces: torch.Tensor,
                            dtype: torch.dtype):
    """Plain version of `afterstate_buffer`: `bbx`'s expansion, stack and
    per-move features, op for op, then one cast to `dtype`."""
    after, placed, lines, overlap = _expand_plain(board, pieces)
    planes = torch.stack([after, placed], dim=-1)               # [B,192,8,8,2]
    nblocks = placed.sum(dim=(2, 3))
    # bbx divides by 4 and 5; XLA compiles a division by a constant into a
    # product with its float32 reciprocal (exact for 4; 9 / 5 is then
    # 1.8000001, not 1.7999999), so the products are bbx's arithmetic.
    feats = torch.stack([lines * 0.25, (lines > 0).to(torch.float32),
                         nblocks * 0.2], dim=-1)                # [B, 192, 3]
    return planes.to(dtype), feats.to(dtype), overlap


def afterstate_buffer(board: torch.Tensor, pieces: torch.Tensor,
                      dtype: torch.dtype):
    """The 192 afterstates of each lane as the evaluator's input.

    Args:
      board: [B, 8, 8] float32 0/1.
      pieces: [B, 3, 8, 8] float32 0/1 piece masks anchored at the top-left
        (zeroed for used slots, as `observe` emits them).
      dtype: the evaluator's compute dtype, float32 or bf16.
    Returns:
      planes: [B, 192, 8, 8, 2] `dtype` 0/1 (bbx's stack order, NHWC) --
        channel 0 the post-clear afterboard, channel 1 the shifted piece
        alone (action = slot*64 + r*8 + c); as
        ``planes.view(-1, 8, 8, 2).permute(0, 3, 1, 2)`` the evaluator's
        channels-last [B*192, 2, 8, 8] input, with no copy.
      feats: [B, 192, 3] `dtype` -- lines / 4, lines > 0 and nblocks / 5
        (lines: rows + columns the move clears; nblocks: the placed piece's
        cells on the board), each computed in float32 as bbx computes it
        (a product with 0.25 or the float32 0.2) and then rounded to
        `dtype`.
      overlap: [B, 192] bool -- the placement collides with the board or
        loses cells off its edge.
    On the card the three are views of one buffer that the kernel writes.
    """
    if not board.is_cuda:
        return afterstate_buffer_plain(board, pieces, dtype)
    return _afterstate_buffer_cuda(board, pieces, dtype)


def _afterstate_buffer_cuda(board: torch.Tensor, pieces: torch.Tensor,
                            dtype: torch.dtype):
    b = board.shape[0]
    build.require_many((
        ("afterstate: board", board, torch.float32, (b, BOARD, BOARD)),
        ("afterstate: pieces", pieces, torch.float32, (b, NUM_SLOTS, BOARD, BOARD))))
    if dtype not in _DTYPES:
        raise ValueError(f"afterstate: dtype must be one of {_DTYPES}, got {dtype}")
    # One buffer in `dtype`: the planes, the features, then the overlap
    # bytes (192 a lane, a whole number of elements).
    elem = dtype.itemsize
    n_planes = b * _PLANES_PER_LANE
    n_feats = b * NUM_ACTIONS * NUM_FEATS
    buf = torch.empty(n_planes + n_feats + b * NUM_ACTIONS // elem, dtype=dtype,
                      device=board.device)
    err = build.function("afterstate")(board.data_ptr(), pieces.data_ptr(),
                                       buf.data_ptr(), b, elem,
                                       build.stream_of(board))
    build.check("afterstate", err)
    afterstate_buffer.launches += 1
    planes = buf.as_strided((b, NUM_ACTIONS, BOARD, BOARD, 2), _PLANE_STRIDES)
    feats = buf.as_strided((b, NUM_ACTIONS, NUM_FEATS), _FEAT_STRIDES, n_planes)
    overlap = buf.view(torch.bool).as_strided((b, NUM_ACTIONS), (NUM_ACTIONS, 1),
                                              (n_planes + n_feats) * elem)
    return planes, feats, overlap


afterstate_buffer.launches = 0


def afterstate_planes(board: torch.Tensor, pieces: torch.Tensor):
    """`bbx`'s contract: (after, placed [B,192,8,8] f32, lines [B,192] f32,
    overlap [B,192] bool); after and placed are views of the float32
    planes, lines is 4 x the first feature (exact)."""
    planes, feats, overlap = afterstate_buffer(board, pieces, torch.float32)
    return planes[..., 0], planes[..., 1], feats[..., 0] * 4.0, overlap


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

    def forward(self, boards, feats, ctx, dt):
        # boards: [M, 2, 8, 8] channels-last; feats: [M, 3]; ctx: [M, D];
        # all in dt.
        x = boards
        for conv in self.convs:
            w = conv.weight.to(dt, memory_format=torch.channels_last)
            x = F.relu(F.conv2d(x, w, conv.bias.to(dt), padding=1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c): a view
        x = torch.cat([x, feats, ctx], dim=-1)
        x = F.relu(_dense(x, self.dense0, dt))
        return _dense(x, self.dense1, dt)[:, 0]


# ---------------------------------------------------------------------------
# K8: the evaluator's forward.
# ---------------------------------------------------------------------------

# K8's widths (evaluator.cu): two convolutions of at most 32 channels, a
# hidden width of at most 128 and a context of at most 256.
EVALUATOR_LIMITS = "2 convs, channels <= 32, hidden <= 128, ctx_dim <= 256"


def _plain_inputs(planes, feats, ctx):
    """The plain evaluator's per-afterstate inputs: channels-last boards
    [M, 2, 8, 8] (a view of the planes), features [M, 3], and each lane's
    three context rows repeated over their slot's 64 anchors, [M, D]."""
    m = planes.shape[0] * NUM_ACTIONS
    boards = planes.view(m, BOARD, BOARD, 2).permute(0, 3, 1, 2)
    ctx = ctx.repeat_interleave(NUM_ANCHORS, dim=1)
    return boards, feats.reshape(m, NUM_FEATS), ctx.reshape(m, ctx.shape[-1])


def evaluator_scores_plain(evaluator: "_Evaluator", planes, feats, ctx, dtype):
    """Plain version of `evaluator_scores`: the evaluator module's own
    forward (cuDNN and cuBLAS on the card)."""
    return evaluator(*_plain_inputs(planes, feats, ctx), dtype)


def evaluator_scores(evaluator: "_Evaluator", planes: torch.Tensor,
                     feats: torch.Tensor, ctx: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Every afterstate's score, with no gradient.

    Args:
      evaluator: the network's `_Evaluator` (its float32 parameters).
      planes: [B, 192, 8, 8, 2] and feats: [B, 192, 3], in `dtype`, as
        `afterstate_buffer` writes them.
      ctx: [B, 3, D] `dtype`, each slot's remaining-pieces context.
      dtype: the compute dtype, float32 or bf16.
    Returns:
      scores: [B * 192] `dtype` (action = slot * 64 + anchor).
    On the card this is K8, one fused kernel (and a small one that lays the
    weights out); widths beyond `EVALUATOR_LIMITS` raise there.
    """
    if not planes.is_cuda:
        return evaluator_scores_plain(evaluator, planes, feats, ctx, dtype)
    return _evaluator_scores_cuda(evaluator, planes, feats, ctx, dtype)


def _evaluator_params(evaluator):
    """The evaluator's eight parameters in the kernels' order: conv1's
    weight and bias, conv2's, dense0's, dense1's."""
    convs, d0, d1 = evaluator.convs, evaluator.dense0, evaluator.dense1
    return (convs[0].weight, convs[0].bias, convs[-1].weight, convs[-1].bias,
            d0.weight, d0.bias, d1.weight, d1.bias)


def _evaluator_widths(evaluator, d):
    """The eight float32 parameters of `evaluator`, its widths (c1, c2, h,
    d) and its weight layout's size, or a ValueError beyond K8's limits."""
    convs, d0 = evaluator.convs, evaluator.dense0
    c1 = convs[0].out_channels
    c2 = convs[-1].out_channels
    h = d0.out_features
    size = (build.function("evaluator_layout_size")(c1, c2, h, d)
            if len(convs) == 2 and d0.in_features == 64 * c2 + NUM_FEATS + d else 0)
    if size == 0:
        raise ValueError(f"evaluator: K8 takes {EVALUATOR_LIMITS} and a context of "
                         f"dense0's width; got channels {[c.out_channels for c in convs]}, "
                         f"hidden {h}, dense0 inputs {d0.in_features}, ctx_dim {d}")
    params = _evaluator_params(evaluator)
    build.require_many((f"evaluator: parameter {i}", p, torch.float32, p.shape)
                       for i, p in enumerate(params))
    return params, (c1, c2, h, d), size


def _require_inputs(name, planes, feats, ctx, dtype):
    b, d = planes.shape[0], ctx.shape[-1]
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype must be one of {_DTYPES}, got {dtype}")
    build.require_many((
        (f"{name}: planes", planes, dtype, (b, NUM_ACTIONS, BOARD, BOARD, 2)),
        (f"{name}: feats", feats, dtype, (b, NUM_ACTIONS, NUM_FEATS)),
        (f"{name}: ctx", ctx, dtype, (b, NUM_SLOTS, d))))
    if planes.data_ptr() % 16:
        raise ValueError(f"{name}: planes must be 16-byte aligned")
    return b, d


def _evaluator_scores_cuda(evaluator, planes, feats, ctx, dtype):
    b, d = _require_inputs("evaluator", planes, feats, ctx, dtype)
    params, (c1, c2, h, d), size = _evaluator_widths(evaluator, d)
    layout = torch.empty(size, dtype=dtype, device=planes.device)
    scores = torch.empty(b * NUM_ACTIONS, dtype=dtype, device=planes.device)
    err = build.function("evaluator")(
        planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(),
        *(p.data_ptr() for p in params), layout.data_ptr(), scores.data_ptr(),
        b, c1, c2, h, d, dtype.itemsize, build.stream_of(planes))
    build.check("evaluator", err)
    evaluator_scores.launches += 1
    return scores


evaluator_scores.launches = 0


# ---------------------------------------------------------------------------
# K8's backward: the evaluator's gradients under recompute.
# ---------------------------------------------------------------------------

def evaluator_grads_plain(evaluator: "_Evaluator", planes: torch.Tensor,
                          feats: torch.Tensor, ctx: torch.Tensor,
                          dscores: torch.Tensor, dtype: torch.dtype,
                          masks: Optional[dict] = None):
    """Plain version of K8's backward (`_evaluator_grads_cuda`): the same
    function with K8's rounding points, in tensor ops.  The forward is
    recomputed as K8 computes it -- each layer's sum (float32 in bf16,
    float64 in float32) plus its bias, ReLU, rounded once to `dtype` --
    then dz0, da2 and da1 are rounded to `dtype` before the next product,
    each parameter's gradient is a float32 sum rounded once to `dtype`,
    and the context's gradient is each (lane, slot)'s dz0 sum times
    dense0's context columns.  Returns (dctx [B, 3, D] `dtype`, the eight
    parameters' gradients, float32, the pre-activations {"conv2": [B *
    192, 64 C2] in the flatten order, "dense0": [B * 192, H]} float32).
    Where K8 and the plain evaluator round the forward apart (cuDNN rounds
    a convolution before its bias), a ReLU may flip; this version shares
    K8's ReLU decisions but where a float32 sum lands on the other side of
    a rounding boundary, which flips the next ReLU where its pre-activation
    lies near 0.  `masks`, if given, takes the place of conv2's and
    dense0's ReLU decisions in the backward ({"conv2", "dense0"}, bool, the
    shapes above; the tests pass K8's own, `_GradWork.relu_masks`)."""
    f32 = torch.float32
    acc = torch.float64 if dtype == f32 else f32

    def rnd(x):
        return x.to(dtype).to(f32)

    w1, b1, w2, b2, w0, b0, wd1, bd1 = (rnd(p.detach()) for p in _evaluator_params(evaluator))
    b, d = planes.shape[0], ctx.shape[-1]
    m, c2 = b * NUM_ACTIONS, w2.shape[0]
    x = planes.reshape(m, BOARD, BOARD, 2).permute(0, 3, 1, 2).to(f32)
    a1 = rnd(F.relu(F.conv2d(x.to(acc), w1.to(acc), b1.to(acc), padding=1)))
    z2 = F.conv2d(a1.to(acc), w2.to(acc), b2.to(acc), padding=1)
    a2 = rnd(F.relu(z2))
    flat = a2.permute(0, 2, 3, 1).reshape(m, -1)
    n_flat = flat.shape[1]
    x0 = torch.cat([flat, feats.reshape(m, NUM_FEATS).to(f32),
                    ctx.repeat_interleave(NUM_ANCHORS, dim=1).reshape(m, d).to(f32)], dim=-1)
    z0 = F.linear(x0.to(acc), w0.to(acc), b0.to(acc))
    h = rnd(F.relu(z0))
    masks = masks or {"conv2": flat > 0, "dense0": h > 0}
    ds = dscores.to(f32)
    dz0 = rnd(ds[:, None] * wd1) * masks["dense0"]
    da2 = rnd(dz0 @ w0[:, :n_flat]) * masks["conv2"]
    da2 = da2.reshape(m, BOARD, BOARD, c2).permute(0, 3, 1, 2)
    da1 = rnd(torch.nn.grad.conv2d_input(a1.shape, w2, da2, padding=1)) * (a1 > 0)
    grads = (torch.nn.grad.conv2d_weight(x, w1.shape, da1, padding=1), da1.sum((0, 2, 3)),
             torch.nn.grad.conv2d_weight(a1, w2.shape, da2, padding=1), da2.sum((0, 2, 3)),
             dz0.t() @ x0, dz0.sum(0), (ds[:, None] * h).sum(0)[None], ds.sum()[None])
    slots = dz0.reshape(b, NUM_SLOTS, NUM_ANCHORS, -1).sum(2)
    dctx = (slots @ w0[:, n_flat + NUM_FEATS:]).to(dtype)
    pre = {"conv2": z2.permute(0, 2, 3, 1).reshape(m, -1).to(f32), "dense0": z0.to(f32)}
    return dctx, [rnd(g) for g in grads], pre


class _GradWork:
    """K8's backward at one call: its inputs' pointers, the widths, the
    scratch buffers that `bbx_evaluator_grad_sizes` sizes (the weight
    layout, x0 and dz0 in the compute dtype, the tiles' dz0 sums, K8b's
    block records and K8w's split partials in float32), the outputs, and
    the launch plan (`plan`: K8b's threads a block, resident blocks an SM
    and grid; K8w's ring stages, resident blocks an SM and splits; K8b's
    shared memory, and whether da1 has its own there)."""

    PLAN = ("k8b_threads", "k8b_resident_blocks_per_sm", "k8b_blocks",
            "k8w_stages", "k8w_resident_blocks_per_sm", "k8w_splits",
            "k8b_smem_bytes", "k8b_da1_apart")

    def __init__(self, evaluator, planes, feats, ctx, dscores, dtype):
        b, d = _require_inputs("evaluator backward", planes, feats, ctx, dtype)
        build.require("evaluator backward: dscores", dscores, dtype, (b * NUM_ACTIONS,))
        self.params, (c1, c2, h, d), _ = _evaluator_widths(evaluator, d)
        dev = planes.device
        self.inputs = (planes, feats, ctx, dscores)
        self.widths = (b, c1, c2, h, d, dtype.itemsize)
        self.dctx = torch.zeros((b, NUM_SLOTS, d), dtype=dtype, device=dev)
        sizes = torch.zeros(7 + len(self.PLAN), dtype=torch.int64)
        if b:
            build.check("evaluator_grad_sizes", build.function("evaluator_grad_sizes")(
                *self.widths, sizes.data_ptr()))
        n_layout, n_x0, n_dz0, n_tiles, n_part, n_partw, n_grads = sizes[:7].tolist()
        self.plan = dict(zip(self.PLAN, sizes[7:].tolist()))
        self.layout = torch.empty(n_layout, dtype=dtype, device=dev)
        self.x0 = torch.empty(n_x0, dtype=dtype, device=dev)
        self.dz0 = torch.empty(n_dz0, dtype=dtype, device=dev)
        self.stile = torch.empty(n_tiles, dtype=torch.float32, device=dev)
        self.part = torch.empty(n_part, dtype=torch.float32, device=dev)
        self.partw = torch.empty(n_partw, dtype=torch.float32, device=dev)
        self.flat = torch.zeros(n_grads if b else sum(p.numel() for p in self.params),
                                dtype=torch.float32, device=dev)
        self.stream = build.stream_of(planes)

    def x0_matrix(self):
        """dense0's input as K8b wrote it, [B * 192, kx] (64 C2p conv
        columns in the flatten order with channels padded to 8, the 3
        features, the context, zeros to kx)."""
        return grad_tile_matrix(self.x0, self.widths[0] * NUM_ACTIONS)

    def dz0_matrix(self):
        """dense0's output gradient as K8b wrote it, [B * 192, hk] (H
        padded to 16 with zeros)."""
        return grad_tile_matrix(self.dz0, self.widths[0] * NUM_ACTIONS)

    def relu_masks(self):
        """K8b's ReLU decisions after its run, for `evaluator_grads_plain`:
        {"conv2": [B * 192, 64 C2] bool in the flatten order, where x0's
        a2 is above 0; "dense0": [B * 192, H] bool, where dz0 is not 0
        (dense0's pre-activation above 0, and ds w1 not rounded to 0)}."""
        m, c2, h = self.widths[0] * NUM_ACTIONS, self.widths[2], self.widths[3]
        c2p = (c2 + 7) // 8 * 8
        x0, dz0 = self.x0_matrix(), self.dz0_matrix()
        return {"conv2": x0[:, :64 * c2p].reshape(m, 64, c2p)[:, :, :c2].reshape(m, -1) > 0,
                "dense0": dz0[:, :h] != 0}

    def reduce_plain(self, acc=torch.float64):
        """Plain version of the reduction (`_evaluator_grad_reduce`) on this
        call's block records, K8w's split partials and the tiles' dz0 sums,
        each sum taken in `acc`: (dctx [B, 3, D] in the compute dtype, the
        eight parameters' gradients flat, each rounded once to the compute
        dtype, then widened to float32)."""
        b, c1, c2, h, d, _ = self.widths
        cdt = self.dctx.dtype
        hp, c2p = (h + 7) // 8 * 8, (c2 + 7) // 8 * 8
        size = 19 * c1 + c2 * (9 * c1 + 1) + 2 * h + 1  # a record; dense0's bias at size - 2h - 1
        rec = self.part.view(max(self.plan["k8b_blocks"], 1), -1)[:, :size].to(acc).sum(0)
        kx = self.x0.numel() // max(b * NUM_ACTIONS, 1)
        w0 = self.partw.view(-1, hp, kx).to(acc).sum(0)[:h]
        conv = w0[:, :64 * c2p].reshape(h, 64, c2p)[:, :, :c2].reshape(h, 64 * c2)
        w0 = torch.cat([conv, w0[:, 64 * c2p:64 * c2p + NUM_FEATS + d]], dim=1)
        nb0 = size - 2 * h - 1
        flat = torch.cat([rec[:nb0], w0.reshape(-1), rec[nb0:]]).to(cdt).float()
        slots = self.stile.view(b * NUM_SLOTS, -1, hp).to(acc).sum(1)[:, :h]
        wctx = self.params[4].detach()[:, 64 * c2 + NUM_FEATS:].to(cdt).to(acc)
        return (slots @ wctx).to(cdt).view(b, NUM_SLOTS, d), flat

    def grads(self):
        """The eight parameters' gradients, float32, as views of one buffer."""
        return [g.view(p.shape) for g, p in
                zip(self.flat.split([p.numel() for p in self.params]), self.params)]


def _grad_tile_order(rows: int, t: int, device) -> torch.Tensor:
    """Where afterstate a of row r lies in a [rows][t] block of K8b's tile
    layout: bf16 (t = 32) stores the row's 8-afterstate chunk q at chunk q
    ^ ((r // 2) % 4); float32 (t = 16) in order.  [rows, t] int64."""
    a = torch.arange(t, device=device)
    if t != 32:
        return a.expand(rows, t)
    r = torch.arange(rows, device=device)[:, None]
    return a ^ (((r >> 1) & 3) << 3)


def grad_tile_matrix(buf: torch.Tensor, m: int) -> torch.Tensor:
    """[m, rows] from K8b's tile layout of x0 or dz0 ([m / t][rows][t], t
    = 32 afterstates in bf16 and 16 in float32, chunks permuted in bf16:
    `_grad_tile_order`)."""
    t = 32 if buf.dtype == torch.bfloat16 else 16
    rows = buf.numel() // max(m, 1)
    x = buf.view(m // t, rows, t)
    x = x.gather(2, _grad_tile_order(rows, t, buf.device).expand(m // t, rows, t))
    return x.permute(0, 2, 1).reshape(m, rows)


def grad_tile_layout(matrix: torch.Tensor) -> torch.Tensor:
    """The inverse of `grad_tile_matrix`: [m, rows] (bf16 or float32) into
    K8b's flat tile layout."""
    m, rows = matrix.shape
    t = 32 if matrix.dtype == torch.bfloat16 else 16
    x = matrix.reshape(m // t, t, rows).permute(0, 2, 1)
    out = torch.empty_like(x)
    out.scatter_(2, _grad_tile_order(rows, t, matrix.device).expand(m // t, rows, t), x)
    return out.reshape(-1)


def _evaluator_grad_tiles(w: _GradWork) -> None:
    """K8b (`bbx_evaluator_grad_tiles`): the weight layout, then each
    tile's recompute and backward; x0, dz0, the tiles' dz0 sums and the
    block records."""
    if w.widths[0] == 0:
        return
    planes, feats, ctx, dscores = w.inputs
    err = build.function("evaluator_grad_tiles")(
        planes.data_ptr(), feats.data_ptr(), ctx.data_ptr(), dscores.data_ptr(),
        *(p.data_ptr() for p in w.params), w.layout.data_ptr(), w.x0.data_ptr(),
        w.dz0.data_ptr(), w.stile.data_ptr(), w.part.data_ptr(), *w.widths, w.stream)
    build.check("evaluator_grad_tiles", err)
    _evaluator_grad_tiles.launches += 1


def _evaluator_grad_dense0(w: _GradWork) -> None:
    """K8w (`bbx_evaluator_grad_dense0`): dense0's weight gradient dz0^T
    x0, one float32 partial a split of the tiles."""
    if w.widths[0] == 0:
        return
    err = build.function("evaluator_grad_dense0")(
        w.x0.data_ptr(), w.dz0.data_ptr(), w.partw.data_ptr(), *w.widths, w.stream)
    build.check("evaluator_grad_dense0", err)
    _evaluator_grad_dense0.launches += 1


def _evaluator_grad_reduce(w: _GradWork) -> None:
    """The reduction (`bbx_evaluator_grad_reduce`): the records and
    partials into the gradients, in a fixed order, and the context's
    gradient."""
    if w.widths[0] == 0:
        return
    err = build.function("evaluator_grad_reduce")(
        w.part.data_ptr(), w.partw.data_ptr(), w.stile.data_ptr(), w.layout.data_ptr(),
        w.flat.data_ptr(), w.dctx.data_ptr(), *w.widths, w.stream)
    build.check("evaluator_grad_reduce", err)
    _evaluator_grad_reduce.launches += 1


_evaluator_grad_tiles.launches = 0
_evaluator_grad_dense0.launches = 0
_evaluator_grad_reduce.launches = 0


def _evaluator_grads_cuda(evaluator, planes, feats, ctx, dscores, dtype):
    """The evaluator's gradients from the scores' gradient `dscores` [B *
    192] (`dtype`): (dctx [B, 3, D] `dtype`, the eight parameters'
    gradients, float32, each a float32 sum rounded once to `dtype`).  Three
    launches, each counted by its helper: K8b (`_evaluator_grad_tiles`),
    K8w (`_evaluator_grad_dense0`) and the reduction
    (`_evaluator_grad_reduce`); `csrc/evaluator_backward.cu`."""
    w = _GradWork(evaluator, planes, feats, ctx, dscores, dtype)
    _evaluator_grad_tiles(w)
    _evaluator_grad_dense0(w)
    _evaluator_grad_reduce(w)
    return w.dctx, w.grads()


class EvaluatorFunction(torch.autograd.Function):
    """The evaluator with bbx's ``nn.remat`` semantics on the card: the
    forward is K8 and saves only the inputs (planes, feats, ctx and the
    eight float32 parameters); the backward recomputes the activations and
    differentiates them in K8's backward kernels.  Gradients flow to the
    context and the parameters; the planes and features, which K4 writes,
    carry none (a planes or feats that requires a gradient raises).

    ``apply(evaluator, planes, feats, ctx, dtype, *evaluator_params)``, on
    CUDA tensors only: `evaluator_scores_autograd` dispatches.
    """

    @staticmethod
    def forward(fctx, evaluator, planes, feats, ctx, dtype, *params):
        if fctx.needs_input_grad[1] or fctx.needs_input_grad[2]:
            raise ValueError("evaluator: the planes and features carry no gradient")
        fctx.evaluator, fctx.dtype = evaluator, dtype
        fctx.save_for_backward(planes, feats, ctx, *params)
        return _evaluator_scores_cuda(evaluator, planes, feats, ctx, dtype)

    @staticmethod
    @once_differentiable
    def backward(fctx, dscores):
        planes, feats, ctx = fctx.saved_tensors[:3]
        dctx, grads = _evaluator_grads_cuda(fctx.evaluator, planes, feats, ctx,
                                            dscores.contiguous(), fctx.dtype)
        return (None, None, None, dctx, None, *grads)


def evaluator_scores_autograd(evaluator: "_Evaluator", planes: torch.Tensor,
                              feats: torch.Tensor, ctx: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """Every afterstate's score [B * 192] (`dtype`), differentiable in
    `ctx` and the evaluator's parameters when gradients are on.

    On the card `EvaluatorFunction`: K8, and K8's backward under recompute.
    On the CPU the plain evaluator, under `torch.utils.checkpoint` when
    gradients are on (bbx's ``nn.remat``: the activations are recomputed
    in the backward; the math is unchanged).  Planes or features that
    require a gradient raise on both.
    """
    if planes.requires_grad or feats.requires_grad:
        raise ValueError("evaluator: the planes and features carry no gradient")
    if planes.is_cuda:
        return EvaluatorFunction.apply(evaluator, planes, feats, ctx, dtype,
                                       *_evaluator_params(evaluator))
    if torch.is_grad_enabled():
        return checkpoint(evaluator, *_plain_inputs(planes, feats, ctx), dtype,
                          use_reentrant=False)
    return evaluator_scores(evaluator, planes, feats, ctx, dtype)


class AfterstateNetwork(nn.Module):
    """Policy = learned evaluation of each action's deterministic afterstate.

    ``forward(board [B,8,8], pieces [B,3,8,8], action_mask [B,192] | None)
    -> (logits [B,192] f32, value [B] f32)``; ``value(board, pieces)`` is
    the value alone (what the one-ply search reads).  The network has no
    dropout and no BatchNorm, so train and eval mode are the same function
    and the ``generator`` and ``shard`` arguments that `BlockBlastNetwork`
    takes are unused: each row's outputs depend on that row alone.
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

    def flop_layers(self, batch: int, value_only: bool = False) -> list:
        """The layers' matmul and convolution FLOPs on `batch`
        observations (`bbx_torch.models.flops`): the context embedding, the
        evaluator on the 192 afterstates (recomputed in a gradient step),
        the value head (`value_only`: the value head alone, `value`)."""
        ev = self.evaluator
        value = [*(conv_layer(batch, c, i > 0) for i, c in enumerate(self.value_convs)),
                 linear_layer(batch, self.value_dense0), linear_layer(batch, self.value_dense1)]
        if value_only:
            return value
        return [(dense_flops(batch * NUM_SLOTS, BOARD * BOARD, self.ctx.out_features),
                 False, False),
                *evaluator_layers(batch, [c.out_channels for c in ev.convs],
                                  ev.dense0.out_features, self.ctx.out_features),
                *value]

    def afterstates(self, board: torch.Tensor, pieces: torch.Tensor):
        """The evaluator's inputs: K4's planes [B, 192, 8, 8, 2] and
        features [B, 192, 3], and the [B, 3, D] context, in the compute
        dtype.  `board` and `pieces` are float32 and contiguous."""
        dt = self.compute_dtype
        planes, feats, _ = afterstate_buffer(board, pieces, dt)
        # Remaining-pieces context per slot by the set-sum trick: context of
        # slot s = sum of the three embeddings - e_s.
        e = _dense(pieces.reshape(board.shape[0], NUM_SLOTS, BOARD * BOARD), self.ctx, dt)
        return planes, feats, e.sum(dim=1, keepdim=True) - e

    def value(self, board: torch.Tensor, pieces: torch.Tensor) -> torch.Tensor:
        """The value head alone on the current state: [B] float32, with no
        afterstate expansion (K4) and no evaluator (K8).  `forward`'s value
        is this function's."""
        dt = self.compute_dtype
        b = board.shape[0]
        x = torch.cat([board.to(torch.float32)[:, None],
                       pieces.to(torch.float32)], dim=1)            # [B, 4, 8, 8]
        for conv in self.value_convs:
            x = F.relu(_conv(x, conv, dt))
        x = F.relu(_dense(x.reshape(b, -1), self.value_dense0, dt))
        return _dense(x, self.value_dense1, dt)[:, 0].to(torch.float32)

    def forward(self, board: torch.Tensor, pieces: torch.Tensor,
                action_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del generator, shard  # no dropout, no batch statistics
        dt = self.compute_dtype
        b = board.shape[0]
        board = board.to(torch.float32).contiguous()
        pieces = pieces.to(torch.float32).contiguous()
        planes, feats, ctx = self.afterstates(board, pieces)
        scores = evaluator_scores_autograd(self.evaluator, planes, feats, ctx, dt)
        logits = scores.reshape(b, NUM_ACTIONS).to(torch.float32)
        value = self.value(board, pieces)
        if action_mask is not None:
            logits = mask_logits(logits, action_mask)
        return logits, value
