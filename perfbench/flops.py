"""The work the benchmark divides by: FLOPs of the networks and bytes of
the evaluator's kernels, from the configuration's widths, and the card's
published peaks.  Frozen here, so that a later change to the measured
program is read against the same work.

Counted as `torch.utils.flop_counter.FlopCounterMode` counts: two a
multiply-add of every convolution and matrix product, nothing for biases,
norms, activations, softmaxes or reductions.  A gradient step is the
forward, each layer's weight gradient and, where the layer's input needs
one, its input gradient, each as costly as the forward.  A recompute of
activations in the backward is not work the model requires and is not
counted.
"""
from __future__ import annotations

from typing import List, Tuple

CELLS = 64
ACTIONS = 192
SLOTS = 3
FEATS = 3

# NVIDIA's H100 SXM data sheet: dense bf16 on the tensor cores, float32 on
# the CUDA cores, HBM3 bandwidth.  By `torch.cuda.get_device_name()`.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12}}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}

Layer = Tuple[int, bool]  # (forward FLOPs, the input needs a gradient)


def conv3x3(rows: int, cin: int, cout: int) -> int:
    """A 3x3 'same' convolution over `rows` 8x8 images."""
    return 2 * rows * CELLS * 9 * cin * cout


def dense(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def _afterstate(net: dict, batch: int, value_only: bool = False) -> List[Layer]:
    c1, c2 = net.get("eval_channels", (24, 24))
    h, d = net.get("eval_hidden", 96), net.get("ctx_dim", 32)
    v1, v2 = net.get("value_channels", (48, 64))
    vh = net.get("value_hidden", 256)
    m = batch * ACTIONS
    value = [(conv3x3(batch, 1 + SLOTS, v1), False), (conv3x3(batch, v1, v2), True),
             (dense(batch, CELLS * v2, vh), True), (dense(batch, vh, 1), True)]
    if value_only:
        return value
    return [(dense(batch * SLOTS, CELLS, d), False), (conv3x3(m, 2, c1), False),
            (conv3x3(m, c1, c2), True), (dense(m, CELLS * c2 + FEATS + d, h), True),
            (dense(m, h, 1), True), *value]


def _cnn(net: dict, batch: int, value_only: bool = False) -> List[Layer]:
    chans = [1 + SLOTS, *net.get("conv_channels", (64, 128, 128))]
    fc = [chans[-1] * CELLS, *net.get("fc_hidden", (512, 256))]
    layers = []
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        layers.append((conv3x3(batch, a, b), i > 0))
        if i > 0 and net.get("use_residual", True):
            layers += [(conv3x3(batch, b, b), True)] * 2
    layers += [(dense(batch, a, b), True) for a, b in zip(fc[:-1], fc[1:])]
    value = [(dense(batch, fc[-1], 128), True), (dense(batch, 128, 1), True)]
    policy = [] if value_only else [(dense(batch, fc[-1], 256), True),
                                    (dense(batch, 256, ACTIONS), True)]
    return layers + policy + value


def layers(net: dict, batch: int, value_only: bool = False) -> List[Layer]:
    """The network's layers on `batch` observations (`value_only`: what
    the value alone runs, as the one-ply search reads it)."""
    kind = _afterstate if net.get("type") == "afterstate" else _cnn
    return kind(net, batch, value_only)


def forward_flops(net: dict, batch: int, value_only: bool = False) -> int:
    return sum(f for f, _ in layers(net, batch, value_only))


def grad_step_flops(net: dict, batch: int) -> int:
    """Forward and backward of one minibatch, no recompute."""
    return sum(f * (2 + int(g)) for f, g in layers(net, batch))


def train_iteration_flops(net: dict, envs: int, steps: int, epochs: int, minibatch: int,
                          search_width: int = 0) -> int:
    """One PPO iteration: the rollout's forward on every step, the last
    value's forward, the search's value on `search_width` simulated lanes
    a lane a step (0 where the iteration does not search), and every
    minibatch's gradient step."""
    rollout = steps * forward_flops(net, envs) + forward_flops(net, envs)
    search = steps * forward_flops(net, envs * search_width, True) if search_width else 0
    return rollout + search + epochs * (envs * steps // minibatch) * grad_step_flops(net, minibatch)


# ---------------------------------------------------------------------------
# The evaluator's kernels, at widths ((C1, C2), H, D).
# ---------------------------------------------------------------------------

def evaluator_widths(net: dict):
    return (tuple(net.get("eval_channels", (24, 24))), net.get("eval_hidden", 96),
            net.get("ctx_dim", 32))


def _evaluator_params(widths) -> int:
    (c1, c2), h, d = widths
    return 18 * c1 + c1 + 9 * c1 * c2 + c2 + (CELLS * c2 + FEATS + d) * h + h + h + 1


def evaluator_forward(lanes: int, widths, elem: int) -> Tuple[int, int]:
    """(operations, bytes) the evaluator's forward requires on `lanes` x
    192 afterstates: the context's part of dense0 once a (lane, slot);
    the planes, features and context read, the scores written, in the
    compute type, the float32 parameters read once."""
    (c1, c2), h, d = widths
    m = lanes * ACTIONS
    ops = (conv3x3(m, 2, c1) + conv3x3(m, c1, c2) + dense(m, CELLS * c2 + FEATS, h)
           + dense(lanes * SLOTS, d, h) + dense(m, h, 1))
    nbytes = (m * (2 * CELLS + FEATS + 1) * elem + lanes * SLOTS * d * elem
              + _evaluator_params(widths) * 4)
    return ops, nbytes


def evaluator_backward(lanes: int, widths, elem: int) -> Tuple[int, int]:
    """(operations, bytes) the evaluator's backward requires without a
    recompute: every weight gradient (the forward's products again), the
    input gradients of conv2, dense0's convolution columns, the context
    (once a lane and slot) and dense1; the forward's inputs and the
    scores' gradient read, the parameters read and their gradients
    written in float32, the context's gradient written."""
    (c1, c2), h, d = widths
    m = lanes * ACTIONS
    fwd_ops, _ = evaluator_forward(lanes, widths, elem)
    ops = (fwd_ops + conv3x3(m, c1, c2) + dense(m, CELLS * c2, h)
           + dense(lanes * SLOTS, d, h) + dense(m, h, 1))
    nbytes = (m * (2 * CELLS + FEATS + 1) * elem + 2 * lanes * SLOTS * d * elem
              + 2 * _evaluator_params(widths) * 4)
    return ops, nbytes


def bound_s(ops: float, nbytes: float, device: str, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    at the dense peak and the bytes at the memory's bandwidth."""
    return max(ops / PEAK_FLOPS[device][dtype], nbytes / PEAK_BYTES[device])
