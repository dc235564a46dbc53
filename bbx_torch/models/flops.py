"""Matmul and convolution FLOPs of the networks, from their widths.

Counted as `torch.utils.flop_counter.FlopCounterMode` counts them: two a
multiply-add of every convolution and matrix product, nothing for biases,
norms, activations, softmaxes or reductions.  On the CPU's plain path the
counts equal that mode's; on the card the evaluator runs in the
extension's own kernels (K8, K8b, K8w), which the mode cannot see, hence
these analytic counts.

A network lists its layers (`flop_layers(batch)`): each layer's forward
FLOPs, whether its input needs a gradient (not the first layer of a path,
which reads the observation) and whether a gradient step recomputes it
(the evaluator, under bbx's ``nn.remat``: K8b on the card,
`torch.utils.checkpoint` on the CPU).  A gradient step counts the forward,
the recompute, each layer's weight gradient and, where its input needs
one, its input gradient; each of the three costs what the forward does.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

BOARD_CELLS = 64
NUM_ACTIONS = 192
NUM_SLOTS = 3
NUM_FEATS = 3

# (forward FLOPs, input needs a gradient, recomputed in a gradient step)
Layer = Tuple[int, bool, bool]


def conv3x3_flops(rows: int, cin: int, cout: int) -> int:
    """A 3x3 'same' convolution over `rows` 8x8 images."""
    return 2 * rows * BOARD_CELLS * 9 * cin * cout


def dense_flops(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def conv_layer(rows: int, conv, input_grad: bool = True) -> Layer:
    """An `nn.Conv2d` (3x3, 'same') over `rows` 8x8 images."""
    return conv3x3_flops(rows, conv.in_channels, conv.out_channels), input_grad, False


def linear_layer(rows: int, linear) -> Layer:
    """An `nn.Linear` on `rows` rows whose input needs a gradient."""
    return dense_flops(rows, linear.in_features, linear.out_features), True, False


def evaluator_layers(lanes: int, channels: Sequence[int], hidden: int,
                     ctx_dim: int) -> List[Layer]:
    """The evaluator's layers on `lanes` x 192 afterstates, as the plain
    evaluator and bbx compute it: dense0 reads each afterstate's conv
    columns, 3 features and context.  A gradient step's recompute stops
    before dense1, whose output (the score) no gradient reads, as
    `torch.utils.checkpoint` stops there."""
    m = lanes * NUM_ACTIONS
    chans = [2, *channels]
    layers = [(conv3x3_flops(m, a, b), i > 0, True)
              for i, (a, b) in enumerate(zip(chans[:-1], chans[1:]))]
    return layers + [
        (dense_flops(m, BOARD_CELLS * chans[-1] + NUM_FEATS + ctx_dim, hidden), True, True),
        (dense_flops(m, hidden, 1), True, False)]


def network_flops(network, batch: int, grad: bool = False, recompute: bool = True,
                  value_only: bool = False) -> int:
    """FLOPs of one forward of `network` on `batch` observations, or with
    `grad` of one gradient step (forward, recompute and backward; without
    the recompute, which the model does not require, where `recompute` is
    False).  `value_only`: the value alone, as the one-ply search reads it
    (`network.value`)."""
    layers = (network.flop_layers(batch, value_only=True) if value_only
              else network.flop_layers(batch))
    total = 0
    for fwd, input_grad, recomputed in layers:
        total += fwd
        if grad:
            total += fwd * (1 + int(input_grad) + int(recomputed and recompute))
    return total


# ---------------------------------------------------------------------------
# The evaluator's kernels, at widths ((C1, C2), H, D).
# ---------------------------------------------------------------------------

def k8_flops(lanes: int, widths) -> int:
    """K8, the evaluator's forward as K8 computes it: the context's part
    of dense0 (D x H) once a (lane, slot), not once an afterstate."""
    channels, h, d = widths
    m = lanes * NUM_ACTIONS
    return (sum(f for f, _, _ in evaluator_layers(lanes, channels, h, d))
            - dense_flops(m, d, h) + dense_flops(lanes * NUM_SLOTS, d, h))


def k8b_flops(lanes: int, widths) -> int:
    """K8b: K8's recompute, then per afterstate da2 (dense0's input
    gradient on the conv columns), conv2's weight and input gradients,
    conv1's weight gradient and dense1's gradient."""
    (c1, c2), h, _ = widths
    m = lanes * NUM_ACTIONS
    return (k8_flops(lanes, widths) + dense_flops(m, h, BOARD_CELLS * c2)
            + 2 * conv3x3_flops(m, c1, c2) + conv3x3_flops(m, 2, c1)
            + dense_flops(m, h, 1))


def k8w_flops(lanes: int, widths) -> int:
    """K8w: dense0's weight gradient dz0^T x0."""
    (_, c2), h, d = widths
    return dense_flops(lanes * NUM_ACTIONS, BOARD_CELLS * c2 + NUM_FEATS + d, h)
