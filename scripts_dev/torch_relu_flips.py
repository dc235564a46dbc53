"""Where float32 and float64 disagree on a ReLU in `chip_smoke.py` phase 9.

    python3 scripts_dev/torch_relu_flips.py

Phase 9 holds the card's float32 PPO update to a float64 update on the
CPU.  This replays that phase's batch (T = 4 x N = 64 transitions of the
port's engine under numpy-chosen valid moves, seed 777) and the
AfterstateNetwork at run9 widths on the CPU, and lists every
pre-activation of the evaluator (conv1, conv2, dense0) whose sign differs
between the float32 and float64 forwards, with both values.  For each
dense0 flip it also gives the exact sum of the float32 activations (the
float32 path's inputs summed in float64) and of the float32 activations
rounded once from float64 convolutions: which of the float32 roundings
flips it.  CPU only; no card needed.
"""
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as CS  # noqa: E402
from bbx_torch.agent import ppo as P  # noqa: E402
from bbx_torch.engine.state import make_generator, reset  # noqa: E402
from bbx_torch.engine.step import observe, step  # noqa: E402
from bbx_torch.models import afterstate as A  # noqa: E402
from bbx_torch.models import network_from_config  # noqa: E402


def phase9_observations(t_len=4, n=64):
    """The minibatch's boards and pieces, as `update` rebuilds them."""
    rng = np.random.default_rng(CS.SEED)
    state = reset(n, make_generator(CS.SEED, "cpu"), "cpu")
    obs = observe(state)
    cols = {k: [] for k in ("board", "piece_ids", "used", "mask")}
    for _ in range(t_len):
        act = torch.tensor([rng.choice(np.flatnonzero(m)) for m in obs["action_mask"].numpy()],
                           dtype=torch.int32)
        out = step(state, act, auto_reset=True)
        for k, v in (("board", state.board), ("piece_ids", state.piece_ids.to(torch.int8)),
                     ("used", state.used), ("mask", obs["action_mask"])):
            cols[k].append(v)
        state, obs = out.state, out.obs
    mb = P._minibatch_obs({k: torch.cat(v) for k, v in cols.items()})
    return mb["board"].float().contiguous(), mb["pieces"].float().contiguous()


def forward(net, dt, board, pieces, round_acts_to=None):
    """The evaluator's pre-activations [z1, z2, z0] and dense0's input in
    `dt`; with `round_acts_to`, each activation is rounded to that type."""
    m = copy.deepcopy(net).to(dt)
    m.compute_dtype = dt
    with torch.no_grad():
        planes, feats, ctx = m.afterstates(board, pieces)
        boards, fe, cx = A._plain_inputs(planes, feats, ctx)
        x, pre = boards, []
        for conv in m.evaluator.convs:
            z = F.conv2d(x, conv.weight, conv.bias, padding=1)
            pre.append(z)
            x = F.relu(z)
            if round_acts_to is not None:
                x = x.to(round_acts_to).to(dt)
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if round_acts_to is not None:
            fe, cx = fe.to(round_acts_to).to(dt), cx.to(round_acts_to).to(dt)
        x0 = torch.cat([flat, fe, cx], -1)
        pre.append(F.linear(x0, m.evaluator.dense0.weight, m.evaluator.dense0.bias))
    return pre, x0, m.evaluator.dense0


def main() -> int:
    board, pieces = phase9_observations()
    net = network_from_config(dict(CS.RUN9_NETWORK, compute_dtype="float32"),
                              generator=torch.Generator().manual_seed(CS.SEED))
    pre32, x0_32, _ = forward(net, torch.float32, board, pieces)
    pre64, _, d64 = forward(net, torch.float64, board, pieces)
    _, x0_r, _ = forward(net, torch.float64, board, pieces, round_acts_to=torch.float32)
    for layer, name in enumerate(("conv1", "conv2", "dense0")):
        a, b = pre32[layer].double(), pre64[layer]
        flips = ((a > 0) != (b > 0)).nonzero()
        print(f"{name}: {a.numel()} pre-activations, {len(flips)} float32/float64 sign flips")
        for idx in flips.tolist():
            idx = tuple(idx)
            line = f"  at {idx}: float64 {b[idx].item():.6g}, float32 {a[idx].item():.6g}"
            if name == "dense0":
                mi, hi = idx
                w, bias = d64.weight[hi], d64.bias[hi]
                exact32 = (x0_32[mi].double() * w).sum() + bias
                rounded = (x0_r[mi] * w).sum() + bias
                line += (f" (afterstate {mi}: lane {mi // 192}, action {mi % 192}; hidden {hi}); "
                         f"exact sum of the float32 activations {exact32.item():.6g}, of "
                         f"activations rounded once from float64 {rounded.item():.6g}")
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
