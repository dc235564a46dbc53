"""K8's backward against the plain evaluator's autograd, stage by stage, on
the card.

    python3 scripts_dev/torch_k8b_diag.py

For a seeded network at run9, tiny and ragged widths (64, 64 and 3 lanes
of reachable boards) in float32 (TF32 off) and bf16, runs the plain
evaluator (cuDNN, cuBLAS) with autograd and K8's backward on the same
inputs and upstream gradient, and prints where they part: K8b's stored
a2 (dense0's input) against the plain conv2 activations -- the share of
elements that differ and by how much --, K8b's dz0 against the plain
dense0 gradient, and every gradient tensor's largest error.  Needs a
CUDA card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bbx_torch.device import float32_exact  # noqa: E402
from bbx_torch.engine import state as TState  # noqa: E402
from bbx_torch.engine.step import observe, step  # noqa: E402
from bbx_torch.models import afterstate as A  # noqa: E402
from bbx_torch.models import network_from_config  # noqa: E402


def midgame(dev, n, seed=5):
    g = TState.make_generator(seed, dev)
    state = TState.reset(n, g, dev)
    obs = observe(state)
    for _ in range(12):
        u = torch.rand(obs["action_mask"].shape, generator=g, device=dev)
        out = step(state, torch.where(obs["action_mask"], u, -1.0).argmax(1), auto_reset=True)
        state, obs = out.state, out.obs
    return obs


def run(dev, widths, b, dt):
    (c1, c2), h, d = widths
    net = network_from_config({"type": "afterstate", "eval_channels": [c1, c2],
                               "eval_hidden": h, "ctx_dim": d, "compute_dtype": str(dt)[6:]},
                              generator=torch.Generator().manual_seed(5)).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_((torch.rand(p.shape, generator=g, device=dev) - 0.5) * 0.2)
    obs = midgame(dev, b)
    with torch.no_grad():
        planes, feats, ctx = net.afterstates(obs["board"].float().contiguous(),
                                             obs["pieces"].contiguous())
    ds = torch.randn(b * 192, generator=g, device=dev).to(dt)
    ev = net.evaluator
    with float32_exact():
        boards, fe, cx = A._plain_inputs(planes, feats, ctx)
        cx = cx.detach().requires_grad_(True)
        x = boards
        for conv in ev.convs:
            w = conv.weight.to(dt, memory_format=torch.channels_last)
            x = F.relu(F.conv2d(x, w, conv.bias.to(dt), padding=1))
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        z0 = F.linear(torch.cat([flat, fe, cx], dim=-1), ev.dense0.weight.to(dt),
                      ev.dense0.bias.to(dt))
        z0.retain_grad()
        s = F.linear(F.relu(z0), ev.dense1.weight.to(dt), ev.dense1.bias.to(dt))[:, 0]
        s.backward(ds)
        with torch.no_grad():
            w = A._GradWork(ev, planes, feats, ctx, ds, dt)
            A._evaluator_grad_tiles(w)
            A._evaluator_grad_dense0(w)
            A._evaluator_grad_reduce(w)
        torch.cuda.synchronize()
    t = 32 if dt == torch.bfloat16 else 16
    m = b * 192
    hk, kx = w.dz0.numel() // m, w.x0.numel() // m
    x0 = w.x0.view(m // t, kx, t).permute(0, 2, 1).reshape(m, kx).float()
    dz0 = w.dz0.view(m // t, hk, t).permute(0, 2, 1).reshape(m, hk).float()
    c2p = (c2 + 7) // 8 * 8
    a2 = x0[:, :64 * c2p].view(m, 64, c2p)[:, :, :c2].reshape(m, -1)
    diff = (a2 - flat.float()).abs()
    print(f"== widths {widths}, {b} lanes, {dt}")
    print(f"  a2: {float((diff > 0).float().mean()):.4f} of the elements differ, by up to "
          f"{diff.max().item():.4g} (largest |a2| {flat.float().abs().max().item():.4g})")
    ddz = (dz0[:, :h] - z0.grad.float()).abs()
    print(f"  dz0: {float((ddz > 0).float().mean()):.5f} of the elements differ, by up to "
          f"{ddz.max().item():.4g} (largest |dz0| {z0.grad.float().abs().max().item():.4g})")
    got = [w.dctx] + w.grads()
    want = [cx.grad.view(b, 3, 64, d).sum(2)] + [p.grad for _, p in ev.named_parameters()]
    for name, x, y in zip(["ctx"] + [n for n, _ in ev.named_parameters()], got, want):
        x, y = x.double(), y.double()
        err, top = (x - y).abs().max().item(), y.abs().max().item()
        print(f"  {name}: largest error {err:.4g} of {top:.4g} ({err / top:.3g})")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        for widths, b in ((((24, 24), 96, 32), 64), (((4, 4), 8, 6), 64), (((5, 12), 20, 7), 3)):
            run(dev, widths, b, dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
