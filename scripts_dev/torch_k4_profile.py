#!/usr/bin/env python3
"""Profile the afterstate expansion (K4) and the evaluator input it feeds,
on one CUDA card, at run9 widths (bf16).

    python3 scripts_dev/torch_k4_profile.py [--out FILE]

With the timing helpers of `chip_smoke.py`, it reports:

- K4 (`bbx_torch.models.afterstate.afterstate_buffer`) at B = 512 (the
  rollout's and the eval's observations) and B = 2048 (the update's
  minibatch, rebuilt by `ppo._minibatch_obs`): wrapper time between CUDA
  events, device time by `torch.profiler`, host time a call; in the
  network's compute dtype where the wrapper takes one;
- the device time and launches of the torch glue that turns float32
  planes and lines into the evaluator's bf16 input (the planes' cast, the
  placed-cell sum, the per-move feature build and concatenation, the
  features' cast), on seeded tensors of those shapes at both B;
- the evaluator alone in NCHW and channels-last
  (`chip_smoke.evaluator_layouts`);
- the kernels of one eval forward at B = 512 (`chip_smoke.forward_kernels`).

Prints the card's name and power limit, then one JSON object, which also
goes to FILE.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def glue(device, b: int) -> dict:
    import torch

    import chip_smoke as CS

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(CS.SEED)
    planes = (torch.rand((b, 192, 2, 8, 8), generator=g, device=device) < 0.4).to(f32)
    lines = torch.randint(0, 3, (b, 192), generator=g, device=device).to(f32)
    ctx = torch.randn((b, 192, CS.RUN9_NETWORK["ctx_dim"]), generator=g,
                      device=device).to(bf16)
    nblocks = planes[:, :, 1].sum(dim=(2, 3))

    def build():
        return torch.cat([lines[..., None] / 4.0, (lines[..., None] > 0).to(f32),
                          nblocks[..., None] / 5.0, ctx.to(f32)], dim=-1)

    feats = build()
    steps = {"planes_cast": lambda: planes.to(bf16),
             "nblocks_sum": lambda: planes[:, :, 1].sum(dim=(2, 3)),
             "feature_build_and_cat": build,
             "feats_cast": lambda: feats.to(bf16)}
    return {name: CS.calls_device(fn) for name, fn in steps.items()}


def k4(device, bd, pc) -> dict:
    import torch

    import chip_smoke as CS
    from bbx_torch.models import afterstate as A

    kw = ({"dtype": torch.bfloat16}
          if "dtype" in inspect.signature(A.afterstate_buffer).parameters else {})

    def fn():
        return A.afterstate_buffer(bd, pc, **kw)

    return {"lanes": bd.shape[0], "kwargs": {k: str(v) for k, v in kw.items()},
            "ms": CS.time_ms(fn), "device_ms": CS.kernel_device_ms(fn, "afterstate"),
            "host_us": CS.host_us(fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from bbx_torch.agent import ppo as P
    from bbx_torch.ops import build

    device = torch.device("cuda", 0)
    build.build_all()
    state, obs, _, _ = CS.midgame_boards(device)
    b, b2 = CS.K4_LANES, CS.RUN9_TRAINING["batch_size"]
    mb = P._minibatch_obs({"board": state.board[:b2], "mask": obs["action_mask"][:b2],
                           "piece_ids": state.piece_ids[:b2].to(torch.int8),
                           "used": state.used[:b2]})
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": CS.nvidia_smi(),
           "k4": [k4(device, obs["board"][:b].contiguous(), obs["pieces"][:b].contiguous()),
                  k4(device, mb["board"].contiguous(), mb["pieces"].contiguous())],
           "glue": {str(n): glue(device, n) for n in (b, b2)},
           "forward": CS.forward_kernels(device),
           "evaluator_layouts": CS.evaluator_layouts(device)}
    print(out["nvidia_smi"])
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
