#!/usr/bin/env python3
"""Where 2 ranks of the flat CNN part from 1 rank on one CUDA card.

    python3 scripts_dev/torch_parallel_spread.py [--out build/parallel_spread.json]

One iteration of config/default.yaml's flat CNN (BatchNorm, dropout; 64
envs x 128 steps, minibatch 2048, 10 epochs) in float32, through
`chip_smoke.py`'s phase-15 helpers:

  * 2 gloo ranks on cuda:0 against 1 rank with TF32 on (cuDNN's default
    for float32 convolutions): the first rollout's statistics;
  * 1 rank with TF32 off, three times: as is, as is again, and with the
    first minibatch's gradient moved by about one float32 ulp (each
    element times 1 +- 2**-23, signs from a seeded generator) before the
    clip.  Each against the first: the rollout's statistics, each
    minibatch's total loss (|difference| / |first run's|), the update's
    averaged losses and the BatchNorm running statistics after the
    iteration (largest |difference| over the tensor's largest |value|).

Prints one line a comparison and writes them all to `--out`.  Exits 0
unless a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the rank mode, FirstRecords, the sections)

WORK = os.path.join(ROOT, "build", "parallel_spread")
ULP = 2.0 ** -23


def config(name: str) -> tuple:
    work = os.path.join(WORK, name)
    os.makedirs(work)
    per_iter = cs.DEFAULT_TRAINING["num_envs"] * cs.DEFAULT_TRAINING["rollout_steps"]
    cfg = {"ppo": cs.DEFAULT_PPO,
           "network": dict(cs.DEFAULT_NETWORK, compute_dtype="float32"),
           "rewards": cs.RUN9_REWARDS,
           "training": dict(cs.DEFAULT_TRAINING, total_timesteps=per_iter),
           "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0},
           "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                     "log_dir": os.path.join(work, "logs")}}
    path = os.path.join(work, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg, path, work


def one_rank(cfg, device, exact: bool, perturb: bool) -> dict:
    """One iteration on 1 rank: its metrics, each minibatch's losses and
    the running statistics after it."""
    import contextlib

    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent.trainer import PPOTrainer
    from bbx_torch.device import float32_exact

    clip0, calls = P.clip_by_global_norm_, []

    def clip(grads, max_norm):
        if perturb and not calls:
            g = torch.Generator(device=grads[0].device).manual_seed(0)
            for x in grads:
                sign = 2 * torch.randint(0, 2, x.shape, generator=g, device=x.device) - 1
                x.mul_(1 + ULP * sign)
        calls.append(1)
        return clip0(grads, max_norm)

    P.clip_by_global_norm_ = clip
    try:
        trainer = PPOTrainer(cfg, seed=cs.TRAIN_SEED, device=device)
        with cs.FirstRecords() as first, (float32_exact() if exact
                                          else contextlib.nullcontext()):
            first.net = trainer.network
            metrics = {k: float(v) for k, v in trainer.iterate().items()}
    finally:
        P.clip_by_global_norm_ = clip0
    bn = {k: v.detach().double().cpu() for k, v in trainer.network.state_dict().items()
          if "running" in k}
    return {"metrics": metrics, "series": first.series, "bn": bn}


def against(run: dict, base: dict) -> dict:
    m, b = run["metrics"], base["metrics"]
    return {
        "rollout": {k: (m[k], b[k]) for k in cs.PARALLEL_EXACT},
        "minibatch_total_loss_rel_diff": [
            abs(x["total_loss"] - y["total_loss"]) / abs(y["total_loss"])
            for x, y in zip(run["series"], base["series"])],
        "update_losses": {k: (m[k], b[k], abs(m[k] - b[k])) for k in cs.PARALLEL_LOSSES},
        "running_stats_after_iteration_rel": max(
            float((run["bn"][k] - base["bn"][k]).abs().max())
            / float(base["bn"][k].abs().max()) for k in base["bn"])}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "parallel_spread.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parallel_spread: needs a CUDA card", file=sys.stderr)
        return 1
    from bbx_torch.ops import build

    print(cs.nvidia_smi(), flush=True)
    build.build_all()
    device = torch.device("cuda", 0)
    shutil.rmtree(WORK, ignore_errors=True)
    out = {"card": cs.nvidia_smi()}

    cfg, path, work = config("tf32_two_ranks")
    recs = cs.run_ranks(path, work, cs.TRAIN_SEED)
    ref = one_rank(cfg, device, exact=False, perturb=False)
    two = recs[0]["metrics"][0]
    out["tf32_two_ranks_vs_one"] = {k: (two[k], ref["metrics"][k]) for k in cs.PARALLEL_EXACT}
    print(f"TF32 on, first rollout, 2 ranks / 1: {out['tf32_two_ranks_vs_one']}", flush=True)
    del ref

    cfg, _, _ = config("no_tf32_one_rank")
    base = one_rank(cfg, device, exact=True, perturb=False)
    for name, perturb in (("again", False), ("one_ulp", True)):
        out[f"no_tf32_{name}"] = against(one_rank(cfg, device, True, perturb), base)
        print(f"TF32 off, 1 rank, {name} against the first: {out[f'no_tf32_{name}']}",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
