"""Minimal trainer with a fixed recipe: counterpart of the root `stable_train.py`.

    bbx-torch-stable-train [--steps N] [--envs N] [--extended] [--device cpu]

A console-only loop on `PPOTrainer` with `stable_train.py`'s fixed
hyperparameters (the default network, ``training: {num_envs: --envs,
rollout_steps: 64, batch_size: 512}``, ``ppo: {num_epochs: 4}``, seed 0)
and resumable full-state checkpoints under ``checkpoints/``:
``quick_trained``, or ``extended_trained`` with ``--extended``, resumed
when present.  It prints a line every 20 iterations and saves on exit or
interrupt.  Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time

from ..agent.trainer import PPOTrainer
from ..device import resolve_device
from ..utils.checkpoints import checkpoint_exists

CHECKPOINT_DIR = "checkpoints"


def recipe(envs: int) -> dict:
    """`stable_train.py`'s config at `envs` lanes."""
    return {"training": {"num_envs": envs, "rollout_steps": 64, "batch_size": 512},
            "ppo": {"num_epochs": 4}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train with stable_train.py's fixed recipe")
    ap.add_argument("--steps", type=int, default=2_000_000)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--extended", action="store_true",
                    help="use the extended checkpoint name")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    trainer = PPOTrainer(recipe(args.envs), seed=0, device=resolve_device(args.device))
    name = "extended_trained" if args.extended else "quick_trained"
    ckpt = os.path.join(CHECKPOINT_DIR, name)
    if checkpoint_exists(ckpt):
        trainer.load(ckpt)
        print(f"resumed {name} at step {trainer.global_step:,}")

    per_iter = trainer.ppo.batch_size
    t0 = time.time()
    try:
        while trainer.global_step < args.steps:
            m = trainer.iterate()
            it = trainer.global_step // per_iter
            if it % 20 == 0:
                done = trainer.global_step
                rate = done / max(time.time() - t0, 1e-9)
                eta = (args.steps - done) / max(rate, 1e-9)
                print(f"step {done:>10,} | {rate:,.0f} sps | "
                      f"score {float(m['mean_score']):8.1f} | "
                      f"ent {float(m['entropy']):.3f} | eta {eta/60:.1f}m",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        trainer.save(CHECKPOINT_DIR, name)
        print(f"saved {CHECKPOINT_DIR}/{name} at step {trainer.global_step:,}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
