"""Training CLI: counterpart of `bbx/cli/train.py`.

Runs on the CUDA card unless ``--device cpu``.  On a machine without
PyYAML, pass a ``.json`` config.
"""
from __future__ import annotations

import argparse

from ..agent.trainer import train
from ..device import resolve_device
from ..utils.config import load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the Block Blast PPO agent")
    ap.add_argument("--config", default="config/default.yaml")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--seed", type=int, default=None,
                    help="overrides training.seed from the config (default 42)")
    ap.add_argument("--total-timesteps", type=int, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="per-phase timing, an mfu row and one profiler "
                         "trace (into <log_dir>/trace)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    config = load_config(args.config)
    stats = train(
        config,
        resume_path=args.resume,
        seed=args.seed,
        total_timesteps=args.total_timesteps,
        profile=args.profile,
        device=device,
    )
    # With in-run eval enabled, `best` is gated on eval score and the
    # rollout-mean best stays -inf; report whichever gate was active.
    if stats["best_eval"] > float("-inf"):
        best = f"best eval score {stats['best_eval']:.1f}"
    else:
        best = f"best avg score {stats['best_score']:.1f}"
    print(f"done: {stats['global_step']:,} steps in "
          f"{stats['elapsed_sec']:.1f}s "
          f"({stats['steps_per_sec']:.0f} steps/s), {best}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
