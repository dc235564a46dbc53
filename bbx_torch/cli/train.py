"""Training CLI: counterpart of `bbx/cli/train.py`.

Runs on the CUDA card unless ``--device cpu``.  On a machine without
PyYAML, pass a ``.json`` config.

Several processes train one run data-parallel when started by `torchrun`
(or with its environment variables set):

    torchrun --nproc_per_node=2 -m bbx_torch.cli.train --config CFG \\
        --device cpu --backend gloo

Each rank runs on ``--device`` (default ``cuda:<LOCAL_RANK>``).  The
backend defaults to ``nccl`` on the card and ``gloo`` on the CPU; NCCL
runs one rank a card, so two ranks that share one card need
``--device cuda:0 --backend gloo``.
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..agent.trainer import train
from ..device import resolve_device
from ..parallel.distributed import BACKENDS, initialize_multihost
from ..utils.config import load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the Block Blast PPO agent")
    ap.add_argument("--config", default="config/default.yaml")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--seed", type=int, default=None,
                    help="overrides training.seed from the config (default 42)")
    ap.add_argument("--total-timesteps", type=int, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="trace the program's spans: print the phase report "
                         "(host seconds by span, device ms where marked) and "
                         "the device's idle time by span in one profiled "
                         "iteration (its trace into <log_dir>/trace), and "
                         "add an mfu row to each log line")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or cuda:<LOCAL_RANK> "
                         "under torchrun; 'cpu' to run there)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="collective backend of a multi-process run (default "
                         "nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)

    local_rank = os.environ.get("LOCAL_RANK")
    device = resolve_device(args.device or (f"cuda:{local_rank}" if local_rank
                                            else "cuda"))
    grouped = initialize_multihost(backend=args.backend, device=device)
    try:
        stats = train(
            load_config(args.config),
            resume_path=args.resume,
            seed=args.seed,
            total_timesteps=args.total_timesteps,
            profile=args.profile,
            device=device,
        )
    finally:
        if grouped:
            dist.destroy_process_group()
    if stats["trainer"].mesh.rank:
        return 0
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
