#!/usr/bin/env python3
"""The run9 early-curve check of the PyTorch/CUDA port, on one CUDA card.

    python3 scripts_dev/torch_run9_curve.py [--out build/run9_curve.json]

Trains config/run9.yaml unchanged but for `total_timesteps` (8,192,000:
125 iterations of 512 x 128, with the config's greedy evals of 100
episodes every 25 iterations) and the checkpoint/log paths (under
`build/run9_curve/`), through `bbx_torch.cli.train.main`, then evaluates
the final checkpoint greedily over 200 episodes with seed 123 through
`bbx_torch.cli.evaluate.main`.  The config is carried as JSON (the
sections `chip_smoke.py` holds, and run9's `logging:`), since the card's
machine has no PyYAML.

Each eval is printed beside bbx's at the same step (`docs/run9_train.jsonl`,
`docs/run9_eval_greedy_early.json`) with the band: at least half of bbx's
mean at 4,915,200, 6,553,600 and 8,192,000 steps and in the final eval.
The draws come from other generators than bbx's, so the curve is held to a
band, not to bbx's numbers.  Exits 0 whether or not the band holds (a miss
is a finding); non-zero if the run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (run9's sections, as JSON)

TOTAL_TIMESTEPS = 8_192_000
# config/run9.yaml's `logging:` section.
RUN9_LOGGING = {"log_interval": 25, "save_interval": 200, "eval_interval": 25,
                "eval_episodes": 100}
BAND_STEPS = (4_915_200, 6_553_600, 8_192_000)
FINAL_EPISODES, FINAL_SEED = 200, 123


def run9_config(work: str) -> dict:
    """config/run9.yaml with `total_timesteps` and the paths replaced."""
    return {"ppo": chip_smoke.RUN9_PPO,
            "training": dict(chip_smoke.RUN9_TRAINING, total_timesteps=TOTAL_TIMESTEPS),
            "network": chip_smoke.RUN9_NETWORK, "rewards": chip_smoke.RUN9_REWARDS,
            "logging": RUN9_LOGGING,
            "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                      "log_dir": os.path.join(work, "logs")}}


def bbx_reference() -> tuple:
    """({step: eval mean} of bbx's run9, bbx's early 200-episode mean)."""
    evals = {}
    with open(os.path.join(ROOT, "docs", "run9_train.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "eval_score_mean" in row:
                evals[row["step"]] = row["eval_score_mean"]
    with open(os.path.join(ROOT, "docs", "run9_eval_greedy_early.json")) as f:
        return evals, json.load(f)["score_mean"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "run9_curve.json"),
                    help="where the JSON result goes")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_run9_curve: needs a CUDA card", file=sys.stderr)
        return 1
    from bbx_torch.cli import evaluate
    from bbx_torch.cli import train as cli_train

    work = os.path.join(ROOT, "build", "run9_curve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = run9_config(work)
    cfg_path = os.path.join(work, "run9.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    card = chip_smoke.nvidia_smi()

    t0 = time.perf_counter()
    rc = cli_train.main(["--config", cfg_path])
    train_s = time.perf_counter() - t0
    if rc != 0:
        print(f"train.main returned {rc}", file=sys.stderr)
        return 1
    rows = []
    log_dir = cfg["paths"]["log_dir"]
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(log_dir, name)) as f:
                rows += [json.loads(line) for line in f]
    train_rows = [r for r in rows if "fps" in r]
    evals = {r["step"]: r for r in rows if "eval_score_mean" in r}

    final_json = os.path.join(work, "final_eval.json")
    t0 = time.perf_counter()
    rc = evaluate.main(["--checkpoint", os.path.join(cfg["paths"]["checkpoint_dir"], "final"),
                        "--episodes", str(FINAL_EPISODES), "--deterministic",
                        "--seed", str(FINAL_SEED), "--output", final_json])
    eval_s = time.perf_counter() - t0
    if rc != 0:
        print(f"evaluate.main returned {rc}", file=sys.stderr)
        return 1
    with open(final_json) as f:
        final = json.load(f)

    ref, ref_final = bbx_reference()
    points = [{"step": step, "port_mean": r["eval_score_mean"],
               "port_median": r["eval_score_median"], "port_length": r["eval_length_mean"],
               "bbx_mean": ref.get(step), "band_min": ref[step] / 2 if step in BAND_STEPS else None}
              for step, r in sorted(evals.items())]
    checks = {str(p["step"]): p["port_mean"] >= p["band_min"]
              for p in points if p["band_min"] is not None}
    checks["final"] = final["score_mean"] >= ref_final / 2
    result = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "total_timesteps": TOTAL_TIMESTEPS, "train_seconds": train_s,
        "train_env_steps_per_s": TOTAL_TIMESTEPS / train_s,
        "fps_rows": [{"step": r["step"], "fps": r["fps"], "avg_score": r["avg_score"]}
                     for r in train_rows],
        "evals": points,
        "final_eval": {"port": final, "bbx_mean": ref_final, "band_min": ref_final / 2,
                       "seconds": eval_s},
        "band_checks": checks, "band_holds": all(checks.values()),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(card)
    for p in points:
        print(f"step {p['step']:>9,}: port eval mean {p['port_mean']:10.1f} "
              f"(median {p['port_median']:.1f}, length {p['port_length']:.1f}); bbx "
              f"{p['bbx_mean']}; band >= {p['band_min']}")
    print(f"final greedy {FINAL_EPISODES} episodes, seed {FINAL_SEED}: port mean "
          f"{final['score_mean']:.1f} (median {final['score_median']:.1f}); bbx "
          f"{ref_final}; band >= {ref_final / 2}")
    print(f"train {TOTAL_TIMESTEPS:,} env-steps in {train_s:.1f} s "
          f"({TOTAL_TIMESTEPS / train_s:.1f} env-steps/s, evals and saves included)")
    print(json.dumps({"band_checks": checks, "band_holds": result["band_holds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
