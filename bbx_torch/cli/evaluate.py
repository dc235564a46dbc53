"""Policy evaluation over parallel game lanes.

Counterpart of `bbx/cli/evaluate.py`: all N episodes run as parallel lanes
on one device with ``auto_reset=False``; the host polls ``done`` every
`chunk` steps until every lane has finished, and the statistics cover
completed episodes only.  Runs on the CUDA card unless ``--device cpu``.
``--lookahead`` plays policy+1-ply value search (`agent/lookahead.py`):
its results are search results, never the raw policy's.  ``--render``
then replays ``--render-games`` episodes of the raw policy through the
single env with ASCII rendering (`cli/play.py:watch`).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..agent.lookahead import lookahead_actions
from ..device import resolve_device
from ..engine.state import make_generator, reset
from ..engine.step import RewardConfig, observe, step
from ..models import distributions as D
from ..models import network_from_config
from ..utils.checkpoints import load_checkpoint
from ..utils.config import load_config, merge_config
from ..utils.profiling import count, span


def evaluate_policy(
    network: torch.nn.Module,
    num_episodes: int = 100,
    deterministic: bool = True,
    seed: int = 42,
    max_steps: int = 10_000,
    chunk: int = 64,
    progress: bool = False,
    lookahead: bool = False,
    gamma: float = 0.99,
    reward_config: Optional[RewardConfig] = None,
    topk: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Run `num_episodes` full episodes in parallel lanes; return statistics.

    Piece draws come from a generator seeded with `seed`, stochastic
    actions from one seeded with ``seed + 1`` and the search's simulated
    draws from one seeded with ``seed + 2``, all on `device`.
    `lookahead` switches from the raw policy to policy+1-ply value search
    (`topk` bounds its candidates, 0 simulates all 192 actions; `gamma`
    discounts its bootstrap): label its results as search results.
    With the tracer on (`bbx_torch.utils.profiling`) the job counts the
    lanes times the steps it steps (`eval.lane_steps`) and those on lanes
    whose game had not ended (`eval.live_lane_steps`: every lane's moves,
    since a live lane's policy or search takes a valid action).
    """
    with span("eval.job", lanes=num_episodes):
        return _evaluate(network, num_episodes, deterministic, seed, max_steps, chunk,
                         progress, lookahead, gamma, reward_config, topk, device)


def _evaluate(network, num_episodes, deterministic, seed, max_steps, chunk, progress,
              lookahead, gamma, reward_config, topk, device):
    """`evaluate_policy`'s body, in its span."""
    dev = resolve_device(device)
    rc = reward_config or RewardConfig()
    network = network.to(dev).eval()
    state = reset(num_episodes, make_generator(seed, dev), dev)
    act_rng = make_generator(seed + 1, dev)
    search_rng = make_generator(seed + 2, dev)
    steps_done = 0
    with torch.inference_mode():
        obs = observe(state)
        while steps_done < max_steps:
            with span("eval.chunk"):
                for _ in range(chunk):
                    if lookahead:
                        action = lookahead_actions(network, state, search_rng, rc,
                                                   gamma=gamma, topk=topk, obs=obs)
                    else:
                        logits, _ = network(obs["board"], obs["pieces"],
                                            obs["action_mask"])
                        action = (D.mode(logits) if deterministic
                                  else D.sample(act_rng, logits))
                    out = step(state, action, rc, auto_reset=False)
                    state, obs = out.state, out.obs
            steps_done += chunk
            count("eval.lane_steps", num_episodes * chunk)
            with span("eval.poll"):
                done = state.done.cpu().numpy()
            if progress:
                print(f"  eval: {done.sum()}/{num_episodes} episodes finished "
                      f"after {steps_done} steps", flush=True)
            if done.all():
                break

    with span("eval.stats"):
        # Aggregate over COMPLETED episodes only: a lane still alive at
        # max_steps holds a lower bound on its final score.
        done = state.done.cpu().numpy()
        moves = state.moves.cpu().numpy()
        count("eval.live_lane_steps", int(moves.sum()))
        sel = done if done.any() else np.ones_like(done)
        scores = state.score.cpu().numpy().astype(np.float64)[sel]
        lengths = moves.astype(np.float64)[sel]
        lines = state.lines_total.cpu().numpy().astype(np.float64)[sel]
        combos = state.max_streak.cpu().numpy().astype(np.float64)[sel]
        pct = {f"p{p}": float(np.percentile(scores, p))
               for p in (10, 25, 50, 75, 90, 95, 99)}
        return {
            "num_episodes": num_episodes,
            "deterministic": deterministic,
            "lookahead": lookahead,
            "completed": int(done.sum()),
            "truncated": int((~done).sum()),
            "score_mean": float(scores.mean()),
            "score_std": float(scores.std()),
            "score_min": float(scores.min()),
            "score_max": float(scores.max()),
            "score_median": float(np.median(scores)),
            "length_mean": float(lengths.mean()),
            "length_std": float(lengths.std()),
            "lines_mean": float(lines.mean()),
            "max_combo_mean": float(combos.mean()),
            "percentiles": pct,
        }


def print_results(r: Dict[str, Any]) -> None:
    print("=" * 50)
    print(f"Evaluation over {r['num_episodes']} episodes "
          f"({'deterministic' if r['deterministic'] else 'stochastic'})")
    print("-" * 50)
    print(f"Score:  mean {r['score_mean']:.1f} ± {r['score_std']:.1f}  "
          f"min {r['score_min']:.0f}  median {r['score_median']:.0f}  "
          f"max {r['score_max']:.0f}")
    print(f"Length: mean {r['length_mean']:.1f} ± {r['length_std']:.1f}")
    print(f"Lines:  mean {r['lines_mean']:.2f}   "
          f"Max combo: mean {r['max_combo_mean']:.2f}")
    print("Percentiles: " + "  ".join(
        f"{k}={v:.0f}" for k, v in r["percentiles"].items()))
    print("=" * 50)


def config_for_checkpoint(checkpoint: str, config_path: Optional[str] = None):
    """The config that rebuilds a checkpoint's network: an explicit YAML
    wins, else the ``<checkpoint>.config.json`` sidecar, else defaults."""
    if config_path:
        return load_config(config_path)
    sidecar = os.path.abspath(checkpoint) + ".config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return merge_config(load_config(None), json.load(f))
    return load_config(None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate a trained agent")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--lookahead", action="store_true",
                    help="policy+1-ply value search (report as "
                         "search-assisted, not raw policy)")
    ap.add_argument("--topk", type=int, default=0,
                    help="with --lookahead, simulate only the policy's top-k "
                         "actions (default 0: all 192)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output", default=None, help="JSON results path")
    ap.add_argument("--render", action="store_true",
                    help="after the stats, replay a few episodes with ASCII "
                         "rendering (the parallel eval lanes themselves can't "
                         "render)")
    ap.add_argument("--render-games", type=int, default=2,
                    help="episodes to render with --render")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config_for_checkpoint(args.checkpoint, args.config)
    network = network_from_config(cfg.get("network", {}))
    network.load_state_dict(load_checkpoint(args.checkpoint)["params"])
    results = evaluate_policy(
        network, num_episodes=args.episodes,
        deterministic=args.deterministic, seed=args.seed, progress=True,
        lookahead=args.lookahead, topk=args.topk, device=device,
    )
    print_results(results)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
        print(f"results written to {args.output}")
    if args.render:
        from .play import watch

        watch(args.checkpoint, args.config, games=args.render_games,
              delay=0.0, deterministic=args.deterministic, seed=args.seed,
              device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
