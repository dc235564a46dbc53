"""Benchmark suite: counterpart of `bbx/cli/benchmark.py`.

  * --engine   engine stepping, random valid actions, no network
  * --vec-env  the same fleet at the vectorised-env defaults (the headline)
  * --network  policy forward latency / throughput across batch sizes
  * --train    PPO train-iteration throughput
  * --env      single-env host-API stepping (`BlockBlastEnv`, one lane)

The fleet benchmarks keep `bench.py`'s methodology: the carry is (state,
action mask), every chunk of steps ends by fetching its reward sum to the
host (`.item()`, which cannot return before the device has run the
chunk), several windows are timed, implausible and outlying windows are
re-timed (`robust_rates`), and the median is reported, failing loudly when
the surviving windows spread by more than 20%.  On the card the fleet loop
is bound by the host thread that launches its kernels, so the rate and
the windows follow that thread's speed: the measurement pins it to one
core (`_pinned_thread`).  No CUDA graph and no
`torch.compile`: eager PyTorch plus the port's kernels.  Runs on the CUDA
card unless ``--device cpu``; every result names the device it ran on.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import time
from typing import Any, Dict, Optional

import torch

from ..device import device_name, resolve_device
from ..engine.state import make_generator
from ..engine.step import observe
from ..env.vector import VectorEnv, sample_valid_actions_device

MAX_REL_SPREAD = 0.20
# No device runs a chunk of steps over a fleet in under 50 us; a faster
# "measurement" is a broken one (`bench.py`).
MIN_SEC_PER_CHUNK = 50e-6


class SpreadError(RuntimeError):
    """A fleet measurement whose plausible windows are too few or spread by
    more than `MAX_REL_SPREAD`; `result` holds what was measured."""

    def __init__(self, message: str, result: Dict[str, Any]):
        super().__init__(message)
        self.result = result


def robust_rates(time_window, steps_per_window, num_windows=5, max_extra=5,
                 min_window_sec=0.0):
    """Collect per-window throughput rates, discarding broken measurements.

    `time_window()` runs one timing window and returns its wall-clock
    duration in seconds.  Windows shorter than `min_window_sec` are
    physically impossible and discarded; once three windows exist, any
    rate outside [0.5x, 2x] of the running median is dropped as a gross
    outlier.  Both kinds are re-timed from a budget of `max_extra` extra
    windows.  (The port's own copy of `bench.py:robust_rates`.)

    Returns (rates, info) where info counts what was discarded; the caller
    decides whether the surviving spread is acceptable.
    """
    rates = []
    info = {"impossible_windows": 0, "outlier_windows": 0, "timed_windows": 0}
    budget = num_windows + max_extra
    while len(rates) < num_windows and info["timed_windows"] < budget:
        info["timed_windows"] += 1
        dt = time_window()
        if dt < min_window_sec:
            info["impossible_windows"] += 1
            continue
        rates.append(steps_per_window / dt)
        if len(rates) >= 3:
            med = statistics.median(rates)
            keep = [r for r in rates if 0.5 * med <= r <= 2.0 * med]
            info["outlier_windows"] += len(rates) - len(keep)
            rates = keep
    return rates, info


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _pinned_thread(device: torch.device):
    """Pin the calling thread to one core while a card's fleet is timed.

    The loop is host-bound, so its windows follow the launching thread's
    speed; pinned, the thread does not migrate between cores.  On the
    H100's shared host that did not hold the windows under the gate when
    the host was busy (PERF.md).  The third
    allowed core is taken (the first ones take most of a machine's
    interrupts and daemons).  The CPU
    thread pool is started first, since threads inherit the affinity of
    the thread that creates them, and the affinity is restored after.
    Nothing is pinned for a CPU fleet, whose ops use the whole pool.
    """
    if device.type != "cuda" or not hasattr(os, "sched_setaffinity"):
        yield
        return
    torch.ones(1 << 20).sum()
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {sorted(allowed)[min(2, len(allowed) - 1)]})
    try:
        yield
    finally:
        os.sched_setaffinity(0, allowed)


def fleet_rate(num_envs: int, steps: int, iters: int,
               device="cuda") -> Dict[str, Any]:
    """Random-policy env-steps/s of a `VectorEnv` fleet.

    One chunk is `steps` steps: sample a uniformly random valid action per
    lane from the carried mask, step (auto-reset on), carry the new mask,
    add the reward sum; the chunk ends with the sum fetched to the host.
    A window is `iters` chunks, and five plausible windows are kept (see
    `robust_rates`), on the card with the thread pinned to one core
    (`_pinned_thread`).  One chunk before the first window warms up and
    moves the fleet into a mid-game mix.  Raises `SpreadError` when fewer
    than 3 plausible windows remain or their spread exceeds
    `MAX_REL_SPREAD`.
    """
    dev = resolve_device(device)
    env = VectorEnv(num_envs, seed=0, device=dev)
    env.reset()
    act_rng = make_generator(1, dev)
    carry = {"mask": observe(env.state)["action_mask"]}

    def run_chunk() -> float:
        mask = carry["mask"]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(steps):
            out = env.step_device(sample_valid_actions_device(act_rng, mask))
            mask = out.obs["action_mask"]
            total = total + out.reward.sum()
        carry["mask"] = mask
        return total.item()

    def time_window() -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            run_chunk()
        return time.perf_counter() - t0

    with torch.inference_mode(), _pinned_thread(dev):
        run_chunk()
        rates, info = robust_rates(time_window, num_envs * steps * iters,
                                   min_window_sec=iters * MIN_SEC_PER_CHUNK)
    med = statistics.median(rates) if rates else 0.0
    spread = (max(rates) - min(rates)) / med if rates else float("inf")
    result = {"name": "engine", "num_envs": num_envs, "chunk": steps,
              "chunks_per_window": iters, "env_steps_per_sec": med,
              "windows": rates, "rel_spread": spread,
              "device": device_name(dev), **info}
    if len(rates) < 3 or spread > MAX_REL_SPREAD:
        raise SpreadError(
            f"only {len(rates)} plausible windows, spread {spread:.1%} (gate "
            f"{MAX_REL_SPREAD:.0%}) after {info['timed_windows']} windows: "
            f"{json.dumps(result)}", result)
    return result


def bench_engine(num_envs: int = 1024, steps: int = 512, iters: int = 4,
                 device="cuda") -> Dict[str, Any]:
    """Engine stepping with random valid actions (`bbx/cli/benchmark.py:21`)."""
    return fleet_rate(num_envs, steps, iters, device)


def bench_single_env(steps: int = 2000, device="cuda") -> Dict[str, Any]:
    """The host-API single env's round trip (`bbx/cli/benchmark.py:61`):
    random valid actions from the env's own mask, a reset at each game's
    end, three warm-up steps.  Reports env-steps/s, wall µs a step and the
    thread's CPU µs a step (the host's own work; the rest is waiting for
    the device)."""
    import numpy as np

    from ..env.single import BlockBlastEnv

    dev = resolve_device(device)
    env = BlockBlastEnv(seed=0, device=dev)
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        env.step(env.sample_valid_action())
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(steps):
        valid = np.nonzero(env.get_action_mask())[0]
        a = int(rng.choice(valid)) if len(valid) else 0
        _, _, done, _, _ = env.step(a)
        if done:
            env.reset()
    dt, cpu = time.perf_counter() - t0, time.thread_time() - c0
    return {"name": "single_env", "steps": steps, "env_steps_per_sec": steps / dt,
            "us_per_step": dt / steps * 1e6, "host_cpu_us_per_step": cpu / steps * 1e6,
            "device": device_name(dev)}


def bench_vec_env(num_envs: int = 4096, steps: int = 64, iters: int = 10,
                  device="cuda") -> Dict[str, Any]:
    """The vectorised fleet at `bbx`'s vec-env defaults (`:83`)."""
    r = fleet_rate(num_envs, steps, iters, device)
    r["name"] = "vec_env"
    return r


def bench_network(batch_sizes=(1, 8, 32, 128, 512, 4096),
                  device="cuda") -> Dict[str, Any]:
    """Forward latency / throughput of the default `BlockBlastNetwork`
    (bf16, eval mode, seeded weights) on all-ones inputs (`:90`)."""
    from ..models import BlockBlastNetwork

    dev = resolve_device(device)
    net = BlockBlastNetwork(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    iters = 50
    rows = []
    with torch.inference_mode():
        for bs in batch_sizes:
            board = torch.ones((bs, 8, 8), device=dev)
            pieces = torch.ones((bs, 3, 8, 8), device=dev)
            mask = torch.ones((bs, 192), dtype=torch.bool, device=dev)
            net(board, pieces, mask)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                net(board, pieces, mask)
            _sync(dev)
            dt = (time.perf_counter() - t0) / iters
            rows.append({"batch": bs, "latency_ms": dt * 1e3,
                         "samples_per_sec": bs / dt})
    return {"name": "network", "device": device_name(dev), "rows": rows}


def bench_train(num_envs: int = 1024, rollout: int = 64, iters: int = 5,
                network: Optional[Dict[str, Any]] = None,
                device="cuda") -> Dict[str, Any]:
    """PPO iteration throughput (env + policy + update) of the flat CNN at
    `bbx`'s defaults: minibatch ``max(2048, num_envs * rollout // 4)`` and
    10 epochs.  `network` replaces the config's ``network:`` section (the
    default CNN if None).  Returns the rate and each timed iteration's
    metrics as floats."""
    from ..agent.trainer import PPOTrainer

    dev = resolve_device(device)
    config = {
        "training": {"num_envs": num_envs, "rollout_steps": rollout,
                     "batch_size": max(2048, num_envs * rollout // 4)},
        "ppo": {"num_epochs": 10},
    }
    if network is not None:
        config["network"] = network
    trainer = PPOTrainer(config, seed=0, device=dev)
    warm = {k: float(v) for k, v in trainer.iterate().items()}
    t0 = time.perf_counter()
    metrics = [trainer.iterate() for _ in range(iters)]
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    dt = time.perf_counter() - t0
    return {"name": "train", "num_envs": num_envs, "rollout": rollout,
            "minibatch": config["training"]["batch_size"], "epochs": 10,
            "train_env_steps_per_sec": num_envs * rollout * iters / dt,
            "device": device_name(dev), "warmup_metrics": warm,
            "metrics": metrics}


def _print(r: Dict[str, Any]) -> None:
    if r["name"] == "network":
        print(f"network forward ({r['device']}):")
        for row in r["rows"]:
            print(f"  batch {row['batch']:>5}: {row['latency_ms']:.3f} ms  "
                  f"{row['samples_per_sec']:.0f} samples/s")
        return
    keys = [k for k in r if k not in ("name", "windows", "metrics", "warmup_metrics")]
    print(f"{r['name']}: " + "  ".join(
        f"{k}={r[k]:,.1f}" if isinstance(r[k], float) else f"{k}={r[k]}"
        for k in keys))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="bbx_torch benchmarks")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--env", action="store_true")
    ap.add_argument("--vec-env", action="store_true")
    ap.add_argument("--network", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64,
                    help="steps per chunk for the vectorised benchmark")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    run_all = args.all or not any(
        (args.engine, args.env, args.vec_env, args.network, args.train))
    results = []
    if args.engine or run_all:
        results.append(bench_engine(device=device))
    if args.env or run_all:
        results.append(bench_single_env(device=device))
    if args.vec_env or run_all:
        results.append(bench_vec_env(num_envs=args.num_envs, steps=args.steps,
                                     device=device))
    if args.network or run_all:
        results.append(bench_network(device=device))
    if args.train or run_all:
        results.append(bench_train(device=device))
    for r in results:
        _print(r)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
