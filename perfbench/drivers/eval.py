"""Traffic driver ``eval``: checkpoint evaluation as a closed loop.

One client runs eval jobs back to back and waits on each result, as the
eval CLI and the trainer's evals do.  A job is the program's
`evaluate_policy` on one checkpoint: ``episodes`` games in parallel
lanes, greedy (or sampled) actions, polled every ``chunk`` steps until
every game has ended.  The checkpoint's weights are drawn once from the
mix's ``checkpoint_seed``, as a user evaluates one checkpoint; the mix
holds a pool of ``jobs`` piece seeds, and the run's seed shuffles it and
picks the job that is judged.  The window plays the pool over and over
in that order, so every seed gives the same work: how many 64-step
chunks a job takes follows the longest of its games, and weights drawn
from the run's seed made 9% to 23% of a window's jobs take a second
chunk (NVIDIA H100 80GB HBM3).  Set-up runs one job (the warm-up); the window
runs jobs until the host clock passes the run's seconds.
`eval_episodes_per_s` is every completed episode of the window's jobs
over the window's seconds.  One job of the first ``sample_from`` of the
window, drawn from the seed, is recorded step by step for the
comparison.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import List


def job_order(traffic: dict, seed: int) -> List[int]:
    """The piece seeds of the pool's jobs, in the order the run plays them."""
    import torch

    order = torch.randperm(traffic["jobs"], generator=torch.Generator().manual_seed(seed))
    return [traffic["checkpoint_seed"] * 1_000_003 + int(i) + 1 for i in order]


def prepare(config: dict, traffic: dict, device: str):
    """(network with the checkpoint's weights, the weights, a job's
    keyword arguments)."""
    import torch

    from bbx_torch.models import network_from_config

    from .. import weights

    seed = traffic["checkpoint_seed"]
    net = network_from_config(config["network"],
                              generator=torch.Generator().manual_seed(seed)).to(device)
    w = weights.draw(net, seed)
    kw = dict(num_episodes=traffic["episodes"], deterministic=traffic["deterministic"],
              chunk=traffic["chunk"], max_steps=traffic["max_steps"], device=device)
    return net, w, kw


def recorded_job(net, seed: int, kw: dict) -> dict:
    """One job with its actions, rewards and game-over flags recorded at
    every step, and its statistics."""
    from bbx_torch.cli import evaluate as EV

    from ..instrument import Hooks

    rec = {"actions": [], "reward": [], "done": []}

    def on_step(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            for k, x in zip(rec, (args[1], out.reward, out.done)):
                rec[k].append(x.clone())
            return out
        return wrapped

    hooks = Hooks(cuda=False)
    hooks.wrap("bbx_torch.cli.evaluate:step", on_step)
    try:
        rec["stats"] = EV.evaluate_policy(net, seed=seed, **kw)
    finally:
        hooks.remove()
    return rec


def run(r) -> None:
    import torch

    from bbx_torch.cli import evaluate as EV

    from ..reference.judge import judge_eval

    t = r.traffic
    r.mark("imported")
    net, w, kw = prepare(r.config, t, r.device)
    r.mark("network built, weights drawn")
    order = job_order(t, r.seed)

    def job(j):
        return EV.evaluate_policy(net, seed=order[j % len(order)], **kw)

    job(-1)
    r.mark("first job run")
    sample = int(torch.randint(t["sample_from"], (),
                               generator=torch.Generator().manual_seed(r.seed)))
    rec = None

    sync = torch.cuda.synchronize if r.cuda else (lambda: None)
    sync()
    t0 = r.start_window()
    jobs = moves = episodes = failed = 0
    while True:
        if jobs == sample:
            rec = recorded_job(net, order[jobs], kw)
            res = rec["stats"]
        else:
            res = job(jobs)
        jobs += 1
        moves += round(res["length_mean"] * res["completed"])
        episodes += res["completed"]
        failed += res["completed"] < t["episodes"]
        if time.perf_counter() - t0 >= r.seconds and jobs > sample:
            break
    sync()
    r.end_window(t0)
    r.units = r.attempted = jobs
    print(f"window: {jobs} jobs, {episodes} episodes, {moves} moves in {r.window_s:.3f} s",
          file=sys.stderr)
    r.failed = failed
    r.values["eval_episodes_per_s"] = episodes / r.window_s
    r.profile_unit(lambda: job(jobs))
    if r.cuda:
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del net
    gc.collect()
    if r.cuda:
        torch.cuda.empty_cache()
    r.checks = judge_eval(r.config["network"], w, order[sample], t["episodes"],
                          rec, r.device)
