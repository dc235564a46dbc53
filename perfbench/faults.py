"""The timed path broken underneath, to show that `correct` comes out
false, and to read each fault's numbers for setting a cell's limits.

Faults (each a context manager that patches the measured package):

* ``state_unchanged``: every optimizer step returns without touching the
  parameters or the optimizer's state;
* ``half_batch``: the loss of each minibatch is taken over its first half
  of rows, the mean over the rest;
* ``altered_answer``: one answer altered where it is produced: in
  training, lane 0's reward of every engine step the rollout takes; in
  evaluation, lane 0's greedy action, which becomes its lowest-scored
  valid action.

The exchange between chips is not a fault a one-chip cell can have.

    python3 perfbench/faults.py --workload run9-train --seeds 201 202 203 \
        [--after N [--late]] [--out FILE]

With ``--after N`` a training cell's readings are a run's: the first
iteration and, after N more, one later iteration (each number the worse
of the two); with ``--late`` the fault is planted only after set-up, so
that only that later iteration carries it.
"""
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def state_unchanged():
    import torch

    saved = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = saved


@contextlib.contextmanager
def _wrapped(target: str, make):
    from perfbench.instrument import Hooks

    hooks = Hooks(cuda=False)
    hooks.wrap(target, make)
    try:
        yield
    finally:
        hooks.remove()


def half_batch():
    def make(fn):
        def wrapped(config, logits, value, batch, *args, **kwargs):
            h = logits.shape[0] // 2
            return fn(config, logits[:h], value[:h], {k: v[:h] for k, v in batch.items()},
                      *args, **kwargs)
        return wrapped
    return _wrapped("bbx_torch.agent.ppo:ppo_loss", make)


def altered_reward():
    def make(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            reward = out.reward.clone()
            reward[0] += 1.0
            return out._replace(reward=reward)
        return wrapped
    return _wrapped("bbx_torch.agent.ppo:step", make)


def altered_action():
    def make(fn):
        def wrapped(masked):
            import torch

            action = fn(masked)
            valid = masked > -1e8
            worst = torch.where(valid, masked, torch.inf).argmin(dim=-1).to(action.dtype)
            return torch.where(torch.arange(len(action), device=action.device) == 0,
                               torch.where(valid.any(-1), worst, action), action)
        return wrapped
    return _wrapped("bbx_torch.models.distributions:mode", make)


TRAIN_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                "altered_answer": altered_reward}
EVAL_FAULTS = {"altered_answer": altered_action}


def faults_of(cell) -> dict:
    return TRAIN_FAULTS if cell.traffic["driver"] == "train" else EVAL_FAULTS


def readings(cell, seed: int, fault: str, device: str, after: int = 0,
             late: bool = False) -> dict:
    """The program's numbers on one seed with `fault` planted (with
    `late`, only after set-up)."""
    import gc

    from perfbench.drivers import eval as ev
    from perfbench.drivers import train as tr
    from perfbench.reference import judge

    if cell.traffic["driver"] == "train":
        with contextlib.ExitStack() as planted:
            if not late:
                planted.enter_context(faults_of(cell)[fault]())
            trainer, w, buffers, got = tr.prepare(cell.config, cell.traffic, seed, device)
            if late:
                planted.enter_context(faults_of(cell)[fault]())
            later = None
            if after:
                for _ in range(after):
                    trainer.iterate()
                later = tr.capture_later_iteration(trainer)
            del trainer
            gc.collect()
        if later is not None:
            return tr.judge_both(cell.config, seed, (w, buffers, got), later, device)
        return judge.judge_train(cell.config, seed, w, buffers, got, device)["program"]
    with faults_of(cell)[fault]():
        net, w, kw = ev.prepare(cell.config, cell.traffic, device)
        job = ev.job_order(cell.traffic, seed)[0]
        rec = ev.recorded_job(net, job, kw)
    return judge.judge_eval(cell.config["network"], w, job, kw["num_episodes"], rec, device)


def main(argv) -> int:
    import argparse

    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", help="which (default: every fault the cell can have)")
    ap.add_argument("--after", type=int, default=0,
                    help="training: iterations between the first and a later judged one")
    ap.add_argument("--late", action="store_true",
                    help="training: plant the fault only after set-up")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    rows = []
    for fault in args.faults or faults_of(cell):
        for seed in args.seeds:
            t0 = time.perf_counter()
            row = {"workload": args.workload, "fault": fault, "seed": seed,
                   "numbers": readings(cell, seed, fault, args.device, args.after, args.late),
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
