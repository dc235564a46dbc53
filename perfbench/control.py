"""Readings of the numbers that decide a cell's `correct`, for setting
its limits: the program's on each seed, and the control's (the reference
itself in fp8, in the program's place) on the same seeds.

    python3 perfbench/control.py --workload run9-train --seeds 1 2 3 [--out FILE]

Training cells need no window: each seed builds the trainer, runs its
first iteration and judges it.  The eval cell plays one job a seed at
the cell's own size.  Every seed runs in this one process.  Prints one
JSON object per seed and, with ``--out``, writes them all.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def readings(cell, seed: int, device: str) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    import gc

    import torch

    from perfbench.drivers import eval as ev
    from perfbench.drivers import train as tr
    from perfbench.reference import judge

    driver = cell.traffic["driver"]
    if driver == "train":
        trainer, w, buffers, got = tr.prepare(cell.config, cell.traffic, seed, device)
        del trainer
        gc.collect()
        return judge.judge_train(cell.config, seed, w, buffers, got, device, control=True)
    net, w, kw = ev.prepare(cell.config, cell.traffic, device)
    job = ev.job_order(cell.traffic, seed)[0]
    rec = ev.recorded_job(net, job, kw)
    program = judge.judge_eval(cell.config["network"], w, job, kw["num_episodes"], rec, device)
    steps = len(rec["actions"])
    del net
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    with judge.float32_exact():
        played = judge.play_control(cell.config["network"], w, job, kw["num_episodes"],
                                    steps, device)
    return {"program": program,
            "control": judge.judge_eval(cell.config["network"], w, job,
                                        kw["num_episodes"], played, device)}


def main(argv) -> int:
    import argparse

    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, **readings(cell, seed, args.device),
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
