"""Engine-rate gate: counterpart of the root `quick_bench.py`.

    bbx-torch-quick-bench [--device cuda]

Times random-policy engine stepping at 16,384 lanes
(`bbx_torch.cli.benchmark.bench_engine`, chunks of 64 steps) and passes
when the rate reaches `GATE_ENV_STEPS_PER_SEC`, a regression bound from
the H100's own record (PERF.md, "quick_bench's bound"): 75% of the lowest
rate that record holds at 16,384 lanes since the step and regen kernels
took their present design, 21.5 M env-steps/s on an NVIDIA H100 80GB
HBM3 at 700.00 W.  The loop is host-bound and its windows often spread
past the benchmark's 20% gate; a measurement that breaks the gate is
made again, up to `ATTEMPTS` measurements in all.

Exit codes: 0 PASS, 1 FAIL (a steady rate under the gate), 2 no steady
measurement in `ATTEMPTS` tries.  Runs on the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

from ..device import device_name, resolve_device
from .benchmark import SpreadError, bench_engine

GATE_ENV_STEPS_PER_SEC = 16_125_000   # 0.75 x 21.5 M (PERF.md)
NUM_ENVS = 16_384                     # the engine benchmark's fleet
ATTEMPTS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Engine-rate regression gate")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    for attempt in range(1, ATTEMPTS + 1):
        try:
            r = bench_engine(num_envs=NUM_ENVS, steps=64, device=device)
            break
        except SpreadError as e:
            print(f"attempt {attempt}: {e.result['env_steps_per_sec']:,.0f} env-steps/s, "
                  f"spread {e.result['rel_spread']:.1%}: not steady")
    else:
        print(f"engine @ {NUM_ENVS} envs on the {device_name(device)}: no steady "
              f"measurement in {ATTEMPTS} attempts (gate {GATE_ENV_STEPS_PER_SEC:,})")
        return 2
    sps = r["env_steps_per_sec"]
    ok = sps >= GATE_ENV_STEPS_PER_SEC
    print(f"engine: {sps:,.0f} env-steps/s @ {NUM_ENVS} envs on the {r['device']} "
          f"(spread {r['rel_spread']:.1%}; {'PASS' if ok else 'FAIL'} -- gate "
          f"{GATE_ENV_STEPS_PER_SEC:,})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
