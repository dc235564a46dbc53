"""Run one benchmark cell once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  The cell, its configuration, its
traffic mix and its metrics are found by name from BENCHMARK.json (see
`perfbench/harness.py`).  Needs a CUDA card: without one it exits with a
non-zero code and prints no result.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Keep every cache this run may write inside the checkout, at fixed paths,
# and keep libraries from loading JAX or Flax on their own.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
