"""One run of one cell, driven by data.

BENCHMARK.json names each cell's configuration, traffic mix and metrics.
Everything that belongs to one of them is a file of its own, found by name:

* a configuration: the ``file`` its entry names (``perfbench/configs/``);
* a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``driver``
  names a module ``perfbench/drivers/<driver>.py`` that reads its
  parameters and runs set-up, the window and the comparison;
* a per-layer metric: ``perfbench/metrics/<name>.py``, a reader with the
  hooks it needs (`perfbench/instrument.py`) and ``read(run)``, which
  returns the metric or None where it finds nothing to read;
* a cell's limits on the numbers that decide `correct`:
  ``perfbench/limits/<cell>.json``.

An end-to-end metric named ``<x>.<group>`` reads the driver's ``<x>``.

So a cell, a configuration, a mix or a metric is added by adding files and
entries, without editing a file that is there.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bbx")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its files read."""

    def __init__(self, bench: dict, name: str, root: str = ROOT, own_files: bool = True):
        """`own_files` False: read neither the traffic's file nor the
        limits' (a cell of the tests' own, which brings both)."""
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = _json(os.path.join(root, conf["file"]))
        self.traffic = self.limits = {}
        if own_files:
            self.traffic = _json(os.path.join(root, "perfbench", "traffic",
                                              self.entry["traffic"] + ".json"))
            self.limits = _json(os.path.join(root, "perfbench", "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def reader(name: str):
    """The module of per-layer metric `name` (``perfbench/metrics/<name>.py``)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a driver and the metric readers share about one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t0: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t0 = device, t0
        self.cuda = device.startswith("cuda")
        self.config, self.traffic = cell.config, cell.traffic
        self.values: Dict[str, float] = {}     # end-to-end metrics by name
        self.setup_s: Optional[float] = None
        self.window_s = 0.0                    # the measured window's seconds
        self.units = 0                         # iterations or jobs in the window
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.checks: Dict[str, float] = {}     # the numbers that decide `correct`
        self.profile: Optional[dict] = None
        self.search_width = 0                  # simulated lanes a lane a step
        self.spans: Dict[str, List[float]] = {}
        self.device_ms: Dict[str, List[float]] = {}
        self.readers = {m["name"]: reader(m["name"]) for m in cell.per_layer} if trace else {}
        self._hooks = None

    def mark(self, what: str) -> None:
        """Note on standard error how far set-up has come (seconds since
        the process started)."""
        print(f"setup: {what} at {time.perf_counter() - self.t0:.3f} s", file=sys.stderr)

    def start_window(self) -> float:
        """Set-up ends here: install the traced run's hooks and return the
        window's start on the host clock."""
        if self.trace:
            from .instrument import Hooks

            self._hooks = Hooks(self.cuda)
            seen = set()
            for mod in self.readers.values():
                for hook in getattr(mod, "HOOKS", ()):
                    if hook not in seen:
                        seen.add(hook)
                        self._hooks.add(*hook)
        now = time.perf_counter()
        self.setup_s = now - self.t0
        return now

    def end_window(self, start: float) -> None:
        """The window has closed (the device synchronised): record its
        length and take the hooks off."""
        self.window_s = time.perf_counter() - start
        if self._hooks is not None:
            self.device_ms = self._hooks.device_ms()
            self.spans = dict(self._hooks.spans)
            self._hooks.remove()

    def profile_unit(self, unit: Callable[[], None]) -> None:
        """In a traced run, one more unit of work under the profiler."""
        if self.trace:
            from .instrument import profile

            self.profile = profile(unit, self.cuda)


def _device(run: Run) -> dict:
    import torch

    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
           "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
    return dev


# A core held by a run: an abstract socket of this name per core, which
# the kernel frees when the process ends, so that runs started side by
# side (from any checkout) never share a core.
CORE_LOCK = "perfbench-core-{}"


def _core_times(cores) -> Dict[int, int]:
    """Each core's busy jiffies so far, from /proc/stat."""
    out = {}
    try:
        with open("/proc/stat") as f:
            for line in f:
                name, *vals = line.split()
                if name.startswith("cpu") and name[3:].isdigit() and int(name[3:]) in cores:
                    v = [int(x) for x in vals]
                    out[int(name[3:])] = sum(v) - v[3] - v[4]  # less idle and iowait
    except OSError:
        pass
    return out


def take_core() -> Optional[socket.socket]:
    """Pin this process to one core of its own affinity set that no other
    run holds, the least busy over a short look, and return the socket
    that holds it for the process's life (None where nothing could be
    pinned).  The host-bound parts of the cells (the rollout, the eval
    loop) spread far less on one core than moved between several."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    cores = sorted(os.sched_getaffinity(0))
    before = _core_times(cores)
    time.sleep(0.2)
    after = _core_times(cores)
    busy = {c: after.get(c, 0) - before.get(c, 0) for c in cores}
    for core in sorted(cores, key=lambda c: (busy[c], c)):
        held = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            held.bind("\0" + CORE_LOCK.format(core))
        except OSError:
            held.close()
            continue
        os.sched_setaffinity(0, {core})
        return held
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def decide(numbers: Dict[str, float], limits: dict):
    """(each number beside its limit, whether every compared number is
    within its limit).  A number whose limit the file gives as null is
    reported and not compared (PERF.md gives each one's readings and
    why).  A number the file does not list fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    compared = [c for k, c in checks.items() if k not in limits or c["limit"] is not None]
    return checks, bool(compared) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in compared)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, root: str = ROOT,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             bench: Optional[dict] = None, limits: Optional[dict] = None) -> dict:
    """Run the cell once; return its result line as a dict.  `config`,
    `traffic` and `limits` take the place of the cell's files (the CPU
    tests' small shapes and cells of their own, which give all three)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(bench or load_benchmark(root), workload, root, limits is None)
    cell.config = config or cell.config
    cell.traffic = traffic or cell.traffic
    cell.limits = limits if limits is not None else cell.limits
    run = Run(cell, seed, seconds, trace, device, t0)
    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    driver.run(run)
    units = {m["name"]: m["unit"] for m in (cell.end_to_end + cell.per_layer)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = run.readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        run.values["setup_s"] = run.setup_s
        # An end-to-end metric `<x>.<group>` is the driver's `<x>` in the
        # cells it lists: a group of cells whose runs spread apart from the
        # others' gets a bound of its own.
        metrics = {m["name"]: {"value": run.values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks, correct = decide(run.checks, cell.limits)
    correct = correct and run.failed == 0
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": _device(run)}
    if trace and run.profile is not None:
        out["breakdown"] = run.profile["breakdown"]
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = Cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    # One process on one core of its own, and so one intra-op thread: more
    # would only take turns on that core.
    held = take_core()
    if held is not None:
        torch.set_num_threads(1)
    print(f"core: {sorted(os.sched_getaffinity(0)) if held else 'not pinned'}",
          file=sys.stderr)
    out = run_cell(args.workload, args.seed % 2**62, args.seconds, bool(args.trace),
                   "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}, which the benchmark forbids",
              file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
