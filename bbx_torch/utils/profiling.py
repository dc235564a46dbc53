"""Profiling and tracing: counterpart of `bbx/utils/profiling.py`.

`trace` records a `torch.profiler` session (the CPU, and the CUDA
activity when a card is present) and writes a Chrome trace into its
directory; it is for looking at, and counts nothing: on the card's machine
the profiler can lose records, so launch counts come from the kernels'
wrappers.  `PhaseTimer` keeps wall-clock totals by phase.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = "bbx-torch-trace"):
    """Profile the block and write ``trace_<pid>.json`` (Chrome trace
    format: Perfetto or chrome://tracing) into `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def _synchronize(tree) -> None:
    """Wait for the devices of the CUDA tensors in `tree` (a tensor, or
    lists, tuples and dicts of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Wall-clock phase accounting (rollout / update / logging ...)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block.  `block_on`: tensors (or lists, tuples and dicts
        of them, read when the block ends, so a list the block fills
        works) whose devices the phase waits for before it stops the
        clock; with None nothing is synchronised."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": v,
                "mean_ms": v / max(self.counts[k], 1) * 1e3,
                "count": self.counts[k],
            }
            for k, v in self.totals.items()
        }

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = ["phase timing:"]
        for k, v in rows:
            lines.append(
                f"  {k:<16} {v:8.2f}s  {v / total * 100:5.1f}%  "
                f"({self.counts[k]}x, {v / max(self.counts[k], 1) * 1e3:.1f} ms)"
            )
        return "\n".join(lines)
