"""The benchmark's own spans around calls into the measured package, and
the reduction of a `torch.profiler` trace.

A hook names a function by ``"<module>:<attribute path>"`` and a kind:

* ``span``: host clock, with the device synchronised at both ends;
* ``host``: host clock alone (what the call costs the host to enqueue);
* ``events``: CUDA events at both ends, read once the window has closed
  (the device time between them).

The function is replaced by a wrapper for as long as the hooks are
installed; hooks on one function stack and come off in reverse order.
"""
from __future__ import annotations

import importlib
import inspect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

KINDS = ("span", "host", "events")
# The idle gaps named by the host operation running in them, longest first.
NAMED_GAPS = 500


def _resolve(target: str):
    module, path = target.split(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Hooks:
    """Installed wrappers and what they recorded."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, List[Tuple]] = defaultdict(list)
        self._undo: List[Callable] = []

    def wrap(self, target: str, make: Callable[[Callable], Callable]) -> None:
        """Replace `target` by ``make(original)`` until `remove`."""
        owner, attr = _resolve(target)
        static = inspect.getattr_static(owner, attr)
        original = getattr(owner, attr)
        wrapper = make(original)
        setattr(owner, attr, staticmethod(wrapper) if isinstance(static, staticmethod)
                else wrapper)
        self._undo.append(lambda: setattr(owner, attr, static))

    def add(self, kind: str, target: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"hook kind {kind!r}: one of {KINDS}")
        if kind == "events" and not self.cuda:
            return
        sync = torch.cuda.synchronize if (kind == "span" and self.cuda) else (lambda: None)

        def make(fn):
            if kind == "events":
                def timed(*args, **kwargs):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                    self._events[target].append((start, end))
                    return out
                return timed

            def spanned(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                self.spans[target].append(time.perf_counter() - t0)
                return out
            return spanned

        self.wrap(target, make)

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def device_ms(self) -> Dict[str, List[float]]:
        """Each events hook's device milliseconds a call (after a sync)."""
        if self._events:
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self._events.items()}


def profile(run_unit: Callable[[], None], cuda: bool) -> dict:
    """Run one unit of work under `torch.profiler` and reduce it: the
    seconds in which a device operation ran (the union of their
    intervals), the traced window's seconds, the top device operations by
    time and the longest idle gaps by the host operation running in them."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_unit()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host, by_op = [], [], defaultdict(float)
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or "#" in e.name:
                continue  # a host-side range drawn on the device's timeline
            dev.append((s, t))
            by_op[e.name] += (t - s) * 1e-6
        elif t > s:
            host.append((s, t, e.name))
    dev.sort()
    busy, gaps, end = 0.0, [], None
    for s, t in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    idle = defaultdict(float)
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, t in gaps[:NAMED_GAPS]:
        mid = (s + t) / 2
        inner = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[inner[np.argmin(ends[inner] - starts[inner])]][2] if inner.size
                else "(no host op)")
        idle[name] += (t - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": wall,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in longest]}}
