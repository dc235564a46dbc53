"""Profiling and tracing: counterpart of `bbx/utils/profiling.py`.

`TRACER`, a `PhaseTimer`, is the program's one tracer.  The program's
layers open spans on it (`span`) and count on it (`count`) at their
boundaries; it is off by default, and then each site costs one flag check
and gets the shared no-op context back (no clock read, no CUDA event, no
`record_function`, no device op).  Once on (`enable`):

* a span records its name, an id, the id of the span open around it (its
  parent) and of the outermost open span (its root: an iteration, an eval
  job), its host start and end on `time.perf_counter` (the clock the
  benchmark's window is taken on) and its attributes; a span marked
  ``device`` also records a pair of CUDA events on the current stream,
  read only when the records are read, after a synchronise;
* `count(name, value)` adds an int, or a 0-dim tensor summed on its
  device, to the innermost open span;
* while a `torch.profiler` session is active, each span also opens
  `torch.profiler.record_function` of its name, so that the program's
  phases lie on the profiler's timeline beside the kernels.

Records stay in memory until `snapshot` reads them.  Spans nest in the
order they are opened: one thread traces at a time.  The launch counters
of the kernels' wrappers (``<wrapper>.launches``) stay where they are and
are read into the snapshot as ``launches.<wrapper>``.

`trace` records a `torch.profiler` session (the CPU, and the CUDA activity
when a card is present), writes a Chrome trace into its directory and puts
each idle gap of the device down to the innermost program span covering
it (`idle_by_span`).  On the card's machine the profiler can lose records,
so launch counts come from the kernels' wrappers.  `PhaseTimer.phase`
keeps wall-clock totals by phase, synchronised on request.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# The kernels' wrappers that count their launches: "<module>:<function>".
LAUNCH_COUNTERS = (
    "bbx_torch.engine.solvability:valid3_bits",
    "bbx_torch.engine.solvability:solvable_disjoint_bits",
    "bbx_torch.engine.solvability:solvable_exact_bits",
    "bbx_torch.engine.step:_move_core",
    "bbx_torch.engine.step:_step_finish_cuda",
    "bbx_torch.engine.state:regen_pieces",
    "bbx_torch.env.vector:sample_valid_actions_device",
    "bbx_torch.models.afterstate:afterstate_buffer",
    "bbx_torch.models.afterstate:evaluator_scores",
    "bbx_torch.models.afterstate:_evaluator_grad_tiles",
    "bbx_torch.models.afterstate:_evaluator_grad_dense0",
    "bbx_torch.models.afterstate:_evaluator_grad_reduce",
    "bbx_torch.agent.ppo:compute_gae",
)
# The name of device idle time that no program span covers.
NO_SPAN = "(no span)"
_NULL = contextlib.nullcontext()


def _profiler_active() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    """One span while open, and its record once closed."""

    __slots__ = ("tracer", "name", "id", "parent", "root", "start", "end", "attrs",
                 "counts", "events", "annotation")

    def __init__(self, tracer: "PhaseTimer", name: str, device: bool, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.id = next(tracer._ids)
        self.counts = self.annotation = None
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device and torch.cuda.is_initialized() else None)

    def __enter__(self):
        stack = self.tracer._stack
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        if _profiler_active():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
            self.tracer._annotated.add(self.name)
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.tracer._stack.pop()
        self.tracer._done.append(self)
        return False

    def record(self) -> Dict[str, Any]:
        """The span as plain values (its events read: synchronise first)."""
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start": self.start, "end": self.end,
                "device_ms": (self.events[0].elapsed_time(self.events[1])
                              if self.events is not None else None),
                "attrs": self.attrs,
                "counts": {k: _number(v) for k, v in (self.counts or {}).items()}}


def _number(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _add(into: Dict[str, Any], name: str, value) -> None:
    into[name] = into[name] + value if name in into else value


class PhaseTimer:
    """Wall-clock phase accounting (rollout / update / logging ...), and
    the spans and counts of the program's tracer (module docstring)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.enabled = False
        self._ids = itertools.count(1)
        self._stack: List[_Span] = []
        self._done: List[_Span] = []
        self._loose: Dict[str, Any] = {}   # counts made with no span open
        self._annotated: set = set()       # names opened under the profiler

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

    # ---- the tracer ------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str, device: bool = False, **attrs):
        """A context that records the block as a span (module docstring);
        the shared no-op context while the tracer is off."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, device, attrs)

    def count(self, name: str, value) -> None:
        """Add `value` (an int, or a 0-dim tensor, summed on its device) to
        count `name` of the innermost open span; nothing while off."""
        if not self.enabled:
            return
        if self._stack:
            top = self._stack[-1]
            if top.counts is None:
                top.counts = {}
            _add(top.counts, name, value)
        else:
            _add(self._loose, name, value)

    def snapshot(self, clear: bool = False) -> Dict[str, Any]:
        """The closed spans as records (``spans``: name, id, parent, root,
        host start and end, device ms or None, attributes, counts) and
        every count by name (``counts``: the spans' and those made with no
        span open, summed, and ``launches.<wrapper>`` of each kernel
        wrapper loaded).  Synchronises where a device span is to be read.
        `clear` drops what was read."""
        done = self._done
        if any(s.events is not None for s in done):
            torch.cuda.synchronize()
        spans = [s.record() for s in done]
        counts: Dict[str, Any] = {k: _number(v) for k, v in self._loose.items()}
        for s in spans:
            for k, v in s["counts"].items():
                _add(counts, k, v)
        counts.update(_launch_counts())
        if clear:
            self._done, self._loose = [], {}
        return {"spans": spans, "counts": counts}


def _launch_counts() -> Dict[str, int]:
    """``launches.<wrapper>`` of each counting wrapper whose module is
    loaded (a module not loaded has launched nothing)."""
    out = {}
    for target in LAUNCH_COUNTERS:
        module, name = target.split(":")
        mod = sys.modules.get(module)
        if mod is not None:
            out["launches." + name] = getattr(mod, name).launches
    return out


# The program's one tracer, and its switch, sites and records.
TRACER = PhaseTimer()
enable, disable, span, count, snapshot = (TRACER.enable, TRACER.disable, TRACER.span,
                                          TRACER.count, TRACER.snapshot)


def span_totals(spans: Sequence[dict], into: Optional[dict] = None) -> dict:
    """Calls, host seconds and device milliseconds of snapshot records by
    path (the names from the root span down), added into `into`."""
    into = {} if into is None else into
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        path, parent = [s["name"]], s["parent"]
        while parent in by_id:
            path.append(by_id[parent]["name"])
            parent = by_id[parent]["parent"]
        row = into.setdefault(tuple(reversed(path)), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s["end"] - s["start"]
        row[2] += s["device_ms"] or 0.0
    return into


def span_report(totals: dict) -> str:
    """The phase report of `span_totals`: a row a path, children under
    their parent, each with its host seconds, its share of the root spans'
    host seconds and its calls, host ms a call and, for a device span,
    device ms a call."""
    roots = sum(row[1] for path, row in totals.items() if len(path) == 1) or 1.0
    lines = ["phase timing:"]
    for path in sorted(totals):
        n, host, dev = totals[path]
        label = "  " * len(path) + path[-1]
        row = (f"{label:<36} {host:9.3f}s {host / roots * 100:5.1f}%  "
               f"({n}x, {host / n * 1e3:.3f} ms")
        lines.append(row + (f"; device {dev / n:.3f} ms)" if dev else ")"))
    return "\n".join(lines)


def idle_by_span(device: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[float, float, str]]) -> Dict[str, Any]:
    """Each idle gap between device operations, put down to the innermost
    (shortest) program span covering its midpoint, or `NO_SPAN`.

    `device`: (start, end) of each device operation; `spans`: (start,
    end, name) of the program's spans, on the same clock in microseconds.
    Returns the device's busy seconds (the union of its operations), its
    idle seconds between its first and last operation, and
    ``by_span``: [name, idle seconds] pairs, longest first."""
    busy, gaps, end = 0.0, [], None
    for s, t in sorted(device):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    starts = np.array([s[0] for s in spans], dtype=np.float64)
    ends = np.array([s[1] for s in spans], dtype=np.float64)
    idle: Dict[str, float] = {}
    for s, t in gaps:
        mid = (s + t) / 2
        inner = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (spans[inner[np.argmin(ends[inner] - starts[inner])]][2] if inner.size
                else NO_SPAN)
        idle[name] = idle.get(name, 0.0) + (t - s) * 1e-6
    return {"busy_s": busy * 1e-6, "idle_s": sum(idle.values()),
            "by_span": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])}


def _timeline(events, names) -> tuple:
    """The device operations and the program's spans of a profiler's
    events, in microseconds (`idle_by_span`'s arguments)."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or "#" in e.name):
                device.append((s, t))  # not a host range drawn on the device
        elif e.name in names:
            spans.append((s, t, e.name))
    return device, spans


class Trace:
    """What `trace` recorded: its directory and, once the block has ended,
    `idle_by_span`'s reduction of the session (`idle`)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.idle: Optional[Dict[str, Any]] = None

    def report(self) -> str:
        idle = self.idle or {"busy_s": 0.0, "idle_s": 0.0, "by_span": []}
        lines = [f"idle by span: device busy {idle['busy_s']:.4f} s, idle "
                 f"{idle['idle_s']:.4f} s between its first and last operation"]
        for name, s in idle["by_span"]:
            share = s / idle["idle_s"] * 100 if idle["idle_s"] else 0.0
            lines.append(f"  {name:<34} {s:9.4f}s {share:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "bbx-torch-trace"):
    """Profile the block with the tracer on, write ``trace_<pid>.json``
    (Chrome trace format: Perfetto or chrome://tracing) into `log_dir`,
    and yield a `Trace` whose `idle` holds, after the block, the device's
    idle gaps by program span."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(log_dir)
    was_on = TRACER.enabled
    TRACER.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield out
            if cuda:
                torch.cuda.synchronize()
    finally:
        TRACER.enabled = was_on
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
    out.idle = idle_by_span(*_timeline(prof.events(), TRACER._annotated))


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
