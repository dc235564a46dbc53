"""The program's own spans and counts, read by the per-layer metrics
whose source is ``program_span`` or ``program_counter``.

`bbx_torch.utils.profiling.TRACER` is the program's tracer: the program
opens spans and counts at its layers' boundaries (PERF.md, section 3).
Importing this module turns it on, and the harness imports a cell's
readers, and so this module, only in a traced run.  After the run,
`window` reads the tracer once and keeps the spans whose host start lies
in the measured window, from ``run.t0 + run.setup_s`` for
``run.window_s`` seconds, on the clock the window is taken on.  A program
without the tracer leaves its readers nothing to read: each returns None.
"""
from __future__ import annotations

from typing import List, Optional

from bbx_torch.utils import profiling

TRACER = getattr(profiling, "TRACER", None)
if TRACER is not None:
    TRACER.enable()


def window(run) -> Optional[List[dict]]:
    """The spans of the run's window (the tracer's records: name, id,
    parent, root, host start and end, device ms or None, attributes,
    counts), read once a run; None without the tracer."""
    if TRACER is None:
        return None
    if getattr(run, "program_spans", None) is None:
        start = run.t0 + run.setup_s
        run.program_spans = [s for s in TRACER.snapshot(clear=True)["spans"]
                             if start <= s["start"] < start + run.window_s]
    return run.program_spans


def named(run, name: str) -> List[dict]:
    return [s for s in window(run) or () if s["name"] == name]


def device_ms(run, name: str) -> Optional[float]:
    """Mean device milliseconds of the window's spans `name` (None where
    they have no device time: no card, or no such span)."""
    ms = [s["device_ms"] for s in named(run, name) if s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None


def host_us_per(run, name: str, per: str) -> Optional[float]:
    """Host microseconds of the window's spans `name`, summed, over the
    number of its spans `per`."""
    spans, units = named(run, name), len(named(run, per))
    if not spans or not units:
        return None
    return sum(s["end"] - s["start"] for s in spans) / units * 1e6


def count(run, name: str) -> int:
    """Count `name` summed over the window's spans."""
    return sum(s["counts"].get(name, 0) for s in window(run) or ())
