"""Logging: JSONL event log, TensorBoard, rolling metric windows.

Counterpart of `bbx/utils/logging.py`, with the same API: `Logger` (JSONL
+ summary), `TensorBoardLogger` (a silent no-op without tensorboard),
`MetricsTracker` (rolling window stats).  ``enabled`` is the only gate
on writing: the trainer enables them on rank 0 alone, as bbx enables them
on its primary process.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from datetime import datetime
from typing import Any, Dict, Optional


class Logger:
    """Append-per-call JSONL logger with in-memory history."""

    def __init__(self, log_dir: str, name: str = "train",
                 console: bool = True, enabled: bool = True):
        self.log_dir = log_dir
        self.name = name
        self.console = console
        self.enabled = enabled
        self.history: Dict[str, list] = defaultdict(list)
        self.start_time = time.time()
        self.log_file = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            self.log_file = os.path.join(log_dir, f"{name}_{ts}.jsonl")

    def log(self, metrics: Dict[str, Any], step: int,
            console: Optional[bool] = None) -> None:
        record = {
            "step": step,
            "time": time.time() - self.start_time,
            "timestamp": datetime.now().isoformat(),
        }
        for k, v in metrics.items():
            v = float(v) if hasattr(v, "__float__") else v
            record[k] = v
            self.history[k].append((step, v))
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
        if (console if console is not None else self.console):
            self._print(record)

    def _print(self, record: Dict[str, Any]) -> None:
        parts = [f"step={record['step']}"]
        for k, v in record.items():
            if k in ("step", "time", "timestamp"):
                continue
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}")
        print(" | ".join(parts), flush=True)

    def get_mean(self, key: str, last_n: Optional[int] = None) -> float:
        vals = [v for _, v in self.history.get(key, [])]
        if last_n:
            vals = vals[-last_n:]
        return sum(vals) / len(vals) if vals else 0.0

    def get_recent(self, key: str, n: int = 1):
        return [v for _, v in self.history.get(key, [])[-n:]]

    def save_summary(self) -> Optional[str]:
        """End-of-run per-metric summary JSON."""
        if not self.log_file:
            return None
        summary = {}
        for k, pairs in self.history.items():
            vals = [v for _, v in pairs if isinstance(v, (int, float))]
            if not vals:
                continue
            n = len(vals)
            mean = sum(vals) / n
            var = sum((v - mean) ** 2 for v in vals) / n
            summary[k] = {
                "mean": mean, "std": var ** 0.5,
                "min": min(vals), "max": max(vals), "last": vals[-1],
            }
        path = os.path.join(self.log_dir, f"{self.name}_summary.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=2)
        return path


class TensorBoardLogger:
    """Optional SummaryWriter wrapper; silent no-op without tensorboard."""

    def __init__(self, log_dir: str, name: str = "train", enabled: bool = True):
        self.writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.writer = SummaryWriter(os.path.join(log_dir, "tb", f"{name}_{ts}"))

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer:
            self.writer.add_scalar(tag, float(value), step)

    def log_scalars(self, tag: str, values: Dict[str, float], step: int) -> None:
        if self.writer:
            self.writer.add_scalars(
                tag, {k: float(v) for k, v in values.items()}, step
            )

    def log_histogram(self, tag: str, values, step: int) -> None:
        if self.writer:
            self.writer.add_histogram(tag, values, step)

    def log_text(self, tag: str, text: str, step: int) -> None:
        if self.writer:
            self.writer.add_text(tag, text, step)

    def close(self) -> None:
        if self.writer:
            self.writer.close()


class MetricsTracker:
    """Rolling-window mean/std/min/max/last."""

    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self.metrics: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window_size)
        )

    def add(self, key: str, value: float) -> None:
        self.metrics[key].append(float(value))

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.add(k, v)

    def update_many(self, key: str, values) -> None:
        for v in values:
            self.add(key, v)

    def values(self, key: str) -> list:
        """Current window contents, oldest first (for checkpoint/resume)."""
        return list(self.metrics.get(key, ()))

    def get_mean(self, key: str) -> float:
        vals = self.metrics.get(key)
        return sum(vals) / len(vals) if vals else 0.0

    def get_std(self, key: str) -> float:
        vals = self.metrics.get(key)
        if not vals:
            return 0.0
        m = sum(vals) / len(vals)
        return (sum((v - m) ** 2 for v in vals) / len(vals)) ** 0.5

    def get_min(self, key: str) -> float:
        vals = self.metrics.get(key)
        return min(vals) if vals else 0.0

    def get_max(self, key: str) -> float:
        vals = self.metrics.get(key)
        return max(vals) if vals else 0.0

    def get_last(self, key: str) -> float:
        vals = self.metrics.get(key)
        return vals[-1] if vals else 0.0

    def get_stats(self, key: str) -> Dict[str, float]:
        return {
            "mean": self.get_mean(key), "std": self.get_std(key),
            "min": self.get_min(key), "max": self.get_max(key),
            "last": self.get_last(key),
        }
