"""Model utilities: counterpart of `bbx/models/utils.py`.

Checkpoint I/O lives in `bbx_torch.utils.checkpoints`; this module carries
the summaries, early stopping, the global gradient norm and clipping by
it, written as optax computes them.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from .network import count_parameters


def get_model_summary(module: nn.Module, name: str = "model") -> str:
    """Human-readable parameter summary: one line per parameter, then the
    total."""
    lines = [f"{name} summary", "-" * 40]
    for key, p in module.named_parameters():
        lines.append(f"{key:<48} {str(tuple(p.shape)):<18} {p.numel():,}")
    lines.append("-" * 40)
    lines.append(f"total parameters: {count_parameters(module):,}")
    return "\n".join(lines)


class EarlyStopping:
    """Patience-based early stopping."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0,
                 mode: str = "max"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: expected 'min' or 'max'")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, value: float) -> bool:
        if self.best is None:
            self.best = value
            return False
        improved = (value > self.best + self.min_delta if self.mode == "max"
                    else value < self.best - self.min_delta)
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def reset(self) -> None:
        self.best, self.counter, self.should_stop = None, 0, False


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of a set of gradients (optax's `global_norm`), a
    0-dim tensor on their device."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's `clip_by_global_norm`, in place and without a host sync:
    each g becomes ``(g / ||g||) * max_norm`` unless ``||g|| < max_norm``
    (the norm in float32, as the grads are)."""
    grads = list(grads)
    norm = global_grad_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def gradient_clipper(max_norm: float = 0.5) -> Callable[[Iterable[torch.Tensor]], None]:
    """Global-norm gradient clipping as a reusable in-place transform (the
    counterpart of bbx's optax `clip_by_global_norm` transform)."""
    return lambda grads: clip_by_global_norm_(grads, max_norm)
