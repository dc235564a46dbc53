"""Agent interface: counterpart of `bbx/agent/base.py`."""
from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import numpy as np


class BaseAgent(abc.ABC):
    """Minimal agent contract: act and persist.  As in bbx, there is no
    per-agent `update`: training runs through `bbx_torch.agent.ppo.update`
    inside the trainer's iteration."""

    def __init__(self):
        self.training = True

    @abc.abstractmethod
    def select_action(self, observation: Dict[str, np.ndarray],
                      deterministic: bool = False) -> Tuple[int, Dict[str, Any]]:
        ...

    @abc.abstractmethod
    def save(self, path: str) -> None:
        ...

    @abc.abstractmethod
    def load(self, path: str) -> None:
        ...

    def train(self) -> None:
        self.training = True

    def eval(self) -> None:
        self.training = False
