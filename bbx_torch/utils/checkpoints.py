"""Checkpoints as `torch.save` files, with a JSON config sidecar.

A checkpoint is a dict ``{"params": state_dict, ...}`` saved under
``directory/name``; ``<checkpoint>.config.json`` beside it holds the config
sections needed to rebuild the network (at least ``network:``), the file
`bbx/cli/evaluate.py:config_for_checkpoint` also reads.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(directory: str, name: str, payload: Dict[str, Any],
                    config: Optional[Dict[str, Any]] = None) -> str:
    """Save `payload` under `directory/name` (tensors moved to the CPU) and,
    if given, `config` as the sidecar.  Returns the checkpoint's path."""
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_cpu(payload), path)
    if config is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(config, f, indent=2)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint onto the CPU (tensors and plain containers only)."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)


def latest_step_checkpoint(directory: str) -> Optional[str]:
    """The highest-step ``checkpoint_<step>`` file in `directory` (its
    ``.config.json`` sidecar aside), or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for entry in os.listdir(directory):
        head, _, step = entry.rpartition("_")
        if head != "checkpoint" or not step.isdigit():
            continue
        if int(step) > best_step:
            best, best_step = entry, int(step)
    return os.path.join(directory, best) if best else None
