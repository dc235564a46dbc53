"""Checkpoints as `torch.save` files, with a JSON config sidecar.

A checkpoint is a dict ``{"params": state_dict, ...}`` saved under
``directory/name``; ``<checkpoint>.config.json`` beside it holds the config
sections needed to rebuild the network (at least ``network:``), the file
`bbx/cli/evaluate.py:config_for_checkpoint` also reads.

Every payload carries ``FORMAT_KEY: FORMAT_VERSION``, the version of the
parameters' layout, and `load_checkpoint` refuses a payload without it or
with another version: a payload saved before the marker existed may hold
`evaluator.dense0`'s rows in NCHW order, and would load without error and
score afterstates wrongly.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

FORMAT_KEY = "bbx_torch_format"
# 1: `evaluator.dense0` keeps Flax's (h, w, c) rows (the evaluator runs
# channels-last); the value head's Dense rows after the flatten are NCHW.
FORMAT_VERSION = 1


def save_checkpoint(directory: str, name: str, payload: Dict[str, Any],
                    config: Optional[Dict[str, Any]] = None) -> str:
    """Save `payload` under `directory/name` (tensors moved to the CPU, the
    format marker added) and, if given, `config` as the sidecar.  Returns
    the checkpoint's path."""
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({**_to_cpu(payload), FORMAT_KEY: FORMAT_VERSION}, path)
    if config is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(config, f, indent=2)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint onto the CPU (tensors and plain containers only).

    Raises ValueError for a payload whose format marker is missing or is
    not `FORMAT_VERSION`."""
    payload = torch.load(os.path.abspath(path), map_location="cpu",
                         weights_only=True)
    version = payload.get(FORMAT_KEY) if isinstance(payload, dict) else None
    if version is None:
        raise ValueError(
            f"checkpoint {path} has no {FORMAT_KEY!r} marker: it was saved "
            f"before the marker existed, and its evaluator.dense0 rows may be "
            f"in NCHW order, which this version would read wrongly; train it "
            f"again or convert its weights from Flax")
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint {path} has format {version!r}; this "
                         f"version of bbx_torch reads format {FORMAT_VERSION}")
    return payload


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
