"""Device helpers and seeding: counterpart of `bbx/utils/device.py`.

`bbx_torch.device` resolves a device name (`resolve_device`, which raises
for a CUDA device without a card); these helpers check, seed, describe and
tidy it.  The process count and index are those of the `torch.distributed`
group (`bbx_torch.parallel`), 1 and 0 without one.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..parallel.distributed import rank, world_size


def get_device(device="cuda") -> torch.device:
    """`device` resolved, after a smoke-test matmul on it."""
    dev = resolve_device(device)
    x = torch.ones((8, 8), dtype=torch.float32, device=dev)
    if float((x @ x)[0, 0]) != 8.0:
        raise RuntimeError(f"smoke-test matmul on {dev} gave a wrong result")
    return dev


def set_seed(seed: int, device="cuda") -> torch.Generator:
    """Seed `random`, numpy and torch, and return a `torch.Generator` on
    `device` seeded `seed` (the counterpart of bbx's root key)."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def get_device_info(device="cuda") -> Dict[str, Any]:
    """Platform and topology summary, under bbx's keys."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        return {
            "platform": "gpu",
            "device_kind": device_name(dev),
            "num_devices": n,
            "num_processes": world_size(),
            "process_index": rank(),
            "devices": [f"cuda:{i}" for i in range(n)],
        }
    return {"platform": "cpu", "device_kind": "cpu", "num_devices": 1,
            "num_processes": world_size(), "process_index": rank(),
            "devices": ["cpu"]}


def memory_stats(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The card's memory in bytes and GB, under bbx's keys; {} for the CPU."""
    dev = resolve_device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return {}
    stats = {"bytes_in_use": torch.cuda.memory_allocated(dev),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
             "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
    out = {}
    for k, v in stats.items():
        out[k] = v
        out[k.replace("bytes", "gb")] = v / 1e9
    return out


def clear_memory() -> None:
    """Return the caching allocator's free blocks to the card."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
