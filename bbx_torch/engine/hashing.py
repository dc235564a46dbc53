"""The counter-based hash of the port's random draws.

K7's regen draws (`engine/state.py`) and K9's action sampler
(`env/vector.py`) hash a per-step seed with a lane index (and an attempt)
through `mix32`; their CUDA kernels call its twin `bbx_mix32`
(`csrc/hash.cuh`), so a kernel and its plain version draw the same bits.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# Odd multipliers below 2**31: a 32-bit word times one stays below 2**63,
# so the int64 arithmetic never overflows.
_MIX1, _MIX2 = 0x2C1B3C6D, 0x297A2D39


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit xorshift-multiply mixing hash (a bijection) on int64
    tensors holding values in [0, 2**32) (torch has no ``>>`` for uint32
    on the CPU); `bbx_mix32` in `csrc/hash.cuh`, bit for bit."""
    x = x ^ (x >> 15)
    x = (x * _MIX1) & M32
    x = x ^ (x >> 12)
    x = (x * _MIX2) & M32
    return x ^ (x >> 15)


def lane_keys(seed: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """The 32-bit key of each lane under a per-step `seed` (an int64
    tensor): ``mix32(mix32(seed) ^ lane)``."""
    return mix32(mix32(seed.to(torch.int64) & M32) ^ lanes.to(torch.int64))
