"""The run's weights, drawn from its seed on the device in one call."""
from __future__ import annotations

import math

import torch

# Apart from the seeds the trainer and the eval derive from the same seed.
SALT = 7919
BIAS_SCALE = 0.1


def draw(network: torch.nn.Module, seed: int) -> dict:
    """Load weights drawn from `seed` into `network` and return a copy of
    them by parameter name: each weight uniform within the Kaiming bound
    of its fan-in, each bias uniform in +-0.1, each norm's scale 1 +- 0.1."""
    params = list(network.named_parameters())
    dev = params[0][1].device
    g = torch.Generator(device=dev).manual_seed(seed + SALT)
    u = torch.rand(sum(p.numel() for _, p in params), generator=g, device=dev) * 2 - 1
    out = {}
    with torch.no_grad():
        for (name, p), x in zip(params, u.split([p.numel() for _, p in params])):
            x = x.view(p.shape)
            if p.dim() > 1:
                x = x * math.sqrt(6.0 / p[0].numel())
            elif name.endswith("bias"):
                x = x * BIAS_SCALE
            else:
                x = 1.0 + x * BIAS_SCALE
            p.copy_(x)
            out[name] = x.clone()
    return out
