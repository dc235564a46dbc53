"""Device resolution for the port's entry points.

The port runs on the CUDA card by default.  A caller that wants the CPU
says so (``device="cpu"``); a missing card is an error, never a silent
fallback to the CPU.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a `torch.device`, raising if it is a CUDA device
    and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def float32_exact():
    """Run the block with float32 convolutions and matmuls in full float32
    on the card, and put the backend flags back as they were after it.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); comparisons against a float32 reference switch that off.
    """
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
