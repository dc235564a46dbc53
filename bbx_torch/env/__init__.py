"""Environment layer: the vectorised on-device env and its wrappers.

Counterpart of `bbx.env` (the vectorised part; the gym single env waits,
ROADMAP.md Queue 1).
"""
from .vector import (
    FrameStackVecEnv,
    NormalizedRewardVecEnv,
    RunningMeanStd,
    VectorEnv,
    make_vec_env,
    sample_valid_actions_device,
)

__all__ = [
    "FrameStackVecEnv",
    "NormalizedRewardVecEnv",
    "RunningMeanStd",
    "VectorEnv",
    "make_vec_env",
    "sample_valid_actions_device",
]
