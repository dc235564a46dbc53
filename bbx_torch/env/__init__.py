"""Environment layer: the gym-style single env and the vectorised
on-device env, with their wrappers.

Counterpart of `bbx.env`.
"""
from .single import (
    BlockBlastEnv,
    BlockBlastEnvFlat,
    FrameStackWrapper,
    NormalizedRewardWrapper,
    make_env,
    register_gym_envs,
)
from .vector import (
    FrameStackVecEnv,
    NormalizedRewardVecEnv,
    RunningMeanStd,
    VectorEnv,
    make_vec_env,
    sample_valid_actions_device,
)

__all__ = [
    "BlockBlastEnv",
    "BlockBlastEnvFlat",
    "FrameStackWrapper",
    "NormalizedRewardWrapper",
    "make_env",
    "FrameStackVecEnv",
    "NormalizedRewardVecEnv",
    "RunningMeanStd",
    "VectorEnv",
    "make_vec_env",
    "register_gym_envs",
    "sample_valid_actions_device",
]
