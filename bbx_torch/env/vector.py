"""On-device vectorised environment.

Counterpart of `bbx/env/vector.py`: a fleet of N games stepped in lockstep
on one device by `bbx_torch.engine.step`.  The stateful class is a thin
shell for benchmarks and scripts; training calls the engine functions
directly.  Runs on the CUDA card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..engine.state import EnvState, make_generator, reset
from ..engine.step import RewardConfig, StepOutput, observe, step
from ..models import distributions as D


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


class VectorEnv:
    """Batched Block Blast with auto-reset (`bbx/env/vector.py:VectorEnv`).

    Piece draws come from the fleet's generator, seeded with `seed` at
    every `reset`.
    """

    def __init__(self, num_envs: int = 64, seed: int = 42,
                 reward_config: Optional[RewardConfig] = None,
                 auto_reset: bool = True, device="cuda"):
        self.num_envs = num_envs
        self.seed = seed
        self.reward_config = reward_config or RewardConfig()
        self.auto_reset = auto_reset
        self.device = resolve_device(device)
        self.state: Optional[EnvState] = None

    def reset(self, seed: Optional[int] = None):
        """Reset all environments; returns the batched observation as NumPy."""
        if seed is not None:
            self.seed = seed
        self.state = reset(self.num_envs, make_generator(self.seed, self.device),
                           self.device)
        return _numpy(observe(self.state))

    def step(self, actions):
        """Step every env; returns (obs, rewards, dones, infos) as NumPy."""
        out = self.step_device(torch.as_tensor(np.asarray(actions), device=self.device))
        return _numpy(out.obs), _numpy(out.reward), _numpy(out.done), _numpy(out.info)

    def step_device(self, actions: torch.Tensor) -> StepOutput:
        """Device-native step (no host transfer), for benchmarks."""
        out = step(self.state, actions, self.reward_config, auto_reset=self.auto_reset)
        self.state = out.state
        return out

    def get_action_masks(self) -> np.ndarray:
        """[N, 192] bool."""
        return _numpy(observe(self.state)["action_mask"])

    def sample_valid_actions(self, rng: Optional[np.random.Generator] = None):
        """A uniformly random valid action per env (0 where none is valid)."""
        rng = rng or np.random.default_rng()
        masks = self.get_action_masks()
        out = np.zeros(self.num_envs, dtype=np.int64)
        for i in range(self.num_envs):
            valid = np.nonzero(masks[i])[0]
            out[i] = rng.choice(valid) if len(valid) else 0
        return out

    def close(self):
        self.state = None


def sample_valid_actions_device(generator: torch.Generator,
                                mask: torch.Tensor) -> torch.Tensor:
    """Uniform-over-valid action sampling on the device ([N, 192] -> [N]
    int32): Gumbel-max over ``where(mask, 0, -1e9)``, as bbx samples its
    categorical.  On a row with no valid action every logit is -1e9, which
    float32 noise cannot move (its spacing there is 64), so the row takes
    action 0, as bbx's does."""
    logits = torch.where(mask > 0, 0.0, D.MASKED_LOGIT)
    return D.sample(generator, logits)


class RunningMeanStd:
    """Welford-merge running moments."""

    def __init__(self, epsilon: float = 1e-4, shape=()):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = epsilon

    def update(self, x: np.ndarray) -> None:
        bm, bv, bc = np.mean(x, axis=0), np.var(x, axis=0), x.shape[0]
        delta = bm - self.mean
        tot = self.count + bc
        self.mean = self.mean + delta * bc / tot
        m_a = self.var * self.count
        m_b = bv * bc
        m2 = m_a + m_b + delta**2 * self.count * bc / tot
        self.var = m2 / tot
        self.count = tot


class NormalizedRewardVecEnv:
    """Return-based reward normalisation over a VectorEnv (per-env
    discounted return / its running std)."""

    def __init__(self, env: VectorEnv, gamma: float = 0.99, epsilon: float = 1e-8):
        self.env = env
        self.gamma = gamma
        self.epsilon = epsilon
        self.return_rms = RunningMeanStd()
        self.returns = np.zeros(env.num_envs, np.float64)

    def reset(self, seed=None):
        self.returns[:] = 0.0
        return self.env.reset(seed)

    def step(self, actions):
        obs, rewards, dones, infos = self.env.step(actions)
        self.returns = self.returns * self.gamma + rewards
        self.return_rms.update(self.returns)
        norm = rewards / np.sqrt(self.return_rms.var + self.epsilon)
        self.returns[dones] = 0.0
        return obs, norm.astype(np.float32), dones, infos

    def __getattr__(self, item):
        return getattr(self.env, item)


class FrameStackVecEnv:
    """Stack the last k board frames under ``board_stack``; reset (and the
    auto-reset of a finished lane) fills all k frames with the first
    observation."""

    def __init__(self, env: VectorEnv, num_frames: int = 4):
        self.env = env
        self.num_frames = num_frames
        self.frames = np.zeros((env.num_envs, num_frames, 8, 8), np.float32)

    def _obs(self, obs):
        obs = dict(obs)
        obs["board_stack"] = self.frames.copy()
        return obs

    def reset(self, seed=None):
        obs = self.env.reset(seed)
        self.frames[:] = obs["board"][:, None]
        return self._obs(obs)

    def step(self, actions):
        obs, rewards, dones, infos = self.env.step(actions)
        self.frames = np.roll(self.frames, -1, axis=1)
        self.frames[:, -1] = obs["board"]
        self.frames[dones] = obs["board"][dones, None]
        return self._obs(obs), rewards, dones, infos

    def __getattr__(self, item):
        return getattr(self.env, item)


def make_vec_env(num_envs: int = 64, seed: int = 42, normalize_rewards=False,
                 frame_stack: int = 0, **kwargs):
    """A VectorEnv, optionally wrapped (`bbx/env/vector.py:make_vec_env`)."""
    env = VectorEnv(num_envs=num_envs, seed=seed, **kwargs)
    if normalize_rewards:
        env = NormalizedRewardVecEnv(env)
    if frame_stack:
        env = FrameStackVecEnv(env, frame_stack)
    return env
