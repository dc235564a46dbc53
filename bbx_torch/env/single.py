"""Single-environment, gym-style API (host-facing).

Counterpart of `bbx/env/single.py`: the batched engine (`bbx_torch.engine`)
with a batch of one lane on an explicit device, the CUDA card by default.
A step is the engine's `step` with ``auto_reset=False`` (K6, K7, K6 on the
card), so a terminal state persists and stepping it takes the
invalid-action path; a reset draws a fresh triple and runs `observe` (K1).

Everything a reset or a step returns -- the observation, the reward, the
counters and what `render` shows -- comes to the host in one copy
(`_to_host`), and the action mask, the valid actions and the random valid
action are read from that copy, so a step synchronises with the card once.
`sample_valid_action` draws on the host with `np.random.choice`, as bbx
does, so the same mask under the same `np.random.seed` picks the same
action in both packages.  The piece draws come from a `torch.Generator`
and are not bbx's.  Gymnasium is optional: the class registers as
``BlockBlastTorch-v0`` / ``BlockBlastTorch-Flat-v0`` when it is importable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..engine import kernel as K
from ..engine import pieces as P
from ..engine.state import make_generator, reset as engine_reset
from ..engine.step import RewardConfig, observe, step
from ..engine.tables import NUM_ACTIONS
from ..render import render_game_state

BOARD_SIZE = 8
NUM_PIECES_PER_TURN = 3
ACTION_SPACE_SIZE = NUM_ACTIONS
# An unseeded reset advances the episode seed by this much.
EPISODE_SEED_STRIDE = 1_000_003

try:  # inherit gymnasium.Env when available (required by gym.make)
    import gymnasium as _gym
    _EnvBase = _gym.Env
except ImportError:  # pragma: no cover - gymnasium is optional
    _EnvBase = object

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Lane 0 of each [1, ...] tensor as a numpy array, in one copy: the
    tensors' bytes are concatenated on their device (4-byte types first, so
    every array lies aligned) and fetched together."""
    items = sorted(tensors.items(), key=lambda kv: -kv[1].element_size())
    raw = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in items]).cpu().numpy()
    out, at = {}, 0
    for name, t in items:
        size = t.numel() * t.element_size()
        out[name] = raw[at:at + size].view(_NP_DTYPES[t.dtype]).reshape(t.shape[1:])
        at += size
    return out


class BlockBlastEnv(_EnvBase):
    """Gymnasium-compatible Block Blast environment (single instance).

    Observation: {'board' (8,8) f32, 'pieces' (3,8,8) f32,
                  'action_mask' (192,) int8}; action: Discrete(192),
    flat = piece*64 + row*8 + col.  `device`: where the game state lives
    and steps ("cuda" by default; a CUDA device without a card raises).
    """

    metadata = {"render_modes": ["human", "ansi"]}

    BOARD_SIZE = BOARD_SIZE
    NUM_PIECES_PER_TURN = NUM_PIECES_PER_TURN
    ACTION_SPACE_SIZE = ACTION_SPACE_SIZE

    def __init__(
        self,
        render_mode: Optional[str] = None,
        reward_config: Optional[Dict[str, float]] = None,
        seed: Optional[int] = None,
        device="cuda",
    ):
        self.render_mode = render_mode
        self.device = resolve_device(device)
        self.seed_value = seed if seed is not None else 0
        rc = RewardConfig()
        if reward_config:
            rc = dataclasses.replace(rc, **{k: v for k, v in reward_config.items()
                                            if hasattr(rc, k)})
        self.reward_config = rc
        self._episode_seed = self.seed_value
        self.state = None
        self._host: Dict[str, np.ndarray] = {}
        self._build_spaces()
        self.reset(seed=seed)

    def _build_spaces(self):
        try:
            from gymnasium import spaces
        except ImportError:  # structural-typing fallback
            self.observation_space = None
            self.action_space = None
            return
        self.observation_space = spaces.Dict({
            "board": spaces.Box(0.0, 1.0, (8, 8), np.float32),
            "pieces": spaces.Box(0.0, 1.0, (3, 8, 8), np.float32),
            "action_mask": spaces.Box(0, 1, (ACTION_SPACE_SIZE,), np.int8),
        })
        self.action_space = spaces.Discrete(ACTION_SPACE_SIZE)

    # -- helpers -----------------------------------------------------------
    def _action_to_move(self, action: int) -> Tuple[int, int, int]:
        piece = action // 64
        rem = action % 64
        return piece, rem // 8, rem % 8

    def _move_to_action(self, piece: int, row: int, col: int) -> int:
        return piece * 64 + row * 8 + col

    def _fetch(self, obs: dict, holes: torch.Tensor, out=None) -> None:
        """Bring the state, `obs` and (after a step) `out`'s reward and
        last-move counters to the host in one copy."""
        s = self.state
        fields = {
            "board": obs["board"], "pieces": obs["pieces"],
            "action_mask": obs["action_mask"], "piece_ids": s.piece_ids,
            "used": s.used, "score": s.score, "moves": s.moves,
            "lines_total": s.lines_total, "max_streak": s.max_streak,
            "blocks_total": s.blocks_total, "streak": s.streak, "done": s.done,
            "holes": holes,
        }
        if out is not None:
            info = out.info
            fields.update(
                reward=out.reward, terminated=out.done,
                invalid_action=info["invalid_action"],
                last_blocks_placed=info["last_blocks_placed"],
                last_lines_cleared=info["last_lines_cleared"],
                last_combo_multiplier=info["last_combo_multiplier"],
                last_score_gained=info["last_score_gained"])
        self._host = _to_host(fields)

    def _get_observation(self) -> Dict[str, np.ndarray]:
        h = self._host
        return {
            "board": h["board"].copy(),
            "pieces": h["pieces"].copy(),
            "action_mask": h["action_mask"].astype(np.int8),
        }

    def _get_info(self, last_move: bool = False) -> Dict[str, Any]:
        """bbx's info dict from the host copy; `last_move` adds the step's
        invalid flag and last-move details."""
        h = self._host
        info = {
            "score": int(h["score"]),
            "moves": int(h["moves"]),
            "lines_cleared": int(h["lines_total"]),
            "max_combo": int(h["max_streak"]),
            "blocks_placed": int(h["blocks_total"]),
            "board_fill": float(h["board"].sum() / 64.0),
            "holes": int(h["holes"]),
            "invalid_action": False,
        }
        if last_move:
            info["invalid_action"] = bool(h["invalid_action"])
            info["last_move"] = {
                "blocks_placed": int(h["last_blocks_placed"]),
                "lines_cleared": int(h["last_lines_cleared"]),
                "combo_multiplier": int(h["last_combo_multiplier"]),
                "score_gained": int(h["last_score_gained"]),
            }
        return info

    # -- gym API -----------------------------------------------------------
    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.seed_value = seed
            self._episode_seed = seed
        else:
            # A fresh piece stream per episode; an explicit seed replays one.
            self._episode_seed += EPISODE_SEED_STRIDE
        self.state = engine_reset(1, make_generator(self._episode_seed, self.device),
                                  self.device)
        self._fetch(observe(self.state), K.count_holes(self.state.board))
        return self._get_observation(), self._get_info()

    def step(self, action: int):
        actions = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        out = step(self.state, actions, self.reward_config, auto_reset=False)
        self.state = out.state
        # The step's holes are `count_holes` of the new board (K6 / the
        # plain move core), which bbx's single env recounts.
        self._fetch(out.obs, out.info["holes"], out)
        h = self._host
        obs, info = self._get_observation(), self._get_info(last_move=True)
        if self.render_mode == "human":
            self.render()
        return obs, float(h["reward"]), bool(h["terminated"]), False, info

    def render(self) -> Optional[str]:
        h = self._host
        text = render_game_state(
            h["board"],
            [int(i) for i in h["piece_ids"]],
            [bool(u) for u in h["used"]],
            score=int(h["score"]),
            moves=int(h["moves"]),
            combo=int(h["streak"]),
            game_over=bool(h["done"]),
        )
        if self.render_mode == "ansi":
            return text
        if self.render_mode == "human":
            print("\033[2J\033[H" + text)
        return None

    def close(self) -> None:
        self.state = None

    def get_action_mask(self) -> np.ndarray:
        return self._host["action_mask"].copy()

    def get_valid_actions(self):
        return np.where(self._host["action_mask"])[0].tolist()

    def sample_valid_action(self) -> int:
        valid = self.get_valid_actions()
        if not valid:
            return 0
        return int(np.random.choice(valid))


class BlockBlastEnvFlat(BlockBlastEnv):
    """Flat-observation variant: 64 board + 3*37 piece one-hots + 3 used
    flags = 178 values."""

    OBS_SIZE = 64 + 3 * P.NUM_PIECE_TYPES + 3  # 178

    def _build_spaces(self):
        try:
            from gymnasium import spaces
        except ImportError:
            self.observation_space = None
            self.action_space = None
            return
        self.observation_space = spaces.Dict({
            "obs": spaces.Box(0.0, 1.0, (self.OBS_SIZE,), np.float32),
            "action_mask": spaces.Box(0, 1, (ACTION_SPACE_SIZE,), np.int8),
        })
        self.action_space = spaces.Discrete(ACTION_SPACE_SIZE)

    def _get_observation(self):
        base = super()._get_observation()
        ids, used = self._host["piece_ids"], self._host["used"]
        onehots = np.zeros((3, P.NUM_PIECE_TYPES), np.float32)
        for i in range(3):
            if not used[i]:
                onehots[i, ids[i]] = 1.0
        obs = np.concatenate([
            base["board"].reshape(-1),
            onehots.reshape(-1),
            used.astype(np.float32),
        ])
        return {"obs": obs, "action_mask": base["action_mask"]}


class NormalizedRewardWrapper:
    """Return-based reward normalization for a single env: running
    discounted return, Welford moment merge, reward / sqrt(var)."""

    def __init__(self, env, gamma: float = 0.99, epsilon: float = 1e-8):
        from .vector import RunningMeanStd

        self.env = env
        self.gamma = gamma
        self.epsilon = epsilon
        self.return_rms = RunningMeanStd()
        self.ret = 0.0

    def reset(self, *args, **kwargs):
        self.ret = 0.0
        return self.env.reset(*args, **kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.ret = self.ret * self.gamma + float(reward)
        self.return_rms.update(np.asarray([self.ret]))
        norm = float(reward) / float(
            np.sqrt(self.return_rms.var + self.epsilon)
        )
        if terminated or truncated:
            self.ret = 0.0
        return obs, norm, terminated, truncated, info

    def __getattr__(self, item):
        return getattr(self.env, item)


class FrameStackWrapper:
    """Stack the last k board frames as `obs['board_stack']` (k, 8, 8).

    Reset seeds all k frames with the first observation; the raw `board`
    stays untouched, as in bbx."""

    def __init__(self, env, num_frames: int = 4):
        self.env = env
        self.num_frames = num_frames
        self.frames = np.zeros((num_frames, 8, 8), np.float32)

    def _obs(self, obs):
        obs = dict(obs)
        obs["board_stack"] = self.frames.copy()
        return obs

    def reset(self, *args, **kwargs):
        obs, info = self.env.reset(*args, **kwargs)
        self.frames[:] = obs["board"]
        return self._obs(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.frames = np.roll(self.frames, -1, axis=0)
        self.frames[-1] = obs["board"]
        return self._obs(obs), reward, terminated, truncated, info

    def __getattr__(self, item):
        return getattr(self.env, item)


def make_env(
    seed: Optional[int] = None,
    reward_config: Optional[Dict[str, float]] = None,
    normalize_reward: bool = False,
    frame_stack: int = 1,
    device="cuda",
):
    """Single-env factory with optional wrappers."""
    env = BlockBlastEnv(seed=seed, reward_config=reward_config, device=device)
    if frame_stack > 1:
        env = FrameStackWrapper(env, num_frames=frame_stack)
    if normalize_reward:
        env = NormalizedRewardWrapper(env)
    return env


def register_gym_envs():
    """Register ``BlockBlastTorch-v0`` / ``BlockBlastTorch-Flat-v0`` (ids
    of their own, so bbx's ``BlockBlast-v0`` in the same process keeps its
    entry point); ``gym.make(id, device="cpu")`` reaches the constructor.
    Returns False without gymnasium."""
    try:
        import gymnasium as gym
    except ImportError:
        return False
    for env_id, entry in (
        ("BlockBlastTorch-v0", "bbx_torch.env.single:BlockBlastEnv"),
        ("BlockBlastTorch-Flat-v0", "bbx_torch.env.single:BlockBlastEnvFlat"),
    ):
        if env_id not in gym.registry:
            gym.register(id=env_id, entry_point=entry, max_episode_steps=10000)
    return True
