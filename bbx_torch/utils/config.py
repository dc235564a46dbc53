"""Configuration: the same schema and defaults as `bbx/utils/config.py`.

YAML is read and written only for a ``.yaml`` path, with `yaml` imported
inside `load_config` and `save_config`: the port does not need PyYAML
otherwise.  A ``.json`` config is read and written with `json`; JSON is
YAML, so the same file means the same thing to `bbx`.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional

DEFAULT_CONFIG: Dict[str, Any] = {
    "environment": {
        "board_size": 8,
        "num_pieces_per_turn": 3,
        "total_piece_types": 37,
    },
    "ppo": {
        "learning_rate": 3.0e-4,
        "gamma": 0.99,
        "gae_lambda": 0.95,
        "clip_epsilon": 0.2,
        "entropy_coef": 0.01,
        "value_coef": 0.5,
        "max_grad_norm": 0.5,
        "num_epochs": 10,
    },
    "training": {
        "num_envs": 64,
        "batch_size": 2048,          # minibatch size for updates
        "total_timesteps": 10_000_000,
        "rollout_steps": 128,
        "seed": 42,
    },
    "network": {
        "conv_channels": [64, 128, 128],
        "fc_hidden": [512, 256],
        "use_batch_norm": True,
        "use_residual": True,
        "compute_dtype": "bfloat16",
    },
    "rewards": {
        "line_clear_base": 1.0,
        "block_placed": 0.01,
        "game_over_penalty": -1.0,
        "hole_penalty": -0.05,
        "center_bonus": 0.02,
        "combo_multiplier_bonus": 0.5,
        "survival_bonus": 0.001,
    },
    "logging": {
        "log_interval": 10,
        "save_interval": 100,
        "eval_interval": 50,
        "eval_episodes": 10,
    },
    "paths": {
        "checkpoint_dir": "checkpoints",
        "log_dir": "logs",
        "results_dir": "results",
    },
    "mesh": {
        "num_data": None,   # default: all local devices
        "num_model": 1,
    },
}


def _deep_update(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    """A YAML or JSON (by the ``.json`` suffix) config merged over the
    defaults; the defaults alone if `path` is None or missing."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path and os.path.exists(path):
        with open(path) as f:
            if path.endswith(".json"):
                user = json.load(f)
            else:
                import yaml

                user = yaml.safe_load(f)
        cfg = _deep_update(cfg, user or {})
    return cfg


def merge_config(cfg: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """`override` merged over `cfg`, section by section."""
    return _deep_update(cfg, override)


def save_config(cfg: Dict[str, Any], path: str) -> None:
    """Write `cfg` to `path`: JSON for a ``.json`` path, else YAML (PyYAML
    imported here, as `load_config` reads it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if path.endswith(".json"):
            json.dump(cfg, f, indent=2)
        else:
            import yaml

            yaml.safe_dump(cfg, f, sort_keys=False)
