"""Agent layer: PPO with GAE, the one-ply lookahead and search
distillation, the single-device trainer, and the object-style agents.

Counterpart of `bbx.agent`.
"""
from .base import BaseAgent
from .lookahead import lookahead_actions
from .policy_agent import PolicyAgent
from .ppo import (
    PPOConfig,
    TrainState,
    compute_gae,
    make_optimizer,
    rollout,
    train_iteration,
    update,
)
from .trainer import PPOTrainer, train

__all__ = [
    "BaseAgent",
    "PPOConfig",
    "PPOTrainer",
    "PolicyAgent",
    "TrainState",
    "compute_gae",
    "lookahead_actions",
    "make_optimizer",
    "rollout",
    "train",
    "train_iteration",
    "update",
]
