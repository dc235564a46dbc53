"""Agent layer: PPO with GAE, the one-ply lookahead and search
distillation, and the single-device trainer.

Counterpart of `bbx.agent` (the policy agents are still to port).
"""
from .lookahead import lookahead_actions
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
    "PPOConfig",
    "PPOTrainer",
    "TrainState",
    "compute_gae",
    "lookahead_actions",
    "make_optimizer",
    "rollout",
    "train",
    "train_iteration",
    "update",
]
