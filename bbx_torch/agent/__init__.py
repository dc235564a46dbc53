"""Agent layer: plain PPO with GAE and the single-device trainer.

Counterpart of `bbx.agent` (the plain-PPO subset; lookahead, distillation
and the policy agents are still to port).
"""
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
    "make_optimizer",
    "rollout",
    "train",
    "train_iteration",
    "update",
]
