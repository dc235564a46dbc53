"""PPO: rollout -> GAE -> epochs of shuffled-minibatch clipped updates.

Counterpart of the plain-PPO subset of `bbx/agent/ppo.py`.  `bbx` runs one
jitted XLA program per iteration; here the rollout and the update are
plain Python loops over eager PyTorch calls, and GAE is the CUDA kernel K5
(`csrc/gae.cu`) on the card.  Semantics kept from `bbx`:

  * a rollout of `rollout_steps` x `num_envs` transitions stored compactly
    (uint8 boards, int8 piece ids; the float observation planes are
    rebuilt per minibatch), then the bootstrap value of the last
    observation;
  * advantages normalised over the WHOLE buffer with the population std
    (``jnp.std``, ddof 0) before minibatching;
  * per-epoch reshuffled minibatches; clipped surrogate + value_coef * MSE
    - entropy_coef * masked entropy; a global-norm clip written as optax's
    `clip_by_global_norm` computes it; Adam(eps=1e-5);
  * optional linear lr / entropy schedules: the lr counts optimizer
    (minibatch) steps as `optax.linear_schedule` does, the entropy
    coefficient counts PPO iterations and reads the iteration index before
    its increment.

The search / behaviour-cloning knobs of `bbx`'s `PPOConfig` (lookahead
rollouts, distillation) and `adam_mu_dtype` are fields here so that every
config maps onto the class, but any non-default value raises
NotImplementedError: they are still to port (ROADMAP.md, Queue 1).
Random draws come from explicit `torch.Generator`s: one for the actions,
one for the minibatch shuffle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..engine.state import EnvState
from ..engine.step import RewardConfig, observe, step
from ..engine.tables import tables
from ..models import distributions as D
from ..ops import build

# Default values of the fields this port does not implement yet.
_NOT_PORTED = {
    "rollout_search_frac": 0.0,
    "final_rollout_search_frac": None,
    "bc_coef": 0.0,
    "final_bc_coef": None,
    "bc_filter": "all",
    "bc_target": "argmax",
    "bc_q_temp": 1.0,
    "search_topk": 0,
    "search_anneal_frac": 1.0,
    "adam_mu_dtype": None,
}
ADV_EPS = 1e-8        # ppo.py:399
ADAM_EPS = 1e-5       # ppo.py:150
KL_LOGRATIO_CLIP = 20.0  # metric-only clamp of approx_kl (ppo.py:480)


@dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters: every field of `bbx.agent.ppo.PPOConfig`."""

    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 10
    minibatch_size: int = 2048
    rollout_steps: int = 128
    num_envs: int = 64
    # The AfterstateNetwork has no BatchNorm or dropout, so the network is
    # the same function in train and eval mode and this flag changes
    # nothing here (bbx's flat CNN, which it matters for, is not ported).
    rollout_train_mode: bool = True
    rollout_search_frac: float = 0.0
    final_rollout_search_frac: Optional[float] = None
    bc_coef: float = 0.0
    final_bc_coef: Optional[float] = None
    bc_filter: str = "all"
    bc_target: str = "argmax"
    bc_q_temp: float = 1.0
    search_topk: int = 0
    search_anneal_frac: float = 1.0
    final_learning_rate: Optional[float] = None
    final_entropy_coef: Optional[float] = None
    schedule_updates: int = 0
    adam_mu_dtype: Optional[str] = None

    def __post_init__(self):
        bad = {k: getattr(self, k) for k, v in _NOT_PORTED.items()
               if getattr(self, k) != v}
        if bad:
            raise NotImplementedError(
                f"PPOConfig {bad}: lookahead/distillation rollouts, "
                "behaviour cloning and adam_mu_dtype are not ported yet "
                "(ROADMAP.md, Queue 1: lookahead and distillation)")

    @property
    def batch_size(self) -> int:
        return self.rollout_steps * self.num_envs

    @property
    def num_minibatches(self) -> int:
        return max(1, self.batch_size // self.minibatch_size)


# ---------------------------------------------------------------------------
# Optimizer and schedules.
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The network, its Adam optimizer, and the PPO iterations done
    (`update_step`, the entropy schedule's clock).  The lr schedule's clock
    is Adam's own step count (`optimizer_steps`, optax's ``count``)."""

    network: torch.nn.Module
    optimizer: torch.optim.Optimizer
    update_step: int = 0


def make_optimizer(config: PPOConfig, network: torch.nn.Module):
    """Adam(eps=1e-5) over the network's parameters; the global-norm clip
    and the lr schedule are applied by `update` around each step."""
    return torch.optim.Adam(network.parameters(), lr=config.learning_rate,
                            eps=ADAM_EPS)


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Optimizer steps taken: the ``step`` Adam keeps with each parameter's
    moments (all alike), 0 before the first step."""
    for state in optimizer.state.values():
        return int(state["step"])
    return 0


def learning_rate_at(config: PPOConfig, opt_step: int) -> float:
    """The lr of optimizer step `opt_step` (0 = the first step), as
    ``optax.linear_schedule(lr, final_lr, schedule_updates * num_epochs *
    num_minibatches)`` computes it in float32."""
    if config.final_learning_rate is None or config.schedule_updates <= 0:
        return config.learning_rate
    steps = config.schedule_updates * config.num_epochs * config.num_minibatches
    count = np.float32(min(max(opt_step, 0), steps))
    frac = np.float32(1.0) - count / np.float32(steps)
    return float(np.float32(config.learning_rate - config.final_learning_rate)
                 * frac + np.float32(config.final_learning_rate))


def _linear_at(c0: float, c1: Optional[float], horizon: int,
               update_step: int) -> float:
    """Linear schedule c0 -> c1 over `horizon` PPO iterations, in float32."""
    if c1 is None or horizon <= 0:
        return float(np.float32(c0))
    frac = np.clip(np.float32(update_step) / np.float32(horizon),
                   np.float32(0.0), np.float32(1.0))
    return float(np.float32(c0) + (np.float32(c1) - np.float32(c0)) * frac)


def entropy_coef_at(config: PPOConfig, update_step: int) -> float:
    """Entropy coefficient of PPO iteration `update_step`."""
    return _linear_at(config.entropy_coef, config.final_entropy_coef,
                      config.schedule_updates, update_step)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's `clip_by_global_norm`, in place and without a host sync:
    each g becomes ``(g / ||g||) * max_norm`` unless ``||g|| < max_norm``
    (the norm in float32, as the grads are)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


# ---------------------------------------------------------------------------
# Rollout.
# ---------------------------------------------------------------------------

# Compact per-transition buffer: name -> (trailing shape, dtype).
_TRAJ = {
    "board": ((8, 8), torch.uint8),
    "piece_ids": ((3,), torch.int8),
    "used": ((3,), torch.bool),
    "mask": ((192,), torch.bool),
    "action": ((), torch.int32),
    "logp": ((), torch.float32),
    "value": ((), torch.float32),
    "reward": ((), torch.float32),
    "done": ((), torch.bool),
}
# Episode-final statistics kept per step: info key -> dtype.
_FINAL = {
    "final_score": torch.int32,
    "final_length": torch.int32,
    "final_return": torch.float32,
    "final_lines": torch.int32,
    "final_max_combo": torch.int32,
    "invalid_action": torch.bool,
}


def rollout(network: torch.nn.Module, config: PPOConfig,
            reward_config: RewardConfig, env_state: EnvState,
            generator: torch.Generator):
    """Collect `rollout_steps` transitions for every env (auto-reset on).

    Returns (env_state, traj, last_value, ep_stats): `traj` is a dict of
    [T, N, ...] tensors (the compact buffer of `bbx/agent/ppo.py:297-307`),
    `last_value` [N] the bootstrap value of the final observation, and
    `ep_stats` 0-dim tensors over the episodes that ended in the rollout.
    Nothing here synchronises with the host except the regen inside
    `step`.
    """
    t_len, n, dev = config.rollout_steps, env_state.num_envs, env_state.device
    traj = {k: torch.empty((t_len, n, *shape), dtype=dt, device=dev)
            for k, (shape, dt) in _TRAJ.items()}
    final = {k: torch.empty((t_len, n), dtype=dt, device=dev)
             for k, dt in _FINAL.items()}
    obs = observe(env_state)
    with torch.no_grad():
        for t in range(t_len):
            logits, value = network(obs["board"], obs["pieces"],
                                    obs["action_mask"])
            action = D.sample(generator, logits)
            out = step(env_state, action, reward_config, auto_reset=True)
            traj["board"][t] = env_state.board
            traj["piece_ids"][t] = env_state.piece_ids
            traj["used"][t] = env_state.used
            traj["mask"][t] = obs["action_mask"]
            traj["action"][t] = action
            traj["logp"][t] = D.log_prob(logits, action)
            traj["value"][t] = value
            traj["reward"][t] = out.reward
            traj["done"][t] = out.done
            for k in final:
                final[k][t] = out.info[k]
            env_state, obs = out.state, out.obs
        _, last_value = network(obs["board"], obs["pieces"],
                                obs["action_mask"])

    done = traj["done"]
    dones_f = done.to(torch.float32)
    episodes = dones_f.sum()
    n_done = torch.clamp(episodes, min=1.0)

    def mean_final(k):
        return (final[k] * dones_f).sum() / n_done

    ep_stats = {
        "episodes": episodes,
        "mean_score": mean_final("final_score"),
        "max_score": torch.where(done, final["final_score"], 0).max()
        .to(torch.float32),
        "mean_length": mean_final("final_length"),
        "mean_return": mean_final("final_return"),
        "mean_lines": mean_final("final_lines"),
        "mean_max_combo": mean_final("final_max_combo"),
        "invalid_frac": final["invalid_action"].to(torch.float32).mean(),
    }
    return env_state, traj, last_value, ep_stats


# ---------------------------------------------------------------------------
# K5: GAE.
# ---------------------------------------------------------------------------

def compute_gae_plain(config: PPOConfig, rewards, dones, values, last_value):
    """Plain version of `compute_gae`, in `bbx`'s operation order."""
    gamma, lam = config.gamma, config.gae_lambda
    adv = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in reversed(range(rewards.shape[0])):
        nonterm = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        adv[t] = adv_next
        v_next = values[t]
    return adv, adv + values


def compute_gae(config: PPOConfig, rewards: torch.Tensor, dones: torch.Tensor,
                values: torch.Tensor, last_value: torch.Tensor):
    """Reverse-scan GAE (`bbx/agent/ppo.py:354`).

    Args:
      rewards: [T, N] float32.  dones: [T, N] bool.  values: [T, N]
        float32.  last_value: [N] float32, the bootstrap value.
    Returns:
      (advantages, returns), each [T, N] float32.
    """
    if not rewards.is_cuda:
        return compute_gae_plain(config, rewards, dones, values, last_value)
    return _compute_gae_cuda(config, rewards, dones, values, last_value)


def _compute_gae_cuda(config, rewards, dones, values, last_value):
    t_len, n = rewards.shape
    build.require("compute_gae: rewards", rewards, torch.float32, (t_len, n))
    build.require("compute_gae: dones", dones, torch.bool, (t_len, n))
    build.require("compute_gae: values", values, torch.float32, (t_len, n))
    build.require("compute_gae: last_value", last_value, torch.float32, (n,))
    adv = torch.empty_like(values)
    ret = torch.empty_like(values)
    err = build.function("gae")(
        rewards.data_ptr(), dones.data_ptr(), values.data_ptr(),
        last_value.data_ptr(), adv.data_ptr(), ret.data_ptr(), config.gamma,
        config.gamma * config.gae_lambda, t_len, n, build.stream_of(rewards))
    build.check("gae", err)
    compute_gae.launches += 1
    return adv, ret


compute_gae.launches = 0


# ---------------------------------------------------------------------------
# Update.
# ---------------------------------------------------------------------------

def _minibatch_obs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Rebuild the float32 observation planes from the compact buffer."""
    pieces = tables(batch["board"].device).PIECE_MASKS[batch["piece_ids"].long()]
    pieces = pieces * (~batch["used"][:, :, None, None]).to(torch.float32)
    return {
        "board": batch["board"].to(torch.float32),
        "pieces": pieces,
        "action_mask": batch["mask"],
    }


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """Whole-buffer normalisation with the population std, as ``jnp.std``
    (`torch.std` would default to the unbiased one)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + ADV_EPS)


def ppo_loss(config: PPOConfig, logits, value, batch, ent_coef: float):
    """The clipped-surrogate loss and its metrics (0-dim tensors)."""
    new_logp = D.log_prob(logits, batch["action"])
    entropy = D.masked_entropy(logits, batch["mask"])
    logratio = new_logp - batch["logp"]
    ratio = torch.exp(logratio)
    adv = batch["adv"]
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - config.clip_epsilon,
                        1 + config.clip_epsilon) * adv
    policy_loss = -torch.mean(torch.minimum(surr1, surr2))
    value_loss = torch.mean((value - batch["ret"]) ** 2)
    entropy_mean = torch.mean(entropy)
    loss = (policy_loss + config.value_coef * value_loss
            - ent_coef * entropy_mean)
    with torch.no_grad():
        kl_lr = torch.clamp(logratio, -KL_LOGRATIO_CLIP, KL_LOGRATIO_CLIP)
        approx_kl = torch.mean(torch.exp(kl_lr) - 1.0 - kl_lr)
        clip_frac = torch.mean(
            ((ratio - 1.0).abs() > config.clip_epsilon).to(torch.float32))
    return loss, {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy_mean,
        "total_loss": loss,
        "approx_kl": approx_kl,
        "clip_fraction": clip_frac,
        # bbx reports its behaviour-cloning loss, 0 without search.
        "bc_loss": torch.zeros((), device=value.device),
    }


_BATCH_KEYS = ("board", "piece_ids", "used", "mask", "action", "logp")


def update(config: PPOConfig, ts: TrainState, traj, advantages, returns,
           generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """`num_epochs` of shuffled minibatch PPO updates (`bbx/agent/ppo.py:387`).

    Trains `ts.network` in place through `ts.optimizer` (one Adam step per
    minibatch) and advances `ts.update_step` once.  Returns the
    metrics averaged over every minibatch step, as 0-dim tensors.
    """
    total, mb = config.batch_size, config.minibatch_size
    if total % mb:
        raise ValueError(f"rollout batch {total} not divisible by minibatch {mb}")
    num_mb = total // mb
    flat = {k: traj[k].reshape(total, *traj[k].shape[2:]) for k in _BATCH_KEYS}
    adv = normalize_advantages(advantages.reshape(total))
    ret = returns.reshape(total)
    ent_coef = entropy_coef_at(config, ts.update_step)
    params = [p for p in ts.network.parameters()]
    sums: Dict[str, torch.Tensor] = {}
    for _ in range(config.num_epochs):
        perm = torch.randperm(total, generator=generator, device=adv.device)
        for i in range(num_mb):
            idx = perm[i * mb:(i + 1) * mb]
            batch = {k: v[idx] for k, v in flat.items()}
            batch["adv"], batch["ret"] = adv[idx], ret[idx]
            obs = _minibatch_obs(batch)
            logits, value = ts.network(obs["board"], obs["pieces"],
                                       obs["action_mask"])
            loss, aux = ppo_loss(config, logits, value, batch, ent_coef)
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm_([p.grad for p in params], config.max_grad_norm)
            lr = learning_rate_at(config, optimizer_steps(ts.optimizer))
            for group in ts.optimizer.param_groups:
                group["lr"] = lr
            ts.optimizer.step()
            for k, v in aux.items():
                v = v.detach()
                sums[k] = sums[k] + v if k in sums else v
    ts.update_step += 1
    steps = config.num_epochs * num_mb
    return {k: v / steps for k, v in sums.items()}


def train_iteration(config: PPOConfig, reward_config: RewardConfig,
                    ts: TrainState, env_state: EnvState,
                    action_rng: torch.Generator, shuffle_rng: torch.Generator):
    """One PPO iteration: rollout + GAE + update (`bbx/agent/ppo.py:533`).

    `ts` is trained in place and returned.  Returns (ts, env_state,
    metrics), the metrics as 0-dim tensors on the device.
    """
    env_state, traj, last_value, ep_stats = rollout(
        ts.network, config, reward_config, env_state, action_rng)
    advantages, returns = compute_gae(config, traj["reward"], traj["done"],
                                      traj["value"], last_value)
    metrics = update(config, ts, traj, advantages, returns, shuffle_rng)
    metrics.update(ep_stats)
    return ts, env_state, metrics
