"""PPO: rollout -> GAE -> epochs of shuffled-minibatch clipped updates.

Counterpart of `bbx/agent/ppo.py`.  `bbx` runs one
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

Search distillation, as `bbx`: with `uses_search` the rollout runs the
one-ply lookahead (`agent/lookahead.py`) on every step while the annealed
search fraction or BC coefficient is above 0 (a Python branch where bbx
has `lax.cond`), takes the search's action on a `search_frac` share of the
lanes (its network in eval mode; the rollout's logits pick the top-k),
floors the stored logp at -15 and
records the search's action (and, for ``bc_target: q_soft``, its
candidates and their Q in bf16); the update adds the dual clip at 3 x adv
for negative advantages and the behaviour-cloning term.  ``adam_mu_dtype:
bfloat16`` keeps Adam's first moment in bf16 (`AdamBF16Mu`), as optax's
``mu_dtype``.
Random draws come from explicit `torch.Generator`s: one for the actions,
one for the minibatch shuffle, one for the dropout masks and one for the
search (its simulated regen draws and the search/policy mix).

Data parallelism (`bbx_torch.parallel`), as bbx's GSPMD program computes
it: with a distributed `Mesh` each rank holds a contiguous shard of the
fleet's lanes (`EnvState.lane_base`), every rank draws the actions, the
minibatch permutation and the dropout masks at the global batch's shape
from generators in lockstep and keeps its rows, and the update runs over
the global minibatches: rank r takes the entries of each that fall in its
env columns (the buffer is flattened t * N_global + n), each loss term is
its sum over those rows divided by the global minibatch size, and the
gradients are summed over ranks before the global-norm clip.  Advantage
normalisation, the loss metrics and the episode statistics are reduced
across ranks as sums, counts and maxima, and the flat CNN's BatchNorm
takes global batch statistics.  In one process none of this runs.

The flat CNN (`BlockBlastNetwork`) has BatchNorm and dropout, so the mode
matters, as in `bbx`: with ``rollout_train_mode`` the rollout runs it in
train mode (batch statistics, its running statistics moving step to step,
live dropout), the bootstrap value of the last observation in eval mode
(running statistics), and the update in train mode with the running
statistics carried from minibatch to minibatch.  The AfterstateNetwork has
neither, so the mode changes nothing for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..device import deterministic_cudnn
from ..engine.state import EnvState
from ..engine.step import RewardConfig, observe, step
from ..engine.tables import tables
from ..models import distributions as D
from ..models.utils import clip_by_global_norm_
from ..ops import build
from ..parallel.collectives import all_reduce_max, all_reduce_sum, reduce_gradients
from ..parallel.mesh import BatchShard, Mesh
from ..utils.profiling import span
from .lookahead import lookahead_actions, search_width

ADV_EPS = 1e-8        # ppo.py:399
ADAM_EPS = 1e-5       # ppo.py:150
KL_LOGRATIO_CLIP = 20.0  # metric-only clamp of approx_kl (ppo.py:480)
SEARCH_LOGP_FLOOR = -15.0  # the stored logp's floor with search (ppo.py:289)
DUAL_CLIP = 3.0       # the negative-advantage bound with search (ppo.py:434)


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
    # Run the policy in train mode in the rollout (BatchNorm batch
    # statistics and live dropout, as torch's default mode does in the
    # reference); changes nothing for the AfterstateNetwork.
    rollout_train_mode: bool = True
    # Search distillation (bbx/agent/ppo.py:60-111): the share of rollout
    # actions the one-ply search takes and the behaviour-cloning
    # coefficient, each annealable to a final value over
    # search_anneal_frac x schedule_updates iterations; the BC filter
    # ("all" | "adv_pos": executed search actions with positive advantage)
    # and target ("argmax" | "q_soft": CE against softmax(q / bc_q_temp)
    # over the candidates); the search's top-k (0 = all 192 actions).
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
    # Adam's first moment in bf16 (`AdamBF16Mu`) or, with None, float32.
    # bbx reads any other value as None; the port refuses it.
    adam_mu_dtype: Optional[str] = None

    def __post_init__(self):
        for name, allowed in (("bc_filter", ("all", "adv_pos")),
                              ("bc_target", ("argmax", "q_soft")),
                              ("adam_mu_dtype", (None, "bfloat16"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"PPOConfig.{name} = {getattr(self, name)!r}; "
                                 f"one of {allowed}")

    @property
    def batch_size(self) -> int:
        return self.rollout_steps * self.num_envs

    @property
    def uses_search(self) -> bool:
        """Does any iteration of this run search in its rollouts (the
        stored-logp floor, the dual clip and the search fields follow)?"""
        return (self.rollout_search_frac > 0.0
                or (self.final_rollout_search_frac or 0.0) > 0.0
                or self.bc_coef > 0.0
                or (self.final_bc_coef or 0.0) > 0.0)

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


class AdamBF16Mu(torch.optim.Optimizer):
    """Adam with its first moment stored in bf16 and its second in float32:
    ``optax.adam(lr, eps=eps, mu_dtype=jnp.bfloat16)`` (`bbx/agent/ppo.py:147`)
    as bbx's jitted update computes it with optax 0.2.6.

    Each step, for gradient g: mu = (1 - b1) g + b1' mu_stored in float32,
    where b1' is b1 rounded to bf16 (0.9 -> 0.8984375: optax multiplies
    the bf16 moment by b1 as a weak-typed constant, which takes the
    moment's dtype) and the product is kept in float32 (jitted, XLA keeps
    the excess precision; optax run eagerly would round it to bf16);
    nu = (1 - b2) g^2 + b2 nu; the step is -lr (mu / (1 - b1^t)) /
    (sqrt(nu / (1 - b2^t)) + eps), the bias corrections in float32, from
    the unrounded mu; then mu is stored rounded to bf16.  The state's
    names are `torch.optim.Adam`'s (``step``, ``exp_avg``,
    ``exp_avg_sq``), so `optimizer_steps` and the checkpoints read it
    alike.
    """

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = ADAM_EPS):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    def load_state_dict(self, state_dict) -> None:
        # The base class casts every floating state tensor to its
        # parameter's dtype; the stored moment is bf16 (an exact round trip).
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamBF16Mu takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
                t = np.float32(state["step"].item())
                bc1 = np.float32(1.0) - np.float32(b1) ** t
                bc2 = np.float32(1.0) - np.float32(b2) ** t
                g = p.grad.to(torch.float32)
                mu = g * (1.0 - b1) + state["exp_avg"].to(torch.float32) * b1_bf16
                nu = state["exp_avg_sq"]
                nu.copy_(g * g * (1.0 - b2) + nu * b2)
                step = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + eps)
                p.add_((step * -lr).to(p.dtype))
                state["exp_avg"].copy_(mu)
        return None


def make_optimizer(config: PPOConfig, network: torch.nn.Module):
    """Adam(eps=1e-5) over the network's parameters (`AdamBF16Mu` where
    ``adam_mu_dtype`` is ``"bfloat16"``); the global-norm clip and the lr
    schedule are applied by `update` around each step."""
    if config.adam_mu_dtype == "bfloat16":
        return AdamBF16Mu(network.parameters(), lr=config.learning_rate)
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


def search_frac_at(config: PPOConfig, update_step: int) -> float:
    """The search's share of rollout actions in PPO iteration `update_step`."""
    return _linear_at(config.rollout_search_frac, config.final_rollout_search_frac,
                      int(config.schedule_updates * config.search_anneal_frac),
                      update_step)


def bc_coef_at(config: PPOConfig, update_step: int) -> float:
    """The behaviour-cloning coefficient of PPO iteration `update_step`."""
    return _linear_at(config.bc_coef, config.final_bc_coef,
                      int(config.schedule_updates * config.search_anneal_frac),
                      update_step)


def searches_at(config: PPOConfig, update_step: int) -> bool:
    """Does the rollout of PPO iteration `update_step` run the search (on
    every step: its share of actions or its BC coefficient is above 0)?"""
    return config.uses_search and (search_frac_at(config, update_step) > 0.0
                                   or bc_coef_at(config, update_step) > 0.0)


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


def _search_fields(config: PPOConfig) -> Dict[str, tuple]:
    """The search's per-transition fields of the buffer: name -> (trailing
    shape, dtype); the candidates and their Q only for ``q_soft``, Q in
    bf16 as bbx stores it."""
    if not config.uses_search:
        return {}
    fields = {"search_a": ((), torch.uint8), "search_used": ((), torch.bool)}
    if config.bc_target == "q_soft":
        w = search_width(config.search_topk)
        fields.update(search_cand=((w,), torch.uint8), search_q=((w,), torch.bfloat16))
    return fields


def rollout(network: torch.nn.Module, config: PPOConfig,
            reward_config: RewardConfig, env_state: EnvState,
            generator: torch.Generator,
            dropout_rng: Optional[torch.Generator] = None,
            update_step: int = 0,
            search_rng: Optional[torch.Generator] = None,
            mesh: Optional[Mesh] = None):
    """Collect `rollout_steps` transitions for every env (auto-reset on).

    `generator` samples the actions and `dropout_rng` draws the dropout
    masks of a train-mode rollout (needed when the network has dropout).
    With `config.uses_search`, `search_rng` (on the fleet's device) draws
    the search's simulated regen and the search/policy mix, and
    `update_step` sets the annealed search fraction and BC coefficient:
    while either is above 0 the one-ply search runs on every step (else
    the search fields hold bbx's dummies: action 0, Q 0).
    Returns (env_state, traj, last_value, ep_stats): `traj` is a dict of
    [T, N, ...] tensors (the compact buffer of `bbx/agent/ppo.py:297-314`),
    `last_value` [N] the bootstrap value of the final observation (eval
    mode), and `ep_stats` 0-dim tensors over the episodes that ended in the
    rollout.  Nothing here synchronises with the host.  With a distributed
    `mesh`, `env_state` is this rank's shard of the fleet: the action noise
    and dropout masks are drawn for the whole fleet, BatchNorm reduces over
    it, and `ep_stats` cover every rank's episodes.
    """
    with span("ppo.rollout", device=True):
        return _rollout(network, config, reward_config, env_state, generator, dropout_rng,
                        update_step, search_rng, mesh)


def _rollout(network, config, reward_config, env_state, generator, dropout_rng,
             update_step, search_rng, mesh):
    """`rollout`'s body, in its span."""
    shard = lane_shard(env_state) if mesh is not None and mesh.distributed else None
    kw = {} if shard is None else {"shard": shard}
    t_len, n, dev = config.rollout_steps, env_state.num_envs, env_state.device
    fields = {**_TRAJ, **_search_fields(config)}
    traj = {k: torch.empty((t_len, n, *shape), dtype=dt, device=dev)
            for k, (shape, dt) in fields.items()}
    final = {k: torch.empty((t_len, n), dtype=dt, device=dev)
             for k, dt in _FINAL.items()}
    frac = search_frac_at(config, update_step)
    searching = searches_at(config, update_step)
    if searching and search_rng is None:
        raise ValueError("a search rollout needs search_rng")
    if not searching:
        for k in _search_fields(config):
            traj[k].zero_()
    obs = observe(env_state)
    network.train(config.rollout_train_mode)
    with torch.no_grad():
        for t in range(t_len):
            with span("ppo.rollout.step"):
                with span("ppo.rollout.policy"):
                    logits, value = network(obs["board"], obs["pieces"],
                                            obs["action_mask"], generator=dropout_rng, **kw)
                    action = D.sample(generator, logits, shard)
                    if not searching:
                        logp = _stored_logp(config, logits, action)
                if searching:
                    with span("ppo.rollout.search"):
                        search_a, cand, q = lookahead_actions(
                            network, env_state, search_rng, reward_config,
                            gamma=config.gamma, topk=config.search_topk,
                            policy_logits=logits, return_q=True, obs=obs)
                        use = torch.rand(n if shard is None else shard.total,
                                         generator=search_rng, device=dev)
                        use = (use if shard is None else shard.take(use)) < frac
                        action = torch.where(use, search_a, action)
                        logp = _stored_logp(config, logits, action)
                        traj["search_a"][t] = search_a
                        traj["search_used"][t] = use
                        if "search_q" in traj:
                            traj["search_cand"][t] = cand
                            traj["search_q"][t] = q
                with span("ppo.rollout.env"):
                    out = step(env_state, action, reward_config, auto_reset=True)
                with span("ppo.rollout.record"):
                    traj["board"][t] = env_state.board
                    traj["piece_ids"][t] = env_state.piece_ids
                    traj["used"][t] = env_state.used
                    traj["mask"][t] = obs["action_mask"]
                    traj["action"][t] = action
                    traj["logp"][t] = logp
                    traj["value"][t] = value
                    traj["reward"][t] = out.reward
                    traj["done"][t] = out.done
                    for k in final:
                        final[k][t] = out.info[k]
                env_state, obs = out.state, out.obs
        with span("ppo.rollout.last_value"):
            network.eval()
            _, last_value = network(obs["board"], obs["pieces"],
                                    obs["action_mask"])

    return env_state, traj, last_value, _episode_stats(traj["done"], final,
                                                        shard is not None)


def _stored_logp(config: PPOConfig, logits, action) -> torch.Tensor:
    """The rollout's stored log-probability of `action`."""
    logp = D.log_prob(logits, action)
    if config.uses_search:
        # A search action the policy gives ~zero mass would store a logp
        # near -1e9 and overflow the update's ratio.
        logp = torch.clamp(logp, min=SEARCH_LOGP_FLOOR)
    return logp


def lane_shard(env_state: EnvState) -> BatchShard:
    """The fleet's lanes as rows of the global fleet."""
    base = env_state.lane_base
    return BatchShard(env_state.global_lanes, slice(base, base + env_state.num_envs))


_MEAN_FINALS = {"mean_score": "final_score", "mean_length": "final_length",
                "mean_return": "final_return", "mean_lines": "final_lines",
                "mean_max_combo": "final_max_combo"}


def _episode_stats(done: torch.Tensor, final: Dict[str, torch.Tensor],
                   sharded: bool) -> Dict[str, torch.Tensor]:
    """The rollout's episode statistics: sums and counts (all-reduced in one
    vector over every rank's lanes when `sharded`), the largest score as a
    maximum."""
    dones_f = done.to(torch.float32)
    sums = torch.stack([dones_f.sum(),
                        final["invalid_action"].to(torch.float32).sum(),
                        torch.tensor(float(done.numel()), device=done.device),
                        *((final[k] * dones_f).sum() for k in _MEAN_FINALS.values())])
    max_score = torch.where(done, final["final_score"], 0).max()
    if sharded:
        sums, max_score = all_reduce_sum(sums), all_reduce_max(max_score)
    episodes, invalid, count, *finals = sums.unbind()
    n_done = torch.clamp(episodes, min=1.0)
    return {"episodes": episodes,
            **{k: v / n_done for k, v in zip(_MEAN_FINALS, finals)},
            "max_score": max_score.to(torch.float32),
            "invalid_frac": invalid / count}


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
    with span("ppo.gae", device=True):
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


def normalize_advantages(adv: torch.Tensor, total: Optional[int] = None
                         ) -> torch.Tensor:
    """Whole-buffer normalisation with the population std, as ``jnp.std``
    (`torch.std` would default to the unbiased one).  With `total`, `adv`
    is this rank's part of a buffer of `total` entries: the mean and then
    the variance are sums over ranks, in the same two passes."""
    if total is None:
        return (adv - adv.mean()) / (adv.std(correction=0) + ADV_EPS)
    mean = all_reduce_sum(adv.sum()) / total
    var = all_reduce_sum(((adv - mean) ** 2).sum()) / total
    return (adv - mean) / (torch.sqrt(var) + ADV_EPS)


def bc_weights(batch) -> torch.Tensor:
    """The ``adv_pos`` filter's weights: 1 on the executed search actions
    with a positive advantage, else 0 (float32)."""
    return (batch["search_used"] & (batch["adv"] > 0.0)).to(torch.float32)


def bc_loss_of(config: PPOConfig, logits, batch, total: Optional[int] = None,
               weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The behaviour-cloning loss (`bbx/agent/ppo.py:444-476`): CE against
    softmax(q / bc_q_temp) over the search's candidates for ``q_soft``,
    else the search action's negative log-probability, over every state
    (``all``) or the executed search actions with a positive advantage
    (``adv_pos``).  With `total`, the batch is this rank's rows of a
    global minibatch of `total` rows and the loss is this rank's part of
    the global one (the ranks' parts sum to it): a mean is the rank's sum
    over `total`, and ``adv_pos`` divides the rank's weighted sum by
    `weight_sum`, the global sum of `bc_weights`."""

    def mean(x):
        return torch.mean(x) if total is None else torch.sum(x) / total

    if config.bc_target == "q_soft":
        tgt = torch.softmax(batch["search_q"].to(torch.float32) / config.bc_q_temp, dim=-1)
        logp_cand = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                 batch["search_cand"].long())
        return -mean(torch.sum(tgt * logp_cand, dim=-1))
    bc_logp = D.log_prob(logits, batch["search_a"].to(torch.int32))
    if config.bc_filter == "adv_pos":
        w = bc_weights(batch)
        return -(torch.sum(bc_logp * w)
                 / torch.clamp(torch.sum(w) if weight_sum is None else weight_sum,
                               min=1.0))
    return -mean(bc_logp)


def ppo_loss(config: PPOConfig, logits, value, batch, ent_coef: float,
             bc_coef: float = 0.0, total: Optional[int] = None,
             bc_weight_sum: Optional[torch.Tensor] = None):
    """The clipped-surrogate loss and its metrics (0-dim tensors); with
    search, the dual clip and, where `bc_coef` > 0, the BC term.  With
    `total`, the batch is this rank's rows of a global minibatch of `total`
    rows, and each mean is the rank's sum over `total` (the ranks' losses
    and metrics then sum to the global ones); ``adv_pos``'s BC term then
    divides by `bc_weight_sum`, its weights' global sum."""

    def mean(x):
        return torch.mean(x) if total is None else torch.sum(x) / total

    new_logp = D.log_prob(logits, batch["action"])
    entropy = D.masked_entropy(logits, batch["mask"])
    logratio = new_logp - batch["logp"]
    ratio = torch.exp(logratio)
    adv = batch["adv"]
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - config.clip_epsilon,
                        1 + config.clip_epsilon) * adv
    per_sample = torch.minimum(surr1, surr2)
    if config.uses_search:
        # Stored logps are floored at -15, so ratios reach e^15: bound the
        # negative-advantage samples (Ye et al. 2020).
        per_sample = torch.where(adv < 0.0,
                                 torch.maximum(per_sample, DUAL_CLIP * adv),
                                 per_sample)
    policy_loss = -mean(per_sample)
    value_loss = mean((value - batch["ret"]) ** 2)
    entropy_mean = mean(entropy)
    loss = (policy_loss + config.value_coef * value_loss
            - ent_coef * entropy_mean)
    # A Python branch, not `where`: the untaken branch's NaN would reach
    # the gradient (the search fields hold dummies once BC has annealed).
    if config.uses_search and bc_coef > 0.0:
        bc_loss = bc_loss_of(config, logits, batch, total, bc_weight_sum)
        loss = loss + bc_coef * bc_loss
    else:
        bc_loss = torch.zeros((), device=value.device)
    with torch.no_grad():
        kl_lr = torch.clamp(logratio, -KL_LOGRATIO_CLIP, KL_LOGRATIO_CLIP)
        approx_kl = mean(torch.exp(kl_lr) - 1.0 - kl_lr)
        clip_frac = mean(
            ((ratio - 1.0).abs() > config.clip_epsilon).to(torch.float32))
    return loss, {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy_mean,
        "total_loss": loss,
        "approx_kl": approx_kl,
        "clip_fraction": clip_frac,
        "bc_loss": bc_loss.detach(),
    }


_BATCH_KEYS = ("board", "piece_ids", "used", "mask", "action", "logp")
# The metrics `ppo_loss` returns.
LOSS_METRICS = ("policy_loss", "value_loss", "entropy", "total_loss", "approx_kl",
                "clip_fraction", "bc_loss")


def _local_rows(idx: torch.Tensor, lanes: BatchShard, minibatch: int):
    """This rank's entries of a global minibatch `idx` (indices t *
    N_global + n of the global buffer): their rows of the rank's buffer (t *
    N_local + n - lane_base) and, as a `BatchShard`, their positions in the
    minibatch."""
    n_global, start, count = lanes.total, lanes.rows.start, lanes.rows.stop - lanes.rows.start
    env = idx % n_global
    pos = ((env >= start) & (env < start + count)).nonzero().squeeze(1)
    sel = idx[pos]
    return (sel // n_global) * count + (sel % n_global - start), BatchShard(minibatch, pos)


# cuDNN's deterministic algorithms: the update repeats bit for bit.
@deterministic_cudnn()
def update(config: PPOConfig, ts: TrainState, traj, advantages, returns,
           generator: torch.Generator,
           dropout_rng: Optional[torch.Generator] = None,
           lanes: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
    """`num_epochs` of shuffled minibatch PPO updates (`bbx/agent/ppo.py:387`).

    Trains `ts.network` in place, in train mode, through `ts.optimizer`
    (one Adam step per minibatch) and advances `ts.update_step` once;
    `generator` shuffles and `dropout_rng` draws the dropout masks.
    Returns the metrics averaged over every minibatch step, as 0-dim
    tensors.  With `lanes` (this rank's env columns of the global fleet,
    in a process group) `traj` holds those columns and the update runs
    over the global minibatches (module docstring); the metrics are then
    global, equal on every rank.
    """
    with span("ppo.update", device=True):
        return _update(config, ts, traj, advantages, returns, generator, dropout_rng, lanes)


def _update(config, ts, traj, advantages, returns, generator, dropout_rng, lanes):
    """`update`'s body, in its span."""
    total, mb = config.batch_size, config.minibatch_size
    if total % mb:
        raise ValueError(f"rollout batch {total} not divisible by minibatch {mb}")
    num_mb = total // mb
    keys = _BATCH_KEYS + tuple(_search_fields(config))
    local = advantages.numel()
    flat = {k: traj[k].reshape(local, *traj[k].shape[2:]) for k in keys}
    adv = normalize_advantages(advantages.reshape(local),
                               None if lanes is None else total)
    ret = returns.reshape(local)
    ent_coef = entropy_coef_at(config, ts.update_step)
    bc_coef = bc_coef_at(config, ts.update_step)
    params = [p for p in ts.network.parameters()]
    ts.network.train()
    # A rank with no row of a minibatch still runs a forward that couples
    # rows (BatchNorm's reductions) or draws (dropout); otherwise its
    # gradient is zero.
    lockstep = getattr(ts.network, "lockstep_forward", False)
    adv_pos_bc = (config.uses_search and bc_coef > 0.0 and config.bc_target == "argmax"
                  and config.bc_filter == "adv_pos")
    sums: Dict[str, torch.Tensor] = {}
    for _ in range(config.num_epochs):
        perm = torch.randperm(total, generator=generator, device=adv.device)
        for i in range(num_mb):
            with span("ppo.update.minibatch"):
                with span("ppo.update.forward", device=True):
                    idx = perm[i * mb:(i + 1) * mb]
                    kw = {}
                    if lanes is not None:
                        idx, kw["shard"] = _local_rows(idx, lanes, mb)
                    batch = {k: v[idx] for k, v in flat.items()}
                    batch["adv"], batch["ret"] = adv[idx], ret[idx]
                    ts.optimizer.zero_grad(set_to_none=True)
                    # adv_pos's BC term divides by its weights' global sum:
                    # every rank joins that sum, rows or none.
                    weight_sum = (all_reduce_sum(bc_weights(batch).sum())
                                  if lanes is not None and adv_pos_bc else None)
                    rows = idx.numel() or lockstep or lanes is None
                    if rows:
                        obs = _minibatch_obs(batch)
                        logits, value = ts.network(obs["board"], obs["pieces"],
                                                   obs["action_mask"],
                                                   generator=dropout_rng, **kw)
                        loss, aux = ppo_loss(config, logits, value, batch, ent_coef,
                                             bc_coef, None if lanes is None else mb,
                                             weight_sum)
                    else:
                        aux = {k: torch.zeros((), device=adv.device) for k in LOSS_METRICS}
                if rows:
                    with span("ppo.update.backward", device=True):
                        loss.backward()
                if lanes is not None:
                    with span("ppo.update.allreduce", device=True):
                        reduce_gradients(params)
                with span("ppo.update.optimizer", device=True):
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
    if lanes is not None:
        names = sorted(sums)
        reduced = all_reduce_sum(torch.stack([sums[k] for k in names]))
        sums = dict(zip(names, reduced.unbind()))
    return {k: v / steps for k, v in sums.items()}


def train_iteration(config: PPOConfig, reward_config: RewardConfig,
                    ts: TrainState, env_state: EnvState,
                    action_rng: torch.Generator, shuffle_rng: torch.Generator,
                    dropout_rng: Optional[torch.Generator] = None,
                    search_rng: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None):
    """One PPO iteration: rollout + GAE + update (`bbx/agent/ppo.py:533`).

    `ts` is trained in place and returned.  Returns (ts, env_state,
    metrics), the metrics as 0-dim tensors on the device; with search,
    also the iteration's `search_frac` and `bc_coef`.  With a distributed
    `mesh`, `env_state` is this rank's shard of the fleet and the metrics
    are global.
    """
    it = ts.update_step
    sharded = mesh is not None and mesh.distributed
    lanes = lane_shard(env_state) if sharded else None
    env_state, traj, last_value, ep_stats = rollout(
        ts.network, config, reward_config, env_state, action_rng, dropout_rng,
        update_step=it, search_rng=search_rng, mesh=mesh)
    advantages, returns = compute_gae(config, traj["reward"], traj["done"],
                                      traj["value"], last_value)
    metrics = update(config, ts, traj, advantages, returns, shuffle_rng,
                     dropout_rng, lanes)
    metrics.update(ep_stats)
    if config.uses_search:
        dev = last_value.device
        metrics["search_frac"] = torch.tensor(search_frac_at(config, it), device=dev)
        metrics["bc_coef"] = torch.tensor(bc_coef_at(config, it), device=dev)
    return ts, env_state, metrics
