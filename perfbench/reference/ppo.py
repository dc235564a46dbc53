"""PPO as the configuration states it, plainly: the schedules, GAE, the
clipped loss (with the dual clip and the Q-soft cloning term where the
run searches), the global-norm clip and Adam."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

ADV_EPS = 1e-8
ADAM_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
LOGP_FLOOR = -15.0
DUAL_CLIP = 3.0


@dataclass(frozen=True)
class Hyper:
    """What the reference reads of a configuration."""

    lr: float
    final_lr: Optional[float]
    gamma: float
    lam: float
    clip: float
    ent: float
    final_ent: Optional[float]
    value_coef: float
    max_grad_norm: float
    epochs: int
    minibatch: int
    rollout_steps: int
    num_envs: int
    total_timesteps: int
    search_frac: float
    final_search_frac: Optional[float]
    bc_coef: float
    final_bc_coef: Optional[float]
    bc_q_temp: float
    search_topk: int
    search_anneal_frac: float

    @classmethod
    def of(cls, config: dict) -> "Hyper":
        p, t = config.get("ppo", {}), config.get("training", {})
        for key, allowed in (("bc_target", ("q_soft",)), ("bc_filter", ("all",)),
                             ("adam_mu_dtype", (None,))):
            if p.get(key, allowed[0]) not in allowed:
                raise ValueError(f"the reference follows ppo.{key} in {allowed} only")
        return cls(
            lr=p.get("learning_rate", 3e-4), final_lr=p.get("final_learning_rate"),
            gamma=p.get("gamma", 0.99), lam=p.get("gae_lambda", 0.95),
            clip=p.get("clip_epsilon", 0.2), ent=p.get("entropy_coef", 0.01),
            final_ent=p.get("final_entropy_coef"), value_coef=p.get("value_coef", 0.5),
            max_grad_norm=p.get("max_grad_norm", 0.5), epochs=p.get("num_epochs", 10),
            minibatch=t.get("batch_size", 2048), rollout_steps=t.get("rollout_steps", 128),
            num_envs=t.get("num_envs", 64),
            total_timesteps=t.get("total_timesteps", 10_000_000),
            search_frac=p.get("rollout_search_frac", 0.0),
            final_search_frac=p.get("final_rollout_search_frac"),
            bc_coef=p.get("bc_coef", 0.0), final_bc_coef=p.get("final_bc_coef"),
            bc_q_temp=p.get("bc_q_temp", 1.0), search_topk=p.get("search_topk", 0),
            search_anneal_frac=p.get("search_anneal_frac", 1.0))

    @property
    def batch(self) -> int:
        return self.rollout_steps * self.num_envs

    @property
    def uses_search(self) -> bool:
        return (self.search_frac > 0 or (self.final_search_frac or 0) > 0
                or self.bc_coef > 0 or (self.final_bc_coef or 0) > 0)

    @property
    def schedule_updates(self) -> int:
        return int(self.total_timesteps // self.batch)

    def lr_at(self, opt_step: int) -> float:
        """The linear lr schedule over optimizer steps, in float32."""
        if self.final_lr is None or self.schedule_updates <= 0:
            return self.lr
        steps = self.schedule_updates * self.epochs * max(1, self.batch // self.minibatch)
        count = np.float32(min(max(opt_step, 0), steps))
        frac = np.float32(1.0) - count / np.float32(steps)
        return float(np.float32(self.lr - self.final_lr) * frac + np.float32(self.final_lr))

    def ent_at(self, update: int) -> float:
        return linear_at(self.ent, self.final_ent, self.schedule_updates, update)

    def search_frac_at(self, update: int) -> float:
        return linear_at(self.search_frac, self.final_search_frac, self.anneal, update)

    def bc_at(self, update: int) -> float:
        return linear_at(self.bc_coef, self.final_bc_coef, self.anneal, update)

    @property
    def anneal(self) -> int:
        return int(self.schedule_updates * self.search_anneal_frac)


def linear_at(c0: float, c1: Optional[float], horizon: int, update: int) -> float:
    """c0 -> c1 linearly over `horizon` PPO iterations, in float32."""
    if c1 is None or horizon <= 0:
        return float(np.float32(c0))
    frac = np.clip(np.float32(update) / np.float32(horizon), np.float32(0), np.float32(1))
    return float(np.float32(c0) + (np.float32(c1) - np.float32(c0)) * frac)


def gae(h: Hyper, rewards, dones, values, last_value):
    """Reverse-scan GAE in float64: (advantages, returns) [T, N]."""
    r, d, v = rewards.double(), dones.double(), values.double()
    adv = torch.empty_like(v)
    nxt_adv = torch.zeros_like(v[0])
    nxt_v = last_value.double()
    for t in reversed(range(r.shape[0])):
        nonterm = 1.0 - d[t]
        delta = r[t] + h.gamma * nxt_v * nonterm - v[t]
        nxt_adv = delta + h.gamma * h.lam * nonterm * nxt_adv
        adv[t] = nxt_adv
        nxt_v = v[t]
    return adv, adv + v


def normalize(adv: torch.Tensor) -> torch.Tensor:
    """Over the whole buffer, with the population std."""
    return (adv - adv.mean()) / (adv.std(correction=0) + ADV_EPS)


def log_prob(logits, action):
    return torch.log_softmax(logits, -1).gather(-1, action[:, None].long())[:, 0]


def masked_entropy(logits, mask):
    p = torch.softmax(logits, -1) * mask.float()
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-10)
    return -(p * torch.log(p.clamp(min=1e-10)) * mask.float()).sum(-1)


def loss(h: Hyper, logits, value, rows: dict, ent_coef: float, bc_coef: float):
    """The minibatch's loss, as the configuration states it, and its
    policy and value terms."""
    new_logp = log_prob(logits, rows["action"])
    ratio = torch.exp(new_logp - rows["logp"])
    adv = rows["adv"]
    per = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - h.clip, 1 + h.clip) * adv)
    if h.uses_search:
        per = torch.where(adv < 0, torch.maximum(per, DUAL_CLIP * adv), per)
    terms = {"policy": -per.mean(), "value": ((value - rows["ret"]) ** 2).mean()}
    total = (terms["policy"] + h.value_coef * terms["value"]
             - ent_coef * masked_entropy(logits, rows["mask"]).mean())
    if h.uses_search and bc_coef > 0:
        target = torch.softmax(rows["search_q"].float() / h.bc_q_temp, -1)
        logp_cand = torch.log_softmax(logits, -1).gather(-1, rows["search_cand"].long())
        total = total - bc_coef * (target * logp_cand).sum(-1).mean()
    return total, terms


class Adam:
    """Adam (eps 1e-5) after a global-norm clip, one step a minibatch."""

    def __init__(self, params: dict, moments: Optional[dict] = None, steps: int = 0):
        """Fresh, or from `moments` ({name: (m, v)}) after `steps` steps."""
        moments = moments or {k: (torch.zeros_like(v), torch.zeros_like(v))
                              for k, v in params.items()}
        self.m = {k: moments[k][0].float().clone() for k in params}
        self.v = {k: moments[k][1].float().clone() for k in params}
        self.t = steps

    @staticmethod
    def clip(grads: dict, max_norm: float) -> dict:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if norm < max_norm:
            return grads
        return {k: g / norm * max_norm for k, g in grads.items()}

    def step(self, params: dict, grads: dict, lr: float) -> dict:
        self.t += 1
        b1, b2 = ADAM_BETAS
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        return out
