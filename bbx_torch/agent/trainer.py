"""High-level PPO trainer on one device: train loop, logging, checkpoints.

Counterpart of `bbx/agent/trainer.py` for one CUDA card (or the CPU when
asked).  `bbx` places the fleet and the train state on a device mesh; the
port has no mesh yet (`parallel/` is ROADMAP.md Queue 1), so a config's
``mesh:`` section is ignored.  A checkpoint is one `torch.save` file
holding the params, the Adam state, both step counters, the env fleet and
the state of every generator (the fleet's, the action sampler's, the
minibatch shuffler's, the dropout masks' and the search's), so a resumed
run continues the exact trajectory of an uninterrupted one on the CPU.  (A
checkpoint saved before the search generator existed loads with that
generator freshly seeded.)  The params entry
is the network's state dict, so the flat CNN's BatchNorm running
statistics travel with it.  (On the card, cuDNN's convolution
backward sums with atomics, so two runs need not agree bit for bit.)
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Dict, Optional

import torch

from ..device import device_name, resolve_device
from ..engine.state import EnvState, make_generator, reset
from ..engine.step import RewardConfig
from ..models import network_from_config
from ..models.flops import network_flops
from ..utils.checkpoints import load_checkpoint, save_checkpoint
from ..utils.logging import Logger, MetricsTracker, TensorBoardLogger
from ..utils.profiling import PhaseTimer, trace
from .ppo import PPOConfig, TrainState, make_optimizer, train_iteration


# The trainer's generators, seeded seed + their index.
RNG_NAMES = ("fleet", "action", "shuffle", "dropout", "search")

# Dense peak FLOP/s of the cards whose name `torch.cuda.get_device_name`
# gives, by compute dtype (NVIDIA's H100 datasheet, the SXM5 part: the
# tensor cores' bf16 rate, the CUDA cores' float32 rate).  Another card or
# dtype has no `mfu` row.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {torch.bfloat16: 989.4e12, torch.float32: 66.9e12},
}
# `train(profile=True)` writes one trace of the iteration after this one.
TRACE_AT_UPDATE = 20


def ppo_config_from(config: Dict[str, Any],
                    total_timesteps: Optional[int] = None) -> PPOConfig:
    """The PPOConfig of a config dict (`bbx/agent/trainer.py:58`).  The
    schedules' horizon follows the effective run length, so a
    `total_timesteps` override stretches or shrinks the anneal with it."""
    ppo = config.get("ppo", {})
    tr = config.get("training", {})
    num_envs = tr.get("num_envs", 64)
    rollout_steps = tr.get("rollout_steps", 128)
    effective_total = total_timesteps or tr.get("total_timesteps", 10_000_000)
    schedule_updates = int(effective_total // (num_envs * rollout_steps))
    return PPOConfig(
        learning_rate=ppo.get("learning_rate", 3e-4),
        gamma=ppo.get("gamma", 0.99),
        gae_lambda=ppo.get("gae_lambda", 0.95),
        clip_epsilon=ppo.get("clip_epsilon", 0.2),
        entropy_coef=ppo.get("entropy_coef", 0.01),
        value_coef=ppo.get("value_coef", 0.5),
        max_grad_norm=ppo.get("max_grad_norm", 0.5),
        num_epochs=ppo.get("num_epochs", 10),
        minibatch_size=tr.get("batch_size", 2048),
        rollout_steps=rollout_steps,
        num_envs=num_envs,
        rollout_search_frac=ppo.get("rollout_search_frac", 0.0),
        final_rollout_search_frac=ppo.get("final_rollout_search_frac"),
        bc_coef=ppo.get("bc_coef", 0.0),
        final_bc_coef=ppo.get("final_bc_coef"),
        bc_filter=ppo.get("bc_filter", "all"),
        bc_target=ppo.get("bc_target", "argmax"),
        bc_q_temp=ppo.get("bc_q_temp", 1.0),
        search_topk=ppo.get("search_topk", 0),
        search_anneal_frac=ppo.get("search_anneal_frac", 1.0),
        adam_mu_dtype=ppo.get("adam_mu_dtype"),
        final_learning_rate=ppo.get("final_learning_rate"),
        final_entropy_coef=ppo.get("final_entropy_coef"),
        schedule_updates=schedule_updates,
    )


def reward_config_from(config: Dict[str, Any]) -> RewardConfig:
    rc = RewardConfig()
    rewards = config.get("rewards", {})
    return dataclasses.replace(
        rc, **{k: v for k, v in rewards.items() if hasattr(rc, k)})


def iteration_flops(config: PPOConfig, network: torch.nn.Module) -> int:
    """Matmul and convolution FLOPs of one train iteration, counted as
    `bbx/agent/trainer.py:_iteration_flops` counts them: the rollout's
    forward on `num_envs` observations times `rollout_steps`, plus the
    minibatch gradient step (forward, the evaluator's recompute, backward;
    `bbx_torch.models.flops`) times epochs times minibatches.  The last
    value, the search, GAE, the engine and Adam are left out."""
    return (network_flops(network, config.num_envs) * config.rollout_steps
            + network_flops(network, config.minibatch_size, grad=True)
            * config.num_epochs * config.num_minibatches)


def device_peak_flops(device: torch.device, dtype: torch.dtype) -> Optional[float]:
    """`PEAK_FLOPS` of the card `device` names, in `dtype`; None for the
    CPU or a card or dtype the table does not hold."""
    return PEAK_FLOPS.get(device_name(device), {}).get(dtype)


class PPOTrainer:
    """Owns the network, the optimizer, the env fleet and the generators.

    Generators, all on the trainer's device: the fleet's (piece draws,
    seeded `seed`), the action sampler's (`seed + 1`), the minibatch
    shuffler's (`seed + 2`), the dropout masks' (`seed + 3`) and the
    search's (`seed + 4`: the simulated fleet's regen draws and the
    search/policy mix); the initial weights come from a CPU generator
    seeded `seed`.
    """

    def __init__(self, config: Dict[str, Any], seed: int = 42,
                 total_timesteps: Optional[int] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.ppo = ppo_config_from(config, total_timesteps)
        self.rewards = reward_config_from(config)
        network = network_from_config(
            config.get("network", {}),
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.train_state = TrainState(network, make_optimizer(self.ppo, network))
        self.rngs = {name: make_generator(seed + i, self.device)
                     for i, name in enumerate(RNG_NAMES)}
        self.env_state = reset(self.ppo.num_envs, self.rngs["fleet"], self.device)
        self.global_step = 0
        self._loaded_extra: Dict[str, Any] = {}

    @property
    def network(self) -> torch.nn.Module:
        return self.train_state.network

    def evaluate(self, num_episodes: int = 100, seed: int = 10_000,
                 max_steps: int = 8192, chunk: int = 128,
                 stochastic: bool = False,
                 lookahead: bool = False) -> Dict[str, float]:
        """Evaluate the current policy (greedy by default) through
        `bbx_torch.cli.evaluate.evaluate_policy`; `lookahead` plays
        policy+1-ply search at the run's gamma and `search_topk` (search
        results, not the raw policy's)."""
        from ..cli.evaluate import evaluate_policy

        r = evaluate_policy(
            self.network, num_episodes=num_episodes,
            deterministic=not stochastic, seed=seed, max_steps=max_steps,
            chunk=chunk, lookahead=lookahead, gamma=self.ppo.gamma,
            reward_config=self.rewards, topk=self.ppo.search_topk,
            device=self.device,
        )
        return {
            "eval_score_mean": r["score_mean"],
            "eval_score_max": r["score_max"],
            "eval_score_median": r["score_median"],
            "eval_length_mean": r["length_mean"],
            "eval_completed": float(r["completed"]),
            "eval_truncated": float(r["truncated"]),
        }

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.network.parameters())

    def iterate(self) -> Dict[str, torch.Tensor]:
        """Run one PPO iteration (rollout + update); returns its metrics as
        0-dim tensors on the device."""
        _, self.env_state, metrics = train_iteration(
            self.ppo, self.rewards, self.train_state, self.env_state,
            self.rngs["action"], self.rngs["shuffle"], self.rngs["dropout"],
            self.rngs["search"])
        self.global_step += self.ppo.batch_size
        return metrics

    # ---- checkpointing ---------------------------------------------------
    def _payload(self, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        ts = self.train_state
        env = {f.name: getattr(self.env_state, f.name)
               for f in dataclasses.fields(EnvState) if f.name != "rng"}
        payload = {
            "params": ts.network.state_dict(),
            "optimizer": ts.optimizer.state_dict(),
            "update_step": ts.update_step,
            "global_step": self.global_step,
            "env_state": env,
            "rng_states": {k: g.get_state() for k, g in self.rngs.items()},
        }
        if extra:
            payload["extra"] = extra
        return payload

    def save(self, directory: str, name: str,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Save a full-state checkpoint and its ``.config.json`` sidecar
        (the sections that rebuild the network and the run)."""
        sidecar = {k: self.config[k] for k in ("network", "ppo", "rewards",
                                               "training") if k in self.config}
        return save_checkpoint(directory, name, self._payload(extra),
                               config=sidecar)

    def load(self, path: str) -> None:
        payload = load_checkpoint(path)
        ts = self.train_state
        ts.network.load_state_dict(payload["params"])
        ts.optimizer.load_state_dict(payload["optimizer"])
        ts.update_step = int(payload["update_step"])
        self.global_step = int(payload["global_step"])
        for name, g in self.rngs.items():
            if name in payload["rng_states"]:
                g.set_state(payload["rng_states"][name])
        env = payload["env_state"]
        if env["board"].shape[0] == self.ppo.num_envs:
            self.env_state = EnvState(
                **{k: v.to(self.device) for k, v in env.items()},
                rng=self.rngs["fleet"])
        self._loaded_extra = dict(payload.get("extra", {}) or {})

    def load_params_only(self, path: str) -> None:
        self.network.load_state_dict(load_checkpoint(path)["params"])


def train(
    config: Dict[str, Any],
    resume_path: Optional[str] = None,
    seed: Optional[int] = None,
    total_timesteps: Optional[int] = None,
    profile: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """The training entry point (`bbx/agent/trainer.py:435`).

    Returns final stats.  `seed=None` takes `training.seed` (42 if
    absent).  As in `bbx`: optional greedy eval every
    `logging.eval_interval` updates (which then gates the `best`
    checkpoint), a wall-clock budget (`training.max_hours`), exact resume,
    and a SIGTERM that stops the loop at the next iteration boundary and
    saves `final` + `latest`.  (bbx's `progress_callback` serves its GUI,
    which is not ported yet.)  `profile=True` times the phases (each
    iteration up to its metrics on the device), adds an `mfu` row
    (`iteration_flops` over an iteration's wall time and the card's
    `PEAK_FLOPS`) to each log line, writes one `torch.profiler` trace of
    the iteration after update `TRACE_AT_UPDATE` into ``<log_dir>/trace``
    and prints the phase report at the end.
    """
    tr_cfg = config.get("training", {})
    log_cfg = config.get("logging", {})
    paths = config.get("paths", {})
    if seed is None:
        seed = tr_cfg.get("seed", 42)
    total_timesteps = total_timesteps or tr_cfg.get("total_timesteps", 10_000_000)
    max_hours = tr_cfg.get("max_hours")

    ckpt_dir = paths.get("checkpoint_dir", "checkpoints")
    log_dir = paths.get("log_dir", "logs")
    os.makedirs(ckpt_dir, exist_ok=True)

    logger = Logger(log_dir, "ppo")
    tb = TensorBoardLogger(log_dir, "ppo")
    tracker = MetricsTracker(window_size=100)
    timer = PhaseTimer()

    trainer = PPOTrainer(config, seed=seed, total_timesteps=total_timesteps,
                         device=device)
    print(f"device: {trainer.device}")
    print(f"envs: {trainer.ppo.num_envs}  rollout: {trainer.ppo.rollout_steps}"
          f"  batch/update: {trainer.ppo.batch_size}")
    print(f"network parameters: {trainer.num_params:,}")

    best_score = -float("inf")
    best_eval = -float("inf")
    init_from = tr_cfg.get("init_from")
    if init_from and not resume_path:
        # Warm start: weights only -- fresh optimizer, schedules, fleet and
        # step counter.
        trainer.load_params_only(init_from)
        print(f"initialized params from {init_from}")
    if resume_path:
        trainer.load(resume_path)
        best_score = trainer._loaded_extra.get("best_score", best_score)
        best_eval = trainer._loaded_extra.get("best_eval", best_eval)
        tracker.update_many("score", trainer._loaded_extra.get("tracker_scores", []))
        tracker.update_many("length", trainer._loaded_extra.get("tracker_lengths", []))
        print(f"resumed from {resume_path} at step {trainer.global_step}")

    log_interval = log_cfg.get("log_interval", 10)
    save_interval = log_cfg.get("save_interval", 100)
    eval_interval = log_cfg.get("eval_interval", 0)  # 0 disables in-run eval
    eval_episodes = log_cfg.get("eval_episodes", 100)

    flops_per_iter = iteration_flops(trainer.ppo, trainer.network) if profile else None
    dtype = trainer.network.compute_dtype
    dtype_name = str(dtype).removeprefix("torch.")
    peak_flops = device_peak_flops(trainer.device, dtype) if profile else None
    if profile and not peak_flops:
        print(f"mfu: no peak known for the {device_name(trainer.device)} in "
              f"{dtype_name}: no mfu row")

    def _iterate():
        """One iteration, timed to its metrics on the device."""
        out = []
        with timer.phase("train_iter", block_on=out if profile else None):
            out.append(trainer.iterate())
        return out[0]

    def _extra():
        return {"best_score": best_score, "best_eval": best_eval,
                "tracker_scores": tracker.values("score"),
                "tracker_lengths": tracker.values("length")}

    # A SIGTERM stops the loop at the next iteration boundary; the finally
    # block then saves a full-state checkpoint, so (train, SIGTERM, resume)
    # == an uninterrupted run.
    preempted = threading.Event()
    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: preempted.set())

    update_idx = 0
    t_start = time.time()
    t_window = t_start
    steps_window = 0
    iter_window = 0
    peak_shown = False
    stop = False
    deadline = t_start + max_hours * 3600 if max_hours else None

    try:
        while trainer.global_step < total_timesteps and not stop:
            metrics = _iterate()
            update_idx += 1
            steps_window += trainer.ppo.batch_size
            iter_window += 1

            if profile and update_idx == TRACE_AT_UPDATE:
                trace_dir = os.path.join(log_dir, "trace")
                with trace(trace_dir):
                    metrics = _iterate()
                update_idx += 1
                steps_window += trainer.ppo.batch_size
                iter_window += 1
                print(f"profiler trace written to {trace_dir}")

            if deadline and time.time() > deadline:
                print(f"wall-clock budget ({max_hours}h) reached — stopping")
                stop = True
            if preempted.is_set():
                print("SIGTERM received — checkpointing and stopping")
                stop = True

            if update_idx % log_interval == 0 or stop:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                fps = steps_window / max(now - t_window, 1e-9)
                sec_per_iter = (now - t_window) / max(iter_window, 1)
                t_window, steps_window, iter_window = now, 0, 0
                tracker.update({"score": metrics["mean_score"],
                                "length": metrics["mean_length"]})
                row = {
                    "fps": fps,
                    "avg_score": tracker.get_mean("score"),
                    "max_score": metrics["max_score"],
                    "avg_length": tracker.get_mean("length"),
                    "policy_loss": metrics["policy_loss"],
                    "value_loss": metrics["value_loss"],
                    "entropy": metrics["entropy"],
                    "approx_kl": metrics["approx_kl"],
                    "clip_fraction": metrics["clip_fraction"],
                    "episodes": metrics["episodes"],
                    "invalid_frac": metrics["invalid_frac"],
                    "bc_loss": metrics["bc_loss"],
                }
                for key in ("search_frac", "bc_coef"):
                    if key in metrics:
                        row[key] = metrics[key]
                if flops_per_iter and peak_flops:
                    row["mfu"] = flops_per_iter / sec_per_iter / peak_flops
                    if not peak_shown:
                        peak_shown = True
                        print(f"mfu: {flops_per_iter:,} matmul and convolution "
                              f"FLOPs an iteration (recompute included) against "
                              f"{peak_flops:.4g} FLOP/s, the dense {dtype_name} peak of "
                              f"the {device_name(trainer.device)}")
                logger.log(row, step=trainer.global_step)
                for k, v in row.items():
                    tag = ("performance/" if k in
                           ("fps", "avg_score", "max_score", "avg_length", "mfu")
                           else "training/")
                    tb.log_scalar(tag + k, v, trainer.global_step)

                # Without in-run eval, `best` is gated on the rolling mean
                # of stochastic rollout scores once the window has substance.
                if (not eval_interval
                        and row["avg_score"] > best_score and update_idx > 10):
                    best_score = row["avg_score"]
                    trainer.save(ckpt_dir, "best", extra=_extra())

            if eval_interval and (update_idx % eval_interval == 0 or stop):
                with timer.phase("eval"):
                    ev = trainer.evaluate(eval_episodes)
                logger.log(ev, step=trainer.global_step)
                for k, v in ev.items():
                    tb.log_scalar("eval/" + k, v, trainer.global_step)
                print(f"  eval @ {trainer.global_step}: "
                      f"mean {ev['eval_score_mean']:.1f}  "
                      f"max {ev['eval_score_max']:.0f}  "
                      f"len {ev['eval_length_mean']:.1f}")
                if ev["eval_score_mean"] > best_eval:
                    best_eval = ev["eval_score_mean"]
                    trainer.save(ckpt_dir, "best", extra=_extra())

            if save_interval and update_idx % save_interval == 0:
                with timer.phase("checkpoint"):
                    trainer.save(ckpt_dir, f"checkpoint_{trainer.global_step}",
                                 extra=_extra())
                    trainer.save(ckpt_dir, "latest", extra=_extra())
    except KeyboardInterrupt:
        print("interrupted — saving final checkpoint")
    finally:
        trainer.save(ckpt_dir, "final", extra=_extra())
        if preempted.is_set():
            # Also refresh `latest`, so resume-from-latest picks up the
            # preempted state.
            trainer.save(ckpt_dir, "latest", extra=_extra())
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        logger.save_summary()
        tb.close()
        if profile:
            print(timer.report())

    elapsed = time.time() - t_start
    return {
        "global_step": trainer.global_step,
        "elapsed_sec": elapsed,
        "steps_per_sec": trainer.global_step / max(elapsed, 1e-9),
        "best_score": best_score,
        "best_eval": best_eval,
        "trainer": trainer,
    }
