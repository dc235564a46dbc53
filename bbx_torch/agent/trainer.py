"""High-level PPO trainer: train loop, logging, checkpoints, data parallelism.

Counterpart of `bbx/agent/trainer.py`, on one CUDA card (or the CPU when
asked) a process.  Where bbx places the fleet and the train state on a
device mesh, the port runs one process a device in a `torch.distributed`
group (`bbx_torch.parallel`): a config's ``mesh:`` section is checked
against the group (``num_data`` null or the world size, ``num_model`` 1),
each rank resets and steps only its contiguous shard of the fleet
(`host_env_slice`), the network and the generators are the same on every
rank (same seeds, every draw at the global shape), and the update reduces
across ranks (`bbx_torch.agent.ppo`), so a run on several ranks computes
what one process computes.  Search configs (``uses_search``) follow the
same rule: each rank simulates its lanes' tiling of the fleet as those
lanes of the whole fleet's tiling (`agent/lookahead.py:tile_state`), draws
the search/policy mix at the fleet's shape, and the BC term is a sum over
the global minibatch.

A checkpoint is one `torch.save` file holding the params, the Adam state,
both step counters, the whole env fleet (gathered to rank 0, which alone
writes) and the state of every generator (the fleet's, the action
sampler's, the minibatch shuffler's, the dropout masks' and the search's),
so a resumed run continues the exact trajectory of an uninterrupted one on
the CPU, and a checkpoint of a run on k ranks resumes on any world size
that divides its fleet.  (A checkpoint saved before the search generator
existed loads with that generator freshly seeded.)  The params entry is the
network's state dict, so the flat CNN's BatchNorm running statistics travel
with it.  On the card the update runs cuDNN's deterministic algorithms
(`bbx_torch.device.deterministic_cudnn`), so a run and its resumption
repeat bit for bit there too.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..device import device_name, resolve_device
from ..engine.state import EnvState, make_generator, reset
from ..engine.step import RewardConfig
from ..models import network_from_config
from ..models.flops import network_flops
from ..parallel.collectives import agree, broadcast_from_primary, gather_to_primary
from ..parallel.distributed import host_env_slice
from ..parallel.mesh import Mesh, mesh_from_config, replicate_tree, shard_batched_tree
from ..utils.checkpoints import load_checkpoint, save_checkpoint
from ..utils.logging import Logger, MetricsTracker, TensorBoardLogger
from ..utils import profiling
from ..utils.profiling import span, trace
from .lookahead import search_width
from .ppo import PPOConfig, TrainState, make_optimizer, searches_at, train_iteration


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


def iteration_flops(config: PPOConfig, network: torch.nn.Module, update_step: int = 0) -> int:
    """Matmul and convolution FLOPs of PPO iteration `update_step`, the
    work the model requires (`bbx_torch.models.flops`), as the benchmark's
    `mfu.train` counts it: the rollout's forward on `num_envs`
    observations on every step and the last value's, the search's value on
    `num_envs` x its width simulated lanes on every step of an iteration
    that searches, and each minibatch's gradient step (forward and
    backward, not the evaluator's recompute) times epochs times
    minibatches.  GAE, the engine and Adam are left out.  bbx's
    `_iteration_flops` counts the recompute and neither the last value nor
    the search (ROADMAP, Queue 3)."""
    n, steps = config.num_envs, config.rollout_steps
    total = network_flops(network, n) * (steps + 1)
    if searches_at(config, update_step):
        total += steps * network_flops(network, n * search_width(config.search_topk),
                                       value_only=True)
    return total + (network_flops(network, config.minibatch_size, grad=True, recompute=False)
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
    seeded `seed`.  In a process group every rank seeds the same ones and
    holds lanes `host_env_slice(num_envs)` of the fleet; `save` and
    `evaluate` are then collective (every rank calls them).
    """

    def __init__(self, config: Dict[str, Any], seed: int = 42,
                 total_timesteps: Optional[int] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh or mesh_from_config(config, self.device)
        self.ppo = ppo_config_from(config, total_timesteps)
        self.lanes = host_env_slice(self.ppo.num_envs)
        self.rewards = reward_config_from(config)
        network = network_from_config(
            config.get("network", {}),
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        if self.mesh.distributed:
            # Every rank drew these from the same seed; rank 0's are the
            # run's, whatever another rank's torch build drew.
            replicate_tree(network.state_dict())
        self.train_state = TrainState(network, make_optimizer(self.ppo, network))
        self.rngs = {name: make_generator(seed + i, self.device)
                     for i, name in enumerate(RNG_NAMES)}
        start, count = self.lanes
        self.env_state = reset(count, self.rngs["fleet"], self.device, start,
                               self.ppo.num_envs)
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
        results, not the raw policy's).  In a process group rank 0 plays
        and broadcasts its numbers (the parameters are the same on every
        rank), so every rank's `best` gate agrees."""
        if self.mesh.distributed:
            out = self._evaluate(num_episodes, seed, max_steps, chunk, stochastic,
                                 lookahead) if self.mesh.rank == 0 else None
            return broadcast_from_primary(out, self.mesh.cpu_group)
        return self._evaluate(num_episodes, seed, max_steps, chunk, stochastic,
                              lookahead)

    def _evaluate(self, num_episodes, seed, max_steps, chunk, stochastic, lookahead):
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
        with span("train.iteration", device=True):
            _, self.env_state, metrics = train_iteration(
                self.ppo, self.rewards, self.train_state, self.env_state,
                self.rngs["action"], self.rngs["shuffle"], self.rngs["dropout"],
                self.rngs["search"], self.mesh)
        self.global_step += self.ppo.batch_size
        return metrics

    # ---- checkpointing ---------------------------------------------------
    def _payload(self, extra: Optional[Dict[str, Any]] = None
                 ) -> Optional[Dict[str, Any]]:
        """The checkpoint's contents, the whole fleet gathered (as CPU
        copies) to rank 0 in a process group: collective there, and None
        on the other ranks."""
        ts = self.train_state
        env = {f.name: getattr(self.env_state, f.name)
               for f in dataclasses.fields(EnvState) if f.name != "rng"}
        if self.mesh.distributed:
            env = gather_to_primary(env, self.mesh.cpu_group)
            if env is None:
                return None
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
        (the sections that rebuild the network and the run).  In a process
        group every rank calls it: the fleet is gathered to rank 0, which
        alone writes, and every rank returns once the file is written."""
        sidecar = {k: self.config[k] for k in ("network", "ppo", "rewards",
                                               "training") if k in self.config}
        payload = self._payload(extra)
        path = os.path.abspath(os.path.join(directory, name))
        if payload is not None:
            path = save_checkpoint(directory, name, payload, config=sidecar)
        if self.mesh.distributed:
            dist.barrier(group=self.mesh.cpu_group)
        return path

    def load(self, path: str) -> None:
        """Restore a full-state checkpoint (every rank reads the file and
        keeps its lanes of the saved fleet, so a checkpoint of any world
        size that divides the fleet loads)."""
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
            env = shard_batched_tree(env, self.ppo.num_envs)
            self.env_state = EnvState(
                **{k: v.to(self.device) for k, v in env.items()},
                rng=self.rngs["fleet"]).sharded(self.lanes[0], self.ppo.num_envs)
        self._loaded_extra = dict(payload.get("extra", {}) or {})

    def load_params_only(self, path: str) -> None:
        self.network.load_state_dict(load_checkpoint(path)["params"])


def train(
    config: Dict[str, Any],
    resume_path: Optional[str] = None,
    seed: Optional[int] = None,
    progress_callback: Optional[Callable[[Dict[str, Any]], bool]] = None,
    total_timesteps: Optional[int] = None,
    profile: bool = False,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """The training entry point (`bbx/agent/trainer.py:435`).

    Returns final stats.  `seed=None` takes `training.seed` (42 if
    absent).  `progress_callback(row)` is called at each log row with
    ``{"step": global_step, **row}`` (bbx's keys; `mfu` only with
    `profile`), on rank 0 in a process group; returning False stops the
    loop, which then saves `final` as any stop does.  As in `bbx`: optional
    greedy eval every `logging.eval_interval` updates (which then gates the
    `best` checkpoint), a wall-clock budget (`training.max_hours`), exact
    resume, and a SIGTERM that stops the loop at the next iteration
    boundary and saves `final` + `latest`.  In a process group every rank
    runs `train`: a stop that one rank sees (its SIGTERM, its clock, rank
    0's callback) is agreed by all at the iteration boundary, since a rank
    that stopped alone would leave the others waiting in the next
    collective; logging, TensorBoard and the console are rank 0's.
    `profile=True` turns the program's tracer on
    (`bbx_torch.utils.profiling`), adds an `mfu` row (`iteration_flops` of
    the log window's iterations over its wall time and the group's
    `PEAK_FLOPS`) to each log line, writes one `torch.profiler` trace of the
    iteration after update `TRACE_AT_UPDATE` into ``<log_dir>/trace``, and
    prints at the end the phase report of the spans (`span_report`: host
    seconds by span path, device ms where the span has them) and the
    traced iteration's device idle time by program span.
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

    trainer = PPOTrainer(config, seed=seed, total_timesteps=total_timesteps,
                         device=device, mesh=mesh)
    mesh = trainer.mesh
    primary = mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)
    logger = Logger(log_dir, "ppo", console=primary, enabled=primary)
    tb = TensorBoardLogger(log_dir, "ppo", enabled=primary)
    tracker = MetricsTracker(window_size=100)
    phases: Dict[tuple, list] = {}  # `profiling.span_totals`
    traced = None
    tracing_was_on = profiling.TRACER.enabled
    if profile:
        profiling.enable()

    say(f"device: {trainer.device}")
    if mesh.distributed:
        say(f"mesh: {mesh.shape} ({mesh.backend}), {trainer.lanes[1]} envs a rank")
    say(f"envs: {trainer.ppo.num_envs}  rollout: {trainer.ppo.rollout_steps}"
        f"  batch/update: {trainer.ppo.batch_size}")
    say(f"network parameters: {trainer.num_params:,}")

    best_score = -float("inf")
    best_eval = -float("inf")
    init_from = tr_cfg.get("init_from")
    if init_from and not resume_path:
        # Warm start: weights only -- fresh optimizer, schedules, fleet and
        # step counter.
        trainer.load_params_only(init_from)
        say(f"initialized params from {init_from}")
    if resume_path:
        trainer.load(resume_path)
        best_score = trainer._loaded_extra.get("best_score", best_score)
        best_eval = trainer._loaded_extra.get("best_eval", best_eval)
        tracker.update_many("score", trainer._loaded_extra.get("tracker_scores", []))
        tracker.update_many("length", trainer._loaded_extra.get("tracker_lengths", []))
        say(f"resumed from {resume_path} at step {trainer.global_step}")

    log_interval = log_cfg.get("log_interval", 10)
    save_interval = log_cfg.get("save_interval", 100)
    eval_interval = log_cfg.get("eval_interval", 0)  # 0 disables in-run eval
    eval_episodes = log_cfg.get("eval_episodes", 100)

    dtype = trainer.network.compute_dtype
    dtype_name = str(dtype).removeprefix("torch.")
    peak_flops = device_peak_flops(trainer.device, dtype) if profile else None
    if profile and not peak_flops:
        say(f"mfu: no peak known for the {device_name(trainer.device)} in "
            f"{dtype_name}: no mfu row")
    # Ranks that share a card share its peak.
    num_devices = mesh.num_devices() if peak_flops else 1
    flops_window = 0

    def _iterate():
        """One iteration, its FLOPs counted where there is an mfu row."""
        nonlocal flops_window
        if peak_flops:
            flops_window += iteration_flops(trainer.ppo, trainer.network,
                                            trainer.train_state.update_step)
        return trainer.iterate()

    def _extra():
        return {"best_score": best_score, "best_eval": best_eval,
                "tracker_scores": tracker.values("score"),
                "tracker_lengths": tracker.values("length")}

    def _agreed(*flags: bool):
        """Each flag, raised on any rank (themselves in one process)."""
        return agree(*flags, group=mesh.cpu_group) if mesh.distributed else flags

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
    sigterm_seen = False
    failed = False
    deadline = t_start + max_hours * 3600 if max_hours else None

    try:
        while trainer.global_step < total_timesteps and not stop:
            metrics = _iterate()
            update_idx += 1
            steps_window += trainer.ppo.batch_size
            iter_window += 1

            if profile and update_idx == TRACE_AT_UPDATE:
                trace_dir = os.path.join(log_dir, "trace")
                with trace(trace_dir) as traced:
                    metrics = _iterate()
                update_idx += 1
                steps_window += trainer.ppo.batch_size
                iter_window += 1
                say(f"profiler trace written to {trace_dir}")

            # Each rank reports what it saw; the stop is the group's.
            if deadline and time.time() > deadline:
                print(f"wall-clock budget ({max_hours}h) reached — stopping")
                stop = True
            if preempted.is_set():
                print("SIGTERM received — checkpointing and stopping")
                stop = True
            agreed_stop, sigterm_seen = _agreed(stop, preempted.is_set())
            if agreed_stop and not stop:
                print("another rank stopped — checkpointing and stopping")
                stop = True

            if update_idx % log_interval == 0 or stop:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                seconds = max(now - t_window, 1e-9)
                fps = steps_window / seconds
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
                if peak_flops:
                    # The FLOPs of the global batch over every device's peak.
                    row["mfu"] = flops_window / seconds / (peak_flops * num_devices)
                    if not peak_shown:
                        peak_shown = True
                        say(f"mfu: {flops_window // max(iter_window, 1):,} matmul and "
                            f"convolution FLOPs an iteration (no recompute) against "
                            f"{peak_flops:.4g} FLOP/s on each of {num_devices} "
                            f"device(s), the dense {dtype_name} peak of the "
                            f"{device_name(trainer.device)}")
                t_window, steps_window, iter_window, flops_window = now, 0, 0, 0
                logger.log(row, step=trainer.global_step)
                for k, v in row.items():
                    tag = ("performance/" if k in
                           ("fps", "avg_score", "max_score", "avg_length", "mfu")
                           else "training/")
                    tb.log_scalar(tag + k, v, trainer.global_step)

                # Without in-run eval, `best` is gated on the rolling mean
                # of stochastic rollout scores once the window has substance
                # (the metrics are global, so every rank's gate agrees and
                # every rank joins the collective save).
                if (not eval_interval
                        and row["avg_score"] > best_score and update_idx > 10):
                    best_score = row["avg_score"]
                    trainer.save(ckpt_dir, "best", extra=_extra())

                if progress_callback is not None and primary:
                    if progress_callback({"step": trainer.global_step, **row}) is False:
                        stop = True
                (stop,) = _agreed(stop)

            if eval_interval and (update_idx % eval_interval == 0 or stop):
                with span("eval"):
                    ev = trainer.evaluate(eval_episodes)
                logger.log(ev, step=trainer.global_step)
                for k, v in ev.items():
                    tb.log_scalar("eval/" + k, v, trainer.global_step)
                say(f"  eval @ {trainer.global_step}: "
                    f"mean {ev['eval_score_mean']:.1f}  "
                    f"max {ev['eval_score_max']:.0f}  "
                    f"len {ev['eval_length_mean']:.1f}")
                if ev["eval_score_mean"] > best_eval:
                    best_eval = ev["eval_score_mean"]
                    trainer.save(ckpt_dir, "best", extra=_extra())

            if save_interval and update_idx % save_interval == 0:
                with span("checkpoint"):
                    trainer.save(ckpt_dir, f"checkpoint_{trainer.global_step}",
                                 extra=_extra())
                    trainer.save(ckpt_dir, "latest", extra=_extra())
            if profile:
                profiling.span_totals(profiling.snapshot(clear=True)["spans"], phases)
    except BaseException as e:
        # An error or an interrupt one rank raised is not seen by the others
        # (which may be inside a collective): a collective save would wait
        # on ranks that never arrive.
        failed = mesh.distributed
        if failed or not isinstance(e, KeyboardInterrupt):
            raise
        say("interrupted — saving final checkpoint")
    finally:
        if not failed:
            trainer.save(ckpt_dir, "final", extra=_extra())
            if sigterm_seen if mesh.distributed else preempted.is_set():
                # Also refresh `latest`, so resume-from-latest picks up the
                # preempted state (in a group, a SIGTERM any rank saw by the
                # last boundary, so that every rank saves alike).
                trainer.save(ckpt_dir, "latest", extra=_extra())
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        logger.save_summary()
        tb.close()
        if profile:
            profiling.span_totals(profiling.snapshot(clear=True)["spans"], phases)
            if not tracing_was_on:
                profiling.disable()
            say(profiling.span_report(phases))
            if traced is not None:
                say(traced.report())

    elapsed = time.time() - t_start
    return {
        "global_step": trainer.global_step,
        "elapsed_sec": elapsed,
        "steps_per_sec": trainer.global_step / max(elapsed, 1e-9),
        "best_score": best_score,
        "best_eval": best_eval,
        "trainer": trainer,
    }
