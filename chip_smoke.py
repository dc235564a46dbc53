#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bbx_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise):

1. identify the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels K1-K9 and K8's backward from `bbx_torch/csrc/`
   with nvcc;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (outputs must be exactly equal; floats too, to the
   last bit: K5's, and the reward and episode return of K6's
   `bbx_step_finish`; K8's scores and its backward's gradients within the
   tolerances PERF.md states), on
   reachable mid-game boards made by the port's own engine from a seed: K1
   at 512 lanes, on one lane and at the engine step's 16,384; K2 at 4,096
   lanes and on one; K3 at the lanes of those 4,096 the disjoint tier
   leaves, on one and at all 4,096 (with each call's launches counted); K4
   at the rollout's 512 lanes and at the update's 2048, in bf16 and
   float32 (planes, features and overlap); K8 (the evaluator's no-grad
   forward) at run9 widths at 512 and 2048 lanes in bf16 and float32, at
   the tests' tiny widths, at widths that fill no padded tile and at the
   width limits; K8's
   backward (K8b, K8w and the reduction) against the plain evaluator's
   autograd, each gradient within the tolerance PERF.md states, two runs
   bit for bit, at 2048 lanes in bf16 (the update minibatch), at 512 in
   bf16 and float32, at the tiny and ragged widths and at the width
   limits (where K8b's da1 shares da2t's shared memory), with the whole
   backward timed in turns with the plain autograd and the checkpointed
   cuDNN/cuBLAS forward + backward, and the reduction held to the same
   sums in float64, its device time by kernel and its library time
   (`torch.sum` and `torch.matmul`) reported; K9 (the sampler) bit for bit on the
   engine step's masks at 16,384 lanes, at 512 and at 16,383; K5 (GAE) bit
   for bit at run9's [128, 512], default's [128, 64] and tpu.yaml's
   [128, 4096]; K6's two
   entry points and the whole step (K6, K7, K6) on one step
   of the engine path's own fleet, at its 16,384 lanes and at the eval and
   train paths' 512; K7 on that step's inputs (its attempts equal to the
   step's own), at 512 lanes, and at the FLEET lanes' realistic need and
   with every lane in need; each timed as wrapper calls between CUDA
   events (`ms`), as device time by `torch.profiler` (`device_ms`) and as
   host time a call (`host_us`; K6's entry points through the launch
   helpers the step calls, on the step's checked inputs);
4. the engine path through `bbx_torch.cli.benchmark`: random-policy
   env-steps/s of 16,384 lanes (chunks of 64 steps, 5 windows of 10
   chunks, the 20% spread gate; a measurement that breaks it is taken
   again, up to 20 times, and every one is reported) with the launch
   counters set to 0 before and read after, a sweep over 4,096 /
   16,384 / 32,768 lanes, regen's draws per step from the step's
   `regen_attempts`, a profiled chunk (kernel launches and device time a
   step, at most ENGINE_MAX_LAUNCHES_PER_STEP launches; busy share; K6's
   and K7's device time a step), with K9 among the path's kernels, and
   one step under sync-debug mode "error";
5. the eval path: a 512-episode greedy eval of a seeded, freshly
   initialised AfterstateNetwork at the widths of `config/run9.yaml`
   (bf16) through `bbx_torch.cli.evaluate.main`, with every kernel's
   launch counter set to 0 before and read after;
6. check the results: finite statistics over 512 completed episodes, the
   float32 forward on the card (K8's float32 instantiation) against the
   same forward on the CPU, and
   seeded games of `ParityEngine` on the card against the CPU, move for
   move (the parity path, which runs K2 and K3 standalone; its launches
   are counted);
7. profile the first 16 steps of the eval loop (host time of the forward
   and of the step, device time by kernel, the device's busy share) and
   list the kernels of one forward, which must hold K8 once and no
   convolution but the value head's two;
8. the train path: run9's PPO recipe at full width and shape (512 envs x
   128 steps, minibatch 2048, 2 epochs) for 3 iterations through
   `bbx_torch.cli.train.main` from a JSON config, with the launch
   counters set to 0 before and read after, each iteration's rollout and
   update timed (its peak device memory read) and its losses checked
   finite, K8 launched on each rollout step and the last value and in
   every update minibatch, K8's backward (K8b, K8w, the reduction) once in
   every update minibatch, and the first minibatch's largest |rollout logp
   - update logp| and clip fraction before any optimizer step reported;
   then `latest` is loaded and one more iteration must be finite; then
   the determinism check: run9 and config/default.yaml's flat CNN in
   float32 (with TF32 and without), each trained twice from one seed for
   2 iterations and once saved after the first and resumed into a fresh
   trainer, every tensor of the end state (parameters and buffers, Adam's
   state, the fleet, every generator) and the metrics equal bit for bit;
   for the flat CNN without TF32, the first convolution or dense layer
   whose backward does not repeat without cuDNN's deterministic
   algorithms, named with its CUDA kernels, and the update's time with
   them and without, in turns; and one run9 iteration with
   ``adam_mu_dtype: bfloat16`` beside float32 mu in turns (the update's
   time, peak memory and moments' bytes; mu bf16);
9. one float32 PPO update at run9 widths on a fixed batch, card against
   CPU (losses and post-Adam parameters), the card's through K8 and K8's
   backward;
10. profile a 16-step rollout and a 4-minibatch update at run9 widths
   (device time by kernel, the device's busy share in each; an update
   minibatch must run K8 and K8's backward once each -- K8b's and K8w's
   kernels once, the reduction's twice -- and no convolution of the
   evaluator's size, only the value head's), then time
   the evaluator alone in turns: cuDNN in NCHW and channels-last, K8, and
   `torch.compile` of the plain evaluator where `import triton` works
   (`evaluator_layouts`; cuDNN channels-last and K8 at 512 and 2048
   lanes);
11. the flat CNN: the float32 forward at default widths, card against CPU
   in train mode (dropout off) and eval mode, then `bench_network` and
   `bench_train` at bbx's defaults (2 timed iterations, losses finite);
12. the search eval: `bbx_torch.cli.evaluate.main --lookahead` on phase
   5's network, 512 episodes at top-k 0 (all 192 actions: 98,304
   simulated lanes a step) and 512 at top-16, with the launch counters
   set to 0 before and read after each (K8 0 times a step at top-k 0 and
   once at top-16: the simulated states take the value head only; K6 twice
   a step), finite statistics; K6 (`auto_reset` off) and K7 against their
   plain versions on the simulated fleet's inputs at 8,192 and 98,304
   lanes, timed as in phase 3; one float32 lookahead call at 512 lanes,
   card against CPU (candidates, rewards, dones and simulated states
   equal, the CPU stepping the card's tiled fleet with its regen seed; Q
   within SEARCH_F32_ATOL with V(s') computed on the CPU from the card's
   simulated states; the action where the top two Q are apart);
13. distillation: config/run8.yaml (the flat CNN at its widths, Q-soft,
   top-16, 512 x 128, minibatch 2048, 4 epochs, bf16) for 2 iterations
   through `bbx_torch.cli.train.main` with the launch counters set to 0
   before and read after, each iteration's rollout and update timed,
   losses finite and the first iteration's `bc_loss` above 0; then
   `latest` is loaded and one more iteration run; then the search's share
   of a 16-step rollout;
14. the host API: a `BlockBlastEnv` game on the card under
   `sample_valid_action` (`np.random.seed`), each transition held against
   the engine's plain step from the same state and generator state (the
   state, observation and info equal, the reward bit for bit), replayed
   identically from the same seeds; the flat env's 178 values;
   `bbx_torch.cli.play` in random mode; `watch` of phase 5's seeded run9
   network from a checkpoint (K1, K4, K6, K7 and K8 launched; ms a move);
   K4 and K8 at one lane against their plain versions (into the kernels
   line's `at_other_shapes`); `bbx_torch.cli.benchmark --env` (env-steps/s
   and µs a step); `bbx_torch.cli.evaluate --render`; and
   `bbx_torch.cli.train --profile` for 21 iterations at a small fleet
   (run9's network and recipe at 64 x 32, minibatch 512): the `mfu` rows
   finite and in (0, 1], the phase report, the trace after update 20, the
   train kernels launched; and run9's mfu over phase 8's iterations;
15. two ranks on the one card: this script's ``--parallel-rank`` mode,
   started twice with the torchrun variables, runs the train CLI on cuda:0
   under gloo with the launch counters set to 0 before and read after:
   config/run9.yaml at full width (512 envs, 256 a rank) for 2 iterations
   and the collective save of `final`, then config/default.yaml's flat CNN
   (BatchNorm, dropout) for one, in bf16 and again in float32 without
   TF32; each rank's rollouts, updates, gradient
   all-reduces and save timed, and its parameters and buffers held bit for
   bit equal to the other rank's after every update; against a 1-rank run
   of each config and seed here: run9's first rollout statistics equal
   (PARALLEL_EXACT), its first update's losses within PARALLEL_LOSS_RTOL /
   PARALLEL_LOSS_ATOL, the flat CNN's BatchNorm running statistics after
   the first rollout step within PARALLEL_BN_TOL, and in float32 without
   TF32 its whole iteration (the first rollout's statistics equal, the
   first step's running statistics and the first minibatch's losses
   tight, the running statistics after the iteration and the update's
   losses within PARALLEL_F32_*, beside a second 1-rank run's spread);
   run9's 2-rank `final` resumed on 1 rank for one
   iteration; config/run8.yaml's search distillation at full width (512
   envs, top-16, Q-soft) for one iteration, in float32 without TF32
   (every search action and candidate set of the first rollout equal to
   1 rank's up to the first lane that a near-tie explains, shown with
   its pair of logits or Q and their gap (`search_rows`); with none, the
   first rollout's statistics and the first minibatch's losses held too;
   the first step's running statistics tight) and in bf16 (the first
   step's running statistics held, the rest reported), its bf16 2-rank
   `final` resumed on 1 rank, each rank's rollout, search and update
   seconds; K1, K4-K8, K8b, K8w launched on each rank (K4 and K8
   not for the flat CNN); K7 on rank 1's shard (256 lanes, lane base 256)
   and on its tiling for the search (4,096 lanes, lane base 4,096) against
   its plain version and the whole fleet's rows, timed beside the whole
   fleet (into the kernels line's K7 row); a 1-rank nccl group's
   all-reduce through the gradient path.  Two ranks share one card: their
   times are no scaling number;
16. the GUI's workers: `TrainingRunner` at 64 x 32 on run9's network,
   stopped by its callback after 2 rows with `final` written, and
   `watch_frames` for 50 moves (game after game, as the watch page plays)
   of phase 5's seeded run9 network from a checkpoint, equal move for
   move to `PolicyAgent` on `BlockBlastEnv`,
   each with the launch counters set to 0 before and read after;
17. the launchers: `bbx-torch-stable-train` at its recipe on the card
   for 2 iterations, then resumed from its checkpoint for one more, and
   `bbx-torch-quick-bench` three times (its verdict, exit code and rate),
   each with the launch counters set to 0 before and read after; a FAIL,
   or no steady measurement in any run, fails the phase.

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernels' numbers, and
``{"ok": true, "device": {...}}``; the full report goes to
``build/chip_smoke_report.json``.  With no CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

SEED = 777
FLEET = 4096          # lanes that make the mid-game boards for phase 3
EVAL_EPISODES = 512   # lanes of the main-path eval
K1_LANES = 512
K4_LANES = 512
K6_LANES = 512
K7_LANES = 512
GAE_T, GAE_N = 128, 512   # K5 at run9's rollout shape
# K5 also at config/default.yaml's and config/tpu.yaml's rollouts.
GAE_OTHER_SHAPES = ((128, 64), (128, 4096))
# K9 also at a lane count that fills no whole block or warp.
K9_RAGGED_LANES = 16383
TRAIN_SEED = 7
TRAIN_TIMESTEPS = 196_608  # 3 iterations of 512 envs x 128 steps
# The `network:` section of config/run9.yaml (ctx_dim at its default).
RUN9_NETWORK = {
    "type": "afterstate",
    "eval_channels": [24, 24],
    "eval_hidden": 96,
    "ctx_dim": 32,
    "value_channels": [48, 64],
    "value_hidden": 256,
    "compute_dtype": "bfloat16",
}
# config/run9.yaml's `ppo:` and `training:` sections; run9 sets no
# `rewards:`, so the defaults of `bbx_torch.utils.config` apply.
RUN9_PPO = {
    "learning_rate": 0.0003,
    "final_learning_rate": 0.00002,
    "gamma": 0.99,
    "gae_lambda": 0.95,
    "clip_epsilon": 0.2,
    "entropy_coef": 0.01,
    "final_entropy_coef": 0.0005,
    "value_coef": 0.5,
    "max_grad_norm": 0.5,
    "num_epochs": 2,
}
RUN9_TRAINING = {
    "num_envs": 512,
    "batch_size": 2048,
    "total_timesteps": 100000000,
    "rollout_steps": 128,
    "seed": 7,
    "max_hours": 2.4,
}
# config/run8.yaml's `ppo:`, `training:` and `network:` sections (the
# from-scratch Q-soft distillation run on the flat CNN); run8 sets no
# `rewards:`.
RUN8_PPO = {
    "learning_rate": 0.0003,
    "final_learning_rate": 0.00002,
    "gamma": 0.99,
    "gae_lambda": 0.95,
    "clip_epsilon": 0.2,
    "entropy_coef": 0.01,
    "final_entropy_coef": 0.0005,
    "value_coef": 0.5,
    "max_grad_norm": 0.5,
    "num_epochs": 4,
    "rollout_search_frac": 0.85,
    "final_rollout_search_frac": 0.0,
    "bc_coef": 1.2,
    "final_bc_coef": 0.0,
    "bc_target": "q_soft",
    "bc_q_temp": 0.25,
    "search_topk": 16,
    "search_anneal_frac": 0.55,
}
RUN8_TRAINING = {
    "num_envs": 512,
    "batch_size": 2048,
    "total_timesteps": 250000000,
    "rollout_steps": 128,
    "seed": 7,
    "max_hours": 2.5,
}
RUN8_NETWORK = {
    "conv_channels": [64, 128, 128],
    "fc_hidden": [512, 256],
    "use_batch_norm": True,
    "use_residual": True,
    "compute_dtype": "bfloat16",
}
DISTILL_TIMESTEPS = 131_072  # 2 iterations of 512 envs x 128 steps
# The eval CLI's search at run8's top-k (and at its default 0: all 192).
SEARCH_TOPK = RUN8_PPO["search_topk"]
# The float32 lookahead's Q, card against CPU (TF32 off; the value head's
# convolutions and dense layers in cuDNN / cuBLAS against the CPU's).
SEARCH_F32_ATOL = 1e-4
RUN9_REWARDS = {
    "line_clear_base": 1.0,
    "block_placed": 0.01,
    "game_over_penalty": -1.0,
    "hole_penalty": -0.05,
    "center_bonus": 0.02,
    "combo_multiplier_bonus": 0.5,
    "survival_bonus": 0.001,
}

# The kernels each path launches, by launch counter.  The verdict tiers K2
# and K3 run inside K7 on the step paths; their standalone kernels serve
# the parity engine.  K1 runs on the step paths only in `observe` at a
# reset: the step's own game-over test and masks are K6's
# (`_step_finish_cuda`).
PATH_KERNELS = {
    "eval": ("valid3_bits", "afterstate_buffer", "_move_core", "_step_finish_cuda",
             "regen_pieces", "evaluator_scores"),
    "train": ("valid3_bits", "afterstate_buffer", "compute_gae", "_move_core",
              "_step_finish_cuda", "regen_pieces", "evaluator_scores",
              "_evaluator_grad_tiles", "_evaluator_grad_dense0", "_evaluator_grad_reduce"),
    "engine": ("valid3_bits", "_move_core", "_step_finish_cuda", "regen_pieces",
               "sample_valid_actions_device"),
    "parity": ("valid3_bits", "solvable_disjoint_bits", "solvable_exact_bits",
               "_move_core"),
    # Phase 12 (top-k 0 and top-16 together; K4 and K8 only at top-16) and
    # phase 13 (the flat CNN: no K4 or K8; K1 in `observe` every search).
    "search_eval": ("valid3_bits", "afterstate_buffer", "_move_core", "_step_finish_cuda",
                    "regen_pieces", "evaluator_scores"),
    "distill": ("valid3_bits", "compute_gae", "_move_core", "_step_finish_cuda",
                "regen_pieces"),
    # Phase 14: the single env's game (K1 at its reset), `watch` (K4 and K8
    # at one lane) and the train CLI's profile at a small fleet.
    "single_env": ("valid3_bits", "_move_core", "_step_finish_cuda", "regen_pieces"),
    "watch": ("valid3_bits", "afterstate_buffer", "_move_core", "_step_finish_cuda",
              "regen_pieces", "evaluator_scores"),
    "train_profile": ("valid3_bits", "afterstate_buffer", "compute_gae", "_move_core",
                      "_step_finish_cuda", "regen_pieces", "evaluator_scores",
                      "_evaluator_grad_tiles", "_evaluator_grad_dense0",
                      "_evaluator_grad_reduce"),
    # Phase 15, on each rank: run9 (K1-K8 and K8's backward) and the flat
    # CNN (no K4 or K8).
    "parallel": ("valid3_bits", "afterstate_buffer", "compute_gae", "_move_core",
                 "_step_finish_cuda", "regen_pieces", "evaluator_scores",
                 "_evaluator_grad_tiles", "_evaluator_grad_dense0",
                 "_evaluator_grad_reduce"),
    "parallel_cnn": ("valid3_bits", "compute_gae", "_move_core", "_step_finish_cuda",
                     "regen_pieces"),
    # ... and config/run8.yaml's search distillation (the flat CNN: no K4
    # or K8; the search's simulated step is K6, K7, K6 on the tiled shard).
    "parallel_run8": ("valid3_bits", "compute_gae", "_move_core", "_step_finish_cuda",
                      "regen_pieces"),
    # Phase 16: the GUI's training runner and watch loop.
    "gui_train": ("valid3_bits", "afterstate_buffer", "compute_gae", "_move_core",
                  "_step_finish_cuda", "regen_pieces", "evaluator_scores",
                  "_evaluator_grad_tiles", "_evaluator_grad_dense0",
                  "_evaluator_grad_reduce"),
    "gui_watch": ("valid3_bits", "afterstate_buffer", "_move_core", "_step_finish_cuda",
                  "regen_pieces", "evaluator_scores"),
    # Phase 17: stable_train (the default flat CNN) and quick_bench (the
    # engine path at 16,384 lanes).
    "stable_train": ("valid3_bits", "compute_gae", "_move_core", "_step_finish_cuda",
                     "regen_pieces"),
    "quick_bench": ("valid3_bits", "_move_core", "_step_finish_cuda", "regen_pieces",
                    "sample_valid_actions_device"),
}
# The kernels line's rows (one a kernel) and the launch counters each
# sums: K6 has two entry points, `bbx_move` and `bbx_step_finish`.
ROW_COUNTERS = {
    "valid3_bits": ("valid3_bits",),
    "solvable_disjoint_bits": ("solvable_disjoint_bits",),
    "solvable_exact_bits": ("solvable_exact_bits",),
    "afterstate_buffer": ("afterstate_buffer",),
    "compute_gae": ("compute_gae",),
    "_move_core/_step_finish_cuda": ("_move_core", "_step_finish_cuda"),
    "regen_pieces": ("regen_pieces",),
    "evaluator_scores": ("evaluator_scores",),
    "_evaluator_grad_tiles": ("_evaluator_grad_tiles",),
    "_evaluator_grad_dense0": ("_evaluator_grad_dense0",),
    "_evaluator_grad_reduce": ("_evaluator_grad_reduce",),
    "sample_valid_actions_device": ("sample_valid_actions_device",),
}
ENGINE_LANES = 16384             # bench.py's fleet
ENGINE_SWEEP = (4096, 16384, 32768)
# 5 windows of 10 chunks of 64 steps (`bench_vec_env`'s defaults).
ENGINE_CHUNK, ENGINE_CHUNKS = 64, 10
# The fleet loop is host-bound, and the card's machine shares its host:
# the host's speed moves the rate by up to 2.5x between calls and by tens
# of percent within seconds, so that in a busy period most measurements
# break the 20% gate, pinned or not.  A measurement that breaks it is
# taken again on a fresh fleet, up to ENGINE_ATTEMPTS times; every attempt
# is reported (its median and spread, kept or not), and the phase fails
# when no attempt at ENGINE_LANES keeps the gate.  The other sweep sizes
# take at most SWEEP_ATTEMPTS, and one with no kept attempt is reported as
# such, with no rate.
ENGINE_ATTEMPTS = 20
SWEEP_ATTEMPTS = 4
# Kernel launches a step of the engine path may take, by the profiler:
# K6 twice, K7, the generator's two draws, the sampler (K9 and its seed's
# draw) and the reward sum.
ENGINE_MAX_LAUNCHES_PER_STEP = 25
# Words in the names of cuDNN's and CUTLASS's convolution kernels (PR 5's
# kernel lists: implicit_convolve_sgemm, convolve_common_engine,
# cutlass ... fprop, sm90_xmma_fprop_implicit_gemm).
CONV_KERNEL_WORDS = ("conv", "fprop", "winograd")

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, used as the ceiling for the
# kernels' 32-bit integer and bit operations (a 64-bit operation counts 2).
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
# The dense bf16 rate of the tensor cores (NVIDIA data sheet), K8's ceiling
# in bf16; in float32 it computes on the CUDA cores (the rate above).
PEAK_BF16_FLOPS_PER_S = 989e12
# K8 against its plain version (PERF.md): bf16 within 2e-2 |plain| + 2e-2
# max |plain| (the forward tests' bf16 tolerance: K8 rounds each layer
# once after its bias, where cuDNN also rounds the convolution before it,
# and sums in another order); float32 (TF32 off) within 1e-4.
K8_BF16_TOL = 2e-2
K8_F32_ATOL = 1e-4
# K8's backward against its plain version, `evaluator_grads_plain` (K8's
# rounding points in tensor ops; PERF.md), given K8's own ReLU decisions at
# conv2 and dense0: each gradient tensor g within tol |g_plain| + tol max
# |g_plain|, tol = K8_BF16_TOL in bf16 and K8B_F32_REL in float32 (TF32
# off; sums of up to 393,216 terms in another order).  The decisions may
# differ from the plain version's own where a float32 sum lands on the
# other side of a bf16 rounding boundary: at most K8B_FLIP_SHARE of them,
# each at a pre-activation within K8_BF16_TOL of the largest of 0.  K8w's partials,
# summed, against dz0^T x0 in float64: within K8W_REL of the largest
# element.  Against the plain evaluator's autograd, whose cuDNN
# convolutions round before their bias, bf16 ReLUs flip by the thousand:
# reported, with both against a float64 autograd.
K8B_F32_REL = 1e-4
K8B_FLIP_SHARE = 1e-2
K8W_REL = 1e-5
# The evaluator's largest widths ((C1, C2), H, D): EV_MAX_C, EV_MAX_H and
# EV_MAX_D in csrc/evaluator.cuh.
K8_LIMIT_WIDTHS = ((32, 32), 128, 256)
RUN9_EVAL_WIDTHS = (tuple(RUN9_NETWORK["eval_channels"]), RUN9_NETWORK["eval_hidden"],
                    RUN9_NETWORK["ctx_dim"])

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median per-call time of `fn` on the card (CUDA events around
    `inner` back-to-back calls, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_device_ms(fn, kernel: str, reps: int = 30):
    """Device time of one launch of `kernel` (a substring of its name) per
    call of `fn`, by `torch.profiler` over `reps` calls after a warm-up; a
    session that records no such kernel (it happens to a process's first)
    is taken again, twice at most, and then the time is "not measured"."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(t, c) for k, (t, c) in device_ms_by_kernel(prof).items() if kernel in k]
        calls = sum(c for _, c in hits)
        if calls:
            return sum(t for t, _ in hits) / calls
    return "not measured"


def host_us(fn, reps: int = 100) -> float:
    """Host time of one call of `fn` (its enqueue, not the device's work):
    median over 5 runs of `reps` back-to-back calls, synchronised between
    runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        samples.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def profiled_calls(fn, reps: int = 1, record_shapes: bool = False):
    """`fn`'s last result, the wall time of `reps` calls and the profiler
    that recorded them: a session of one warm-up call and then the `reps`
    calls (a profiler's schedule: a session's first calls lose some of
    their kernels' records, about the first 4 of 20 on the card)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                record_shapes=record_shapes) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(reps):
            result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return result, wall, prof


def calls_device(fn, reps: int = 20) -> dict:
    """Every kernel one call of `fn` launches, by `torch.profiler` over
    `reps` calls after a warm-up (`profiled_calls`): ``{"device_ms",
    "launches", "kernels": {name: [device ms, launches] a call}}``."""
    _, _, prof = profiled_calls(fn, reps)
    by_name = device_ms_by_kernel(prof)
    if not by_name:
        return {"device_ms": "not measured", "launches": "not measured", "kernels": {}}
    kernels = {}  # by the first 120 characters of the name, summed
    for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        t0, c0 = kernels.get(k[:120], (0.0, 0.0))
        kernels[k[:120]] = [t0 + t / reps, c0 + c / reps]
    return {"device_ms": sum(t for t, _ in by_name.values()) / reps,
            "launches": sum(c for _, c in by_name.values()) / reps,
            "kernels": kernels}


def forward_kernels(device, b: int = EVAL_EPISODES) -> dict:
    """The kernels of one eval forward of the seeded AfterstateNetwork at
    run9 widths (bf16, inference mode) on `b` fresh lanes (`calls_device`)."""
    import torch

    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe
    from bbx_torch.models import network_from_config

    net = network_from_config(RUN9_NETWORK, generator=torch.Generator().manual_seed(SEED))
    net = net.to(device).eval()
    obs = observe(reset(b, make_generator(SEED, device), device))
    with torch.inference_mode():
        return calls_device(lambda: net(obs["board"], obs["pieces"], obs["action_mask"]))


EVAL_LAYOUT_ORDER = ("nchw", "channels_last", "k8", "compiled", "compiled", "k8",
                     "channels_last", "nchw")


def evaluator_layouts(device) -> dict:
    """The evaluator alone at run9 widths in bf16, timed in turns
    (`EVAL_LAYOUT_ORDER`) between CUDA events: its forward at M = 512 x
    192 afterstates under ``no_grad`` (a rollout or eval step) with the
    input and activations in NCHW, in channels-last (the plain version's
    layout: cuDNN and cuBLAS, K8's library time), by K8, and as
    `torch.compile` of the channels-last forward where `import triton`
    works (a yardstick only, never on the path); and the forward plus
    backward under activation checkpointing at M = 2048 x 192 (an update
    minibatch) in NCHW and channels-last.  A seeded `_Evaluator`; seeded
    0/1 planes, features and context; the cuDNN forms take the features
    and the context already joined ([M, 35]) and the channels-last
    weights cast and laid out in one copy, as the model does; K8 takes
    the planes, the features and the [B, 3, 32] context."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from bbx_torch.models import afterstate as A

    dt = torch.bfloat16
    (c1, c2), hidden, ctx_dim = RUN9_EVAL_WIDTHS
    g = torch.Generator(device=device).manual_seed(SEED)
    ev = A._Evaluator((c1, c2), hidden, 3 + ctx_dim).to(device)
    with torch.no_grad():
        for p in ev.parameters():
            p.copy_((torch.rand(p.shape, generator=g, device=device) - 0.5) * 0.2)
    convs = [(conv.weight, conv.bias) for conv in ev.convs]
    dense = [(ev.dense0.weight, ev.dense0.bias), (ev.dense1.weight, ev.dense1.bias)]
    params = list(ev.parameters())

    def evaluator(boards, feats, channels_last):
        x = boards
        for w, b in convs:
            w = w.to(dt, memory_format=torch.channels_last) if channels_last else w.to(dt)
            x = F.relu(F.conv2d(x, w, b.to(dt), padding=1))
        if channels_last:
            x = x.permute(0, 2, 3, 1)
        x = torch.cat([x.reshape(x.shape[0], -1), feats], dim=-1)
        x = F.relu(F.linear(x, dense[0][0].to(dt), dense[0][1].to(dt)))
        return F.linear(x, dense[1][0].to(dt), dense[1][1].to(dt))[:, 0]

    def inputs(lanes):
        m = lanes * 192
        planes = (torch.rand((lanes, 192, 8, 8, 2), generator=g, device=device) < 0.4).to(dt)
        feats = torch.rand((lanes, 192, 3), generator=g, device=device).to(dt)
        ctx = torch.rand((lanes, 3, ctx_dim), generator=g, device=device).to(dt)
        joined = torch.cat([feats.view(m, 3),
                            ctx.repeat_interleave(64, dim=1).view(m, ctx_dim)], dim=-1)
        return planes, feats, ctx, joined

    # torch.compile's and Triton's caches inside the checkout's build/.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    try:
        import triton  # noqa: F401

        compiled = torch.compile(evaluator)
        compiled_error = None
    except Exception as e:  # the yardstick is optional
        compiled, compiled_error = None, f"{type(e).__name__}: {e}"
    turns = []
    for fmt in EVAL_LAYOUT_ORDER:
        if fmt == "compiled" and compiled is None:
            continue
        planes, feats, ctx, joined = inputs(K4_LANES)
        m = planes.shape[0] * 192
        boards = planes.view(m, 8, 8, 2).permute(0, 3, 1, 2)
        if fmt == "nchw":
            boards = boards.contiguous()
        fwd = {"nchw": lambda: evaluator(boards, joined, False),
               "channels_last": lambda: evaluator(boards, joined, True),
               "k8": lambda: A.evaluator_scores(ev, planes, feats, ctx, dt),
               "compiled": lambda: compiled(boards, joined, True)}[fmt]
        turn = {"layout": fmt}
        try:
            with torch.no_grad():
                turn["forward_ms"] = time_ms(fwd)
                if fmt in ("channels_last", "k8"):
                    # The same forward at the update minibatch's lanes.
                    big = inputs(RUN9_TRAINING["batch_size"])
                    mb = big[0].shape[0] * 192
                    bb = big[0].view(mb, 8, 8, 2).permute(0, 3, 1, 2)
                    turn["forward_2048_ms"] = time_ms(
                        (lambda: evaluator(bb, big[3], True)) if fmt == "channels_last"
                        else (lambda: A.evaluator_scores(ev, *big[:3], dt)), reps=7, inner=3)
                    del big, bb
        except Exception as e:
            if fmt != "compiled":
                raise
            compiled, compiled_error = None, f"{type(e).__name__}: {e}"
            continue
        if fmt in ("nchw", "channels_last"):
            planes, feats, ctx, joined = inputs(RUN9_TRAINING["batch_size"])
            m = planes.shape[0] * 192
            boards = planes.view(m, 8, 8, 2).permute(0, 3, 1, 2)
            if fmt == "nchw":
                boards = boards.contiguous()

            def train_step():
                for p in params:
                    p.grad = None
                scores = checkpoint(evaluator, boards, joined, fmt == "channels_last",
                                    use_reentrant=False)
                scores.float().sum().backward()

            turn["train_ms"] = time_ms(train_step, reps=7, inner=3)
        turns.append(turn)
        del planes, feats, ctx, joined, boards
        torch.cuda.empty_cache()
    out = {"turns": turns, "compiled_status": compiled_error or "measured"}
    for fmt in ("nchw", "channels_last", "k8", "compiled"):
        mine = [t for t in turns if t["layout"] == fmt]
        if mine:
            out[fmt] = {k: statistics.mean(t[k] for t in mine)
                        for k in ("forward_ms", "forward_2048_ms", "train_ms") if k in mine[0]}
    return out


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_SCALAR_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def midgame_boards(device):
    """Reachable boards: FLEET lanes of random valid play (auto-reset on),
    then a fresh random triple per lane."""
    import torch

    from bbx_torch.engine.solvability import board_bits
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe, step
    from bbx_torch.models import distributions as D

    g = make_generator(SEED, device)
    state = reset(FLEET, g, device)
    obs = observe(state)
    for _ in range(24):
        logits = D.mask_logits(torch.zeros(FLEET, 192, device=device),
                               obs["action_mask"])
        out = step(state, D.sample(g, logits), auto_reset=True)
        state, obs = out.state, out.obs
    ids = torch.randint(0, 37, (FLEET, 3), generator=g, device=device,
                        dtype=torch.int32)
    return state, obs, board_bits(state.board), ids


def kernel_phase(device, report):
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from bbx_torch.engine import solvability as S

    state, obs, bits, ids = midgame_boards(device)
    rows = []

    # K1 at K = 512 lanes x 3 slots (the rows' numbers) and on one lane
    # (the parity engine's shape); at the engine step's 16,384 below.
    k1 = k1_case(bits[:K1_LANES].contiguous(), ids[:K1_LANES].contiguous())
    k1_one = k1_case(bits[:1].contiguous(), ids[:1].contiguous())
    rows.append(dict(
        name="valid3_bits", source="bbx_torch/csrc/valid3.cu",
        replaces="bbx/engine/solvability.py:163 (valid3_bits; piece_fit_words :133)",
        **{key: k1[key] for key in CASE_KEYS}, at_other_shapes={"1": k1_one},
        shape=f"bits [{K1_LANES},2], ids [{K1_LANES},3] -> [{K1_LANES},3,64]; at one lane: "
              f"equal={k1_one['equal']}, {k1_one['ms']:.4f} ms (device "
              f"{k1_one['device_ms']}), bound {k1_one['bound_ms']:.6f} ms"))

    # K2 on all FLEET lanes (the rows' numbers) and on one lane.
    v3 = S.valid3_bits_plain(bits, ids)
    k2 = k2_case(bits, ids, v3)
    k2_one = k2_case(bits[:1].contiguous(), ids[:1].contiguous(), v3[:1].contiguous())
    fast = k2.pop("want")
    k2_one.pop("want")
    rows.append(dict(
        name="solvable_disjoint_bits", source="bbx_torch/csrc/solvable_disjoint.cu",
        replaces="bbx/engine/solvability.py:180 (solvable_disjoint_bits)",
        **{key: k2[key] for key in CASE_KEYS}, at_other_shapes={"1": k2_one},
        shape=f"ids [{FLEET},3], valid3 [{FLEET},3,64] -> [{FLEET}]; at one lane: "
              f"equal={k2_one['equal']}, {k2_one['ms']:.4f} ms (device "
              f"{k2_one['device_ms']}), bound {k2_one['bound_ms']:.6f} ms"))

    # K3 on the lanes the disjoint tier leaves (what regen gives it; the
    # row's numbers), on one lane and on all FLEET lanes.
    rest = (~fast).nonzero().squeeze(1)
    k3 = k3_case(bits[rest].contiguous(), ids[rest].contiguous(), v3[rest].contiguous())
    k3_one = k3_case(bits[:1].contiguous(), ids[:1].contiguous(), v3[:1].contiguous())
    k3_all = k3_case(bits, ids, v3)
    k = rest.numel()
    rows.append(dict(
        name="solvable_exact_bits", source="bbx_torch/csrc/solvable_exact.cu",
        replaces="bbx/engine/solvability.py:235 (solvable_exact_bits; _clear_lines_words :214)",
        **{key: k3[key] for key in CASE_KEYS},
        at_other_shapes={"1": k3_one, str(FLEET): k3_all},
        shape=f"bits [{k},2], ids [{k},3], valid3 [{k},3,64] -> [{k}] "
              f"(the {k} of {FLEET} draws the disjoint tier leaves); at one lane: "
              f"equal={k3_one['equal']}, device {k3_one['device_ms']}; at {FLEET}: "
              f"equal={k3_all['equal']}, device {k3_all['device_ms']}"))
    k3_cases = (k3, k3_one, k3_all)
    rows[-1]["equal"] = all(c["equal"] for c in k3_cases)

    # K4 at the rollout's and the eval's B = 512 (observations) and at the
    # update's B = 2048 (planes rebuilt from the compact buffer by the
    # update's own `_minibatch_obs`, used slots zeroed), in run9's bf16 and
    # in float32: planes, features and overlap exactly equal to the plain
    # version, dtypes included.  The row's times are bf16 at B = 512; the
    # evaluator's layout timings join it from phase 10.
    from bbx_torch.agent import ppo as P

    b, b2 = K4_LANES, RUN9_TRAINING["batch_size"]
    mb = P._minibatch_obs({"board": state.board[:b2], "mask": obs["action_mask"][:b2],
                           "piece_ids": state.piece_ids[:b2].to(torch.int8),
                           "used": state.used[:b2]})
    k4_in = {b: (obs["board"][:b].contiguous(), obs["pieces"][:b].contiguous()),
             b2: (mb["board"].contiguous(), mb["pieces"].contiguous())}
    bf16, f32 = torch.bfloat16, torch.float32
    row = k4_case(*k4_in[b], bf16)
    others = {f"{n}_{str(dt)[6:]}": with_bound(k4_case(*k4_in[n], dt))
              for n, dt in ((b, f32), (b2, bf16), (b2, f32))}
    row.update(
        name="afterstate_buffer", source="bbx_torch/csrc/afterstate.cu",
        replaces="bbx/models/afterstate.py:52 (afterstate_planes; the feature "
                 "concatenation and casts of AfterstateNetwork.__call__, :178-189)",
        equal=row["equal"] and all(c["equal"] for c in others.values()),
        max_abs_err=max([row["max_abs_err"]] + [c["max_abs_err"] for c in others.values()]),
        at_update_shape=others[f"{b2}_bfloat16"], at_other_shapes=others,
        shape=f"board [{b},8,8], pieces [{b},3,8,8] f32 -> one buffer: planes "
              f"[{b},192,8,8,2], feats [{b},192,3] (bf16), overlap [{b},192]; also "
              + "; ".join(f"{k}: equal={c['equal']}, {c['ms']:.4f} ms (device "
                          f"{c['device_ms']}), plain {c['plain_ms']:.4f} ms, bound "
                          f"{c['bound_ms']:.6f} ms" for k, c in others.items()))
    rows.append(row)

    # K8 at the rollout's and eval's B = 512 and the update minibatch's
    # 2048 at run9 widths, in bf16 and float32; at the tests' tiny widths;
    # at widths that fill no padded tile on 3 lanes (channels 5 / 12,
    # hidden 20, ctx 7): K8's tiles (64 afterstates in bf16, 16 in float32)
    # divide a lane's 192, so no row tile is ever partial, and these widths
    # leave its k and n tiles partial instead; and at the width limits.  The row's times are bf16 at B = 512; its
    # library time, cuDNN's channels-last evaluator, joins it from phase 10.
    k8_in = {n: (obs["board"][:n].float().contiguous(), obs["pieces"][:n].contiguous())
             for n in (b, b2, 3)}
    row = k8_case(device, RUN9_EVAL_WIDTHS, *k8_in[b], bf16)
    others = {"2048_bfloat16": k8_case(device, RUN9_EVAL_WIDTHS, *k8_in[b2], bf16),
              "512_float32": k8_case(device, RUN9_EVAL_WIDTHS, *k8_in[b], f32, fast=False),
              "2048_float32": k8_case(device, RUN9_EVAL_WIDTHS, *k8_in[b2], f32, fast=False),
              "tiny_512_bfloat16": k8_case(device, ((4, 4), 8, 6), *k8_in[b], bf16),
              "tiny_512_float32": k8_case(device, ((4, 4), 8, 6), *k8_in[b], f32),
              "ragged_3_bfloat16": k8_case(device, ((5, 12), 20, 7), *k8_in[3], bf16),
              "ragged_3_float32": k8_case(device, ((5, 12), 20, 7), *k8_in[3], f32),
              "limits_512_bfloat16": k8_case(device, K8_LIMIT_WIDTHS, *k8_in[b], bf16),
              "limits_512_float32": k8_case(device, K8_LIMIT_WIDTHS, *k8_in[b], f32,
                                            fast=False)}
    row.update(
        name="evaluator_scores", source="bbx_torch/csrc/evaluator.cu (+ mma.cuh)",
        replaces="bbx/models/afterstate.py:106 (_Evaluator.__call__, :114-127; run "
                 "under nn.remat at :185), the no-grad forward",
        equal=row["equal"] and all(c["equal"] for c in others.values()),
        max_abs_err=max([row["max_abs_err"]] + [c["max_abs_err"] for c in others.values()]),
        at_update_shape=others["2048_bfloat16"], at_other_shapes=others,
        shape=f"planes [{b},192,8,8,2], feats [{b},192,3], ctx [{b},3,32] bf16 at run9 "
              f"widths -> scores [{b * 192}] (largest |plain| {row['max_abs_plain']:.4g}, "
              f"err {row['max_abs_err']:.4g}, tolerance {row['tolerance']}); also "
              + "; ".join(f"{k}: within tolerance={c['equal']} (err {c['max_abs_err']:.4g} of "
                          f"largest {c['max_abs_plain']:.4g}), {c['ms']:.4f} ms (device "
                          f"{c['device_ms']}), plain {c['plain_ms']:.4f} ms, bound "
                          f"{c['bound_ms']:.6f} ms ({c['bound_by']})"
                          for k, c in others.items()))
    rows.append(row)

    # K8's backward (K8b, K8w, the reduction) at the update minibatch's B =
    # 2048 at run9 widths in bf16, which the rows report; at B = 512 in bf16
    # and float32, at the tiny and ragged widths, and at the width limits,
    # where K8b's da1 has no shared memory of its own and lies over da2t
    # (correctness and times under at_other_shapes).
    k8b = k8b_case(device, RUN9_EVAL_WIDTHS, *k8_in[b2], bf16)
    log(f"  K8's backward at B = {b2}, bf16: plan {k8b['plan']} (K8b's threads a block, "
        f"resident blocks an SM, grid; K8w's ring stages, resident blocks an SM, splits; "
        f"K8b's shared memory bytes, da1 in its own)")
    red = k8b["kernels"]["reduction"]
    log(f"  the reduction at B = {b2}: {red['ms']:.4f} ms, device {red['device_ms']} "
        f"(by kernel: {red['device_ms_by_kernel']}), plain {red['plain_ms']:.4f} ms, library "
        f"{red['library_ms']:.4f} ms; against float64: {k8b['reduction_vs_float64']}; K8b's "
        f"ReLU decisions apart from the plain version's: "
        + ", ".join(f"{k} {v['count']} (share {v['share']:.3g})"
                    for k, v in k8b["relu_flips"].items()))
    others = {"512_bfloat16": k8b_case(device, RUN9_EVAL_WIDTHS, *k8_in[b], bf16),
              "512_float32": k8b_case(device, RUN9_EVAL_WIDTHS, *k8_in[b], f32, fast=False),
              "tiny_512_bfloat16": k8b_case(device, ((4, 4), 8, 6), *k8_in[b], bf16),
              "tiny_512_float32": k8b_case(device, ((4, 4), 8, 6), *k8_in[b], f32),
              "ragged_3_bfloat16": k8b_case(device, ((5, 12), 20, 7), *k8_in[3], bf16),
              "ragged_3_float32": k8b_case(device, ((5, 12), 20, 7), *k8_in[3], f32),
              "limits_512_bfloat16": k8b_case(device, K8_LIMIT_WIDTHS, *k8_in[b], bf16,
                                              fast=False),
              "limits_512_float32": k8b_case(device, K8_LIMIT_WIDTHS, *k8_in[b], f32,
                                             fast=False)}
    equal = (k8b["equal"] and all(c["equal"] for c in others.values())
             and k8b["plan"]["k8b_da1_apart"] == 1
             and all(others[k]["plan"]["k8b_da1_apart"] == 0
                     for k in ("limits_512_bfloat16", "limits_512_float32")))
    summary = "; ".join(
        f"{k}: within tolerance={c['equal']} (same bits twice: {c['same_bits']}; worst "
        f"tensor err {c['max_abs_err']:.4g}), K8b {c['kernels']['K8b']['ms']:.4f} ms, K8w "
        f"{c['kernels']['K8w']['ms']:.4f} ms, reduction {c['kernels']['reduction']['ms']:.4f} "
        f"ms; whole backward + forward {c['whole']['kernels']:.4f} ms vs plain autograd "
        f"{c['whole']['plain']:.4f} ms, checkpointed {c['whole']['library']:.4f} ms"
        for k, c in others.items())
    for name, source, replaces, what in (
            ("_evaluator_grad_tiles", "bbx_torch/csrc/evaluator_backward.cu (+ evaluator.cuh, "
             "mma.cuh)", "bbx/models/afterstate.py:106 (_Evaluator.__call__, :114-127, under "
             "nn.remat at :185): the backward's recompute and per-tile gradients",
             "K8b"),
            ("_evaluator_grad_dense0", "bbx_torch/csrc/evaluator_backward.cu (+ mma.cuh, "
             "bulk.cuh)",
             "bbx/models/afterstate.py:123 (the hidden Dense of _Evaluator.__call__, under "
             "nn.remat at :185): its weight gradient", "K8w"),
            ("_evaluator_grad_reduce", "bbx_torch/csrc/evaluator_backward.cu",
             "bbx/models/afterstate.py:106 (_Evaluator under nn.remat at :185): the "
             "gradients' reduction and the context's gradient", "reduction")):
        k = k8b["kernels"][what]
        rows.append(dict(
            name=name, source=source, replaces=replaces, equal=equal,
            max_abs_err=max([k8b["max_abs_err"]] + [c["max_abs_err"] for c in others.values()]),
            **{key: k[key] for key in ("ms", "device_ms", "host_us", "plain_ms", "bound_ms",
                                       "bound_by")},
            library=k["library_ms"], device_ms_by_kernel=k["device_ms_by_kernel"],
            whole=k8b["whole"], errors=k8b["errors"], k8w_vs_float64=k8b["k8w_vs_float64"],
            reduction_vs_float64=k8b["reduction_vs_float64"],
            relu_flips=k8b["relu_flips"], plan=k8b["plan"],
            at_other_shapes={key: {"equal": c["equal"], "max_abs_err": c["max_abs_err"],
                                   "same_bits": c["same_bits"], "whole": c["whole"],
                                   "errors": c["errors"], "relu_flips": c["relu_flips"],
                                   "plan": c["plan"], **c["kernels"][what]}
                             for key, c in others.items()},
            shape=f"{what} of K8's backward at B = {b2}, run9 widths, bf16: planes "
                  f"[{b2},192,8,8,2], feats [{b2},192,3], ctx [{b2},3,32], ds [{b2 * 192}] "
                  f"-> dctx and the eight parameters' gradients, each tensor within "
                  f"{k8b['tolerance']} of the plain version (same bits twice: "
                  f"{k8b['same_bits']}; K8w's partials vs float64: "
                  f"{k8b['k8w_vs_float64']}; plan: {k8b['plan']}); plain_ms: "
                  + {"K8b": "the plain evaluator's forward + autograd backward (library: "
                            "the same under torch.utils.checkpoint, the update's path "
                            "before this kernel)",
                     "K8w": "dz0^T x0 by torch.matmul in float32 (library: in bf16)",
                     "reduction": "the same sums in tensor ops, float32 "
                                  "(`_GradWork.reduce_plain`; library: the records and "
                                  "partials summed by torch.sum, dctx by torch.matmul of "
                                  "the slot sums by W0's context columns)"}[what]
                  + f"; whole backward + forward {k8b['whole']['kernels']:.4f} ms vs plain "
                    f"autograd {k8b['whole']['plain']:.4f} ms, checkpointed "
                    f"{k8b['whole']['library']:.4f} ms (in turns); also " + summary))

    # K5 at run9's rollout shape, which the row reports, and at default's
    # and tpu.yaml's: seeded rewards / values, ~2% dones.
    g = torch.Generator(device=device).manual_seed(SEED)
    cfg = P.PPOConfig(gamma=RUN9_PPO["gamma"], gae_lambda=RUN9_PPO["gae_lambda"])
    k5 = {(t, n): k5_case(cfg, g, t, n) for t, n in ((GAE_T, GAE_N), *GAE_OTHER_SHAPES)}
    row = k5.pop((GAE_T, GAE_N))
    others = {f"{t}x{n}": c for (t, n), c in k5.items()}
    row.update(
        name="compute_gae", source="bbx_torch/csrc/gae.cu",
        replaces="bbx/agent/ppo.py:354 (compute_gae)",
        equal=row["equal"] and all(c["equal"] for c in others.values()),
        max_abs_err=max([row["max_abs_err"]] + [c["max_abs_err"] for c in others.values()]),
        at_other_shapes=others,
        shape=f"rewards, dones, values [{GAE_T},{GAE_N}], last_value [{GAE_N}] -> adv, ret "
              f"[{GAE_T},{GAE_N}] (equal bit for bit); also "
              + "; ".join(f"[{k.replace('x', ',')}]: equal={c['equal']}, {c['ms']:.4f} ms "
                          f"(device {c['device_ms']}), plain {c['plain_ms']:.4f} ms, bound "
                          f"{c['bound_ms']:.6f} ms" for k, c in others.items()))
    rows.append(row)

    # K6's `bbx_move` on reachable boards with some slots used, some lanes
    # done, streaks, and actions that are valid (3 in 4) or random, on all
    # FLEET lanes.  Then both of K6's entry points and the whole step (K6,
    # K7, K6), each against its plain version and timed, on one step of the
    # engine path's own fleet: at its 16,384 lanes and at the eval and
    # train paths' 512 (the fleet's first lanes), which the kernels line
    # reports.
    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST

    k = FLEET
    mv_state = state.replace(
        used=torch.rand((k, 3), generator=g, device=device) < 0.3,
        done=torch.rand(k, generator=g, device=device) < 0.1,
        streak=torch.randint(0, 9, (k,), generator=g, device=device,
                             dtype=torch.int32))
    u = torch.rand((k, 192), generator=g, device=device)
    pick = torch.where(obs["action_mask"], u, -1.0).argmax(1)
    rand = torch.randint(0, 192, (k,), generator=g, device=device)
    acts = torch.where(torch.arange(k, device=device) % 4 == 0, rand, pick)
    fleet_equal, fleet_err = compare(ST._move_core(mv_state, acts.to(torch.int32)),
                                     ST._move_core_plain(mv_state, acts))

    eng = engine_step_inputs(device)
    at_engine = k6_case(eng["state"], eng["actions"], eng["rng_state"])
    n = K6_LANES
    gen = torch.Generator(device=device)
    sub = eng["state"].replace(rng=gen, **{f: getattr(eng["state"], f)[:n].contiguous()
                                           for f in STATE_FIELDS})
    k6 = k6_case(sub, eng["actions"][:n].contiguous(), eng["rng_state"])
    with_bound(at_engine)
    rows.append(dict(
        name="_move_core/_step_finish_cuda", source="bbx_torch/csrc/move.cu",
        replaces="bbx/engine/step.py:89,143-289 (_move_core and the reward / "
                 "auto-reset block of step; count_holes, center_openness, "
                 "total_blocks of bbx/engine/kernel.py:135,163,187)",
        equal=fleet_equal and k6["equal"] and at_engine["equal"],
        max_abs_err=max(fleet_err, k6["max_abs_err"], at_engine["max_abs_err"]),
        **{key: k6[key] for key in ("ms", "plain_ms", "device_ms", "host_us", "nbytes",
                                    "ops", "entry_points", "step")},
        at_engine_shape=at_engine,
        shape=f"one engine-path step at {n} lanes: bbx_move (board [{n},8,8] u8, "
              f"ids/used [{n},3], done/streak/action [{n}] -> 17 outputs) + "
              f"bbx_step_finish (the state, bbx_move's outputs, K7's ids, a fresh "
              f"draw -> the new state, obs, reward, done, info); ms, device_ms and "
              f"host_us are the two entry points' sums, each one's under "
              f"entry_points; the whole step under step; bbx_move also checked "
              f"on all {k} FLEET lanes with random used/done/streak "
              f"(equal={fleet_equal}); at the engine step's {ENGINE_LANES} lanes: "
              f"equal={at_engine['equal']}, {at_engine['ms']:.4f} ms (device "
              f"{at_engine['device_ms']} ms), plain {at_engine['plain_ms']:.4f} ms, "
              f"bound {at_engine['bound_ms']:.6f} ms"))

    # K7 on the inputs of the same engine-path step (16,384 lanes), which the
    # kernels line reports; then at the eval and train paths' 512 lanes and
    # at the FLEET mid-game boards after the move above with its valid
    # actions (`pick`): the lanes that used their triple in need, then every
    # lane in need.  Each case runs the kernel and
    # its plain version on one seed tensor.
    engine = k7_case(eng["bits"], eng["ids"], eng["seed"], eng["need"])
    engine["matches_the_step"] = torch.equal(engine.pop("attempts"),
                                             eng["step_attempts"])
    engine["equal"] = engine["equal"] and engine["matches_the_step"]
    moved = ST._move_core(state, pick.to(torch.int32))
    seed = ES.regen_seed(g, device)
    other = {"eval_and_train_lanes": k7_case(moved.bits[:K7_LANES].contiguous(),
                                             state.piece_ids[:K7_LANES].contiguous(),
                                             seed, moved.need[:K7_LANES].contiguous()),
             "fleet_realistic": k7_case(moved.bits, state.piece_ids, seed, moved.need),
             "fleet_all_in_need": k7_case(moved.bits, state.piece_ids, seed,
                                          torch.ones_like(moved.need))}
    for case in other.values():
        case.pop("attempts")
        with_bound(case)
    k = ENGINE_LANES
    rows.append(dict(
        name="regen_pieces", source="bbx_torch/csrc/regen.cu",
        replaces="bbx/engine/state.py:161 (regen_pieces; _verdict_flat :83)",
        equal=engine["equal"] and all(c["equal"] for c in other.values()),
        max_abs_err=max(c["max_abs_err"] for c in (engine, *other.values())),
        ms=engine["ms"], plain_ms=engine["plain_ms"], device_ms=engine["device_ms"],
        host_us=engine["host_us"], nbytes=engine["nbytes"], ops=engine["ops"],
        at_other_shapes=other,
        shape=f"bits [{k},2], ids [{k},3], need [{k}] of one engine-path step "
              f"({engine['needy']} in need, {engine['attempts_mean']:.3f} draws each "
              f"on average, at most {engine['attempts_max']}; attempts equal to the "
              f"step's: {engine['matches_the_step']}) -> ids, attempts; "
              + "; ".join(f"{name} ({c['lanes']} lanes, {c['needy']} in need, "
                          f"{c['attempts_mean']:.3f} draws on average, at most "
                          f"{c['attempts_max']}): equal={c['equal']}, {c['ms']:.4f} ms "
                          f"(device {c['device_ms']}), plain {c['plain_ms']:.4f} ms, "
                          f"bound {c['bound_ms']:.6f} ms"
                          for name, c in other.items())))

    # K1 at the engine step's 16,384 lanes.
    k1_ids = ES.regen_pieces(eng["bits"], eng["ids"], eng["seed"], eng["need"])[0]
    e = rows[0]["at_engine_shape"] = k1_case(eng["bits"], k1_ids)
    rows[0]["equal"] = rows[0]["equal"] and e["equal"] and k1_one["equal"]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], e["max_abs_err"],
                                 k1_one["max_abs_err"])
    rows[0]["shape"] += (f"; at the engine step's {k} lanes: equal={e['equal']}, "
                         f"{e['ms']:.4f} ms (device {e['device_ms']}), plain "
                         f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.6f} ms")
    rows[1]["equal"] = rows[1]["equal"] and k2_one["equal"]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], k2_one["max_abs_err"])

    # K9 on the masks of the same engine-path step (16,384 lanes), which the
    # row reports, on their first 512 lanes and on their first
    # K9_RAGGED_LANES.
    k9 = k9_case(eng["mask"], eng["seed"])
    k9_512 = k9_case(eng["mask"][:512].contiguous(), eng["seed"])
    k9_ragged = k9_case(eng["mask"][:K9_RAGGED_LANES].contiguous(), eng["seed"])
    rows.append(dict(
        name="sample_valid_actions_device", source="bbx_torch/csrc/sample.cu (+ hash.cuh)",
        replaces="bbx/env/vector.py:90 (sample_valid_actions_device)",
        equal=k9["equal"] and k9_512["equal"] and k9_ragged["equal"],
        max_abs_err=max(k9["max_abs_err"], k9_512["max_abs_err"], k9_ragged["max_abs_err"]),
        **{key: k9[key] for key in ("ms", "device_ms", "host_us", "plain_ms", "bound_ms",
                                    "bound_by")},
        library=k9["library_ms"],
        at_other_shapes={"512": k9_512, str(K9_RAGGED_LANES): k9_ragged},
        shape=f"mask [{k9['lanes']},192] bool ({k9['empty_rows']} rows with no valid "
              f"action), seed: one int64 -> actions [{k9['lanes']}] int32 (equal bit for "
              f"bit); library: torch.multinomial over the rows, {k9['library_ms']:.4f} ms; "
              f"at 512 lanes: equal={k9_512['equal']}, {k9_512['ms']:.4f} ms (device "
              f"{k9_512['device_ms']}), plain {k9_512['plain_ms']:.4f} ms, library "
              f"{k9_512['library_ms']:.4f} ms; at {K9_RAGGED_LANES} lanes: "
              f"equal={k9_ragged['equal']}, {k9_ragged['ms']:.4f} ms (device "
              f"{k9_ragged['device_ms']})"))

    for r in rows:
        with_bound(r)
        r["route"] = "cuda"
        r["library_ms"] = r.pop("library", None)
        log(f"  {r['name']}: equal to plain (K8: within its tolerance)={r['equal']}, "
            f"kernel {r['ms']:.4f} ms "
            f"(device {r.get('device_ms')} ms, host {r.get('host_us')} us a call), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}); {r['shape']}")

    report["kernels"] = rows
    bad = [r["name"] for r in rows if not r["equal"]]
    # K1, K2 and K3: one launch a call at every shape.
    bad += [f"{name} at {c['lanes']} lanes: {c['launches_a_call']} launches a call"
            for name, c in (("K1", k1), ("K1", k1_one), ("K1", e), ("K2", k2), ("K2", k2_one),
                            *(("K3", c) for c in k3_cases))
            if c["launches_a_call"] != 1]
    if bad:
        raise AssertionError(f"kernel != plain version: {bad}")


def with_bound(d: dict) -> dict:
    """Replace a case's `nbytes` and `ops` by its bound (a case that has
    its bound already keeps it)."""
    if "bound_ms" not in d:
        d["bound_ms"], d["bound_by"] = bound_ms(d.pop("nbytes"), d.pop("ops"))
    return d


def k8_flops(b: int, widths) -> int:
    """K8's operations on b lanes (`bbx_torch.models.flops.k8_flops`): per
    afterstate conv1, conv2, dense0's conv and feature columns and dense1;
    per (lane, slot) the context's part of dense0; two operations a
    multiply-add."""
    from bbx_torch.models import flops

    return flops.k8_flops(b, widths)


def k8_bytes(b: int, widths, elem: int) -> int:
    """K8: planes, features and context read, the scores written (in the
    compute type), the float32 parameters read once."""
    (c1, c2), h, d = widths
    params = 18 * c1 + c1 + 9 * c1 * c2 + c2 + (64 * c2 + 3 + d) * h + h + h + 1
    return b * 192 * (128 + 3 + 1) * elem + b * 3 * d * elem + params * 4


def k8_case(device, widths, board, pieces, dtype, fast: bool = True) -> dict:
    """K8 against its plain version (cuDNN and cuBLAS; TF32 off) on the
    afterstates of `board`/`pieces`, for a seeded network at `widths`
    ((C1, C2), H, D) whose biases are seeded too: the largest error, the
    tolerance (`K8_BF16_TOL`, `K8_F32_ATOL`), times (`ms` between events,
    `device_ms` by the profiler, the forward kernel and the weight layout's
    summed, `host_us`), the plain version's time and the bound (bf16 at
    the tensor cores' dense rate, float32 at the CUDA cores')."""
    import torch

    from bbx_torch.device import float32_exact
    from bbx_torch.models import afterstate as A
    from bbx_torch.models import network_from_config

    (c1, c2), h, d = widths
    net = network_from_config(
        dict(RUN9_NETWORK, eval_channels=[c1, c2], eval_hidden=h, ctx_dim=d,
             compute_dtype=str(dtype)[6:]),
        generator=torch.Generator().manual_seed(SEED)).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_((torch.rand(p.shape, generator=g, device=device) - 0.5) * 0.2)
    b = board.shape[0]
    with torch.inference_mode(), float32_exact():
        planes, feats, ctx = net.afterstates(board, pieces)

        def fn():
            return A.evaluator_scores(net.evaluator, planes, feats, ctx, dtype)

        def plain():
            return A.evaluator_scores_plain(net.evaluator, planes, feats, ctx, dtype)

        before = A.evaluator_scores.launches
        got, want = fn(), plain()
        launched = A.evaluator_scores.launches - before
        err = (got.double() - want.double()).abs()
        scale = float(want.double().abs().max())
        if dtype == torch.bfloat16:
            allowed = K8_BF16_TOL * want.double().abs() + K8_BF16_TOL * scale
            tolerance = f"{K8_BF16_TOL} |plain| + {K8_BF16_TOL} max |plain|"
        else:
            allowed = torch.full_like(err, K8_F32_ATOL)
            tolerance = f"{K8_F32_ATOL}"
        reps, inner = (15, 10) if fast else (5, 2)
        main = kernel_device_ms(fn, "evaluator_kernel")
        layout = kernel_device_ms(fn, "evaluator_layout_kernel")
        out = dict(
            lanes=b, widths=[c1, c2, h, d], dtype=str(dtype), launches_a_call=launched,
            equal=bool((err <= allowed).all()) and launched == 1
            and bool(torch.isfinite(got).all()),
            max_abs_err=float(err.max()), max_abs_plain=scale, tolerance=tolerance,
            ms=time_ms(fn, reps, inner),
            device_ms=(main + layout if isinstance(main, float) and isinstance(layout, float)
                       else "not measured"),
            device_ms_forward=main, device_ms_layout=layout, host_us=host_us(fn),
            plain_ms=time_ms(plain, reps, inner))
    nbytes, flops = k8_bytes(b, widths, dtype.itemsize), k8_flops(b, widths)
    peak = PEAK_BF16_FLOPS_PER_S if dtype == torch.bfloat16 else PEAK_SCALAR_OPS_PER_S
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops, peak)
    out["bound_flops_ms"] = flops / peak * 1e3
    out["bound_bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    return out


def k8_net(device, widths, dtype):
    """A seeded AfterstateNetwork at `widths` ((C1, C2), H, D) whose biases
    are seeded too."""
    import torch

    from bbx_torch.models import network_from_config

    (c1, c2), h, d = widths
    net = network_from_config(
        dict(RUN9_NETWORK, eval_channels=[c1, c2], eval_hidden=h, ctx_dim=d,
             compute_dtype=str(dtype)[6:]),
        generator=torch.Generator().manual_seed(SEED)).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_((torch.rand(p.shape, generator=g, device=device) - 0.5) * 0.2)
    return net


def k8b_flops(b: int, widths) -> int:
    """K8's backward on b lanes (`bbx_torch.models.flops.k8b_flops`): the
    forward's recompute and, per afterstate, da2, dW2, da1, dW1 and
    dense1's gradient."""
    from bbx_torch.models import flops

    return flops.k8b_flops(b, widths)


def k8w_flops(b: int, widths) -> int:
    """K8w: dW0 = dz0^T x0 (`bbx_torch.models.flops.k8w_flops`)."""
    from bbx_torch.models import flops

    return flops.k8w_flops(b, widths)


def rel_l2(x, y) -> float:
    """||x - y|| / ||y|| in float64."""
    x, y = x.double(), y.double()
    return float((x - y).norm() / y.norm().clamp(min=1e-300))


def k8b_case(device, widths, board, pieces, dtype, fast: bool = True) -> dict:
    """K8's backward -- K8b (`_evaluator_grad_tiles`), K8w
    (`_evaluator_grad_dense0`) and the reduction (`_evaluator_grad_reduce`)
    -- on the afterstates of `board`/`pieces` and a seeded upstream
    gradient, for the seeded network of `k8_net`.  Checked against its
    plain version `evaluator_grads_plain` (K8's rounding points in tensor
    ops; TF32 off) given K8's own ReLU decisions at conv2 and dense0: each gradient
    tensor within tol |plain| + tol max |plain| (bf16: K8_BF16_TOL;
    float32: K8B_F32_REL), the decisions apart from the plain version's
    own few and near 0 (K8B_FLIP_SHARE); two runs
    bit for bit; K8w's partials summed against dz0^T x0 in float64
    (`K8W_REL`).  Reported, not checked: each tensor's largest error and
    relative L2 error against the plain evaluator's autograd (cuDNN and
    cuBLAS, which round the forward apart from K8, so ReLUs flip), and
    the relative L2 errors of K8's backward and of that autograd against
    a float64 autograd of the same bf16 or float32 values (`accuracy`).
    Times: each kernel's (`ms` between events, `device_ms` by the profiler,
    `host_us`) with its plain version's and, where one PyTorch call does
    the same, the library's; then the whole backward in turns with the
    plain autograd and the checkpointed cuDNN/cuBLAS forward + backward
    (`whole`)."""
    import copy

    import torch
    from torch.utils.checkpoint import checkpoint

    from bbx_torch.device import float32_exact
    from bbx_torch.models import afterstate as A

    net = k8_net(device, widths, dtype)
    ev = net.evaluator
    b = board.shape[0]
    (c1, c2), h, d = widths
    rel = K8_BF16_TOL if dtype == torch.bfloat16 else K8B_F32_REL
    g = torch.Generator(device=device).manual_seed(SEED + b)
    with torch.no_grad():
        planes, feats, ctx = net.afterstates(board, pieces)
    ds = torch.randn(b * 192, generator=g, device=device).to(dtype)
    leaf = ctx.detach().requires_grad_(True)
    params = [p for _, p in ev.named_parameters()]
    out = {"lanes": b, "widths": [c1, c2, h, d], "dtype": str(dtype)}
    with float32_exact():
        def plain():
            for p in (*params, leaf):
                p.grad = None
            A.evaluator_scores_plain(ev, planes, feats, leaf, dtype).backward(ds)

        def library():
            for p in (*params, leaf):
                p.grad = None
            checkpoint(ev, *A._plain_inputs(planes, feats, leaf), dtype,
                       use_reentrant=False).backward(ds)

        plain()
        autograd = [leaf.grad.clone()] + [p.grad.clone() for p in params]
        counters = (A._evaluator_grad_tiles, A._evaluator_grad_dense0, A._evaluator_grad_reduce)
        before = [c.launches for c in counters]
        with torch.no_grad():
            w = A._GradWork(ev, planes, feats, ctx, ds, dtype)
            # K8b's threads a block, resident blocks an SM (the occupancy
            # query) and grid; K8w's ring stages, resident blocks an SM and
            # splits.
            out["plan"] = w.plan
            for launch in (A._evaluator_grad_tiles, A._evaluator_grad_dense0,
                           A._evaluator_grad_reduce):
                launch(w)
            got = [w.dctx.clone()] + [x.clone() for x in w.grads()]
            again = A._evaluator_grads_cuda(ev, planes, feats, ctx, ds, dtype)
            # The plain version with K8's own ReLU decisions at conv2 and
            # dense0; where they differ from its own, a float32 sum landed on
            # the other side of a bf16 rounding boundary: few, each near 0.
            masks = w.relu_masks()
            want_ctx, want, pre = A.evaluator_grads_plain(ev, planes, feats, ctx, ds, dtype,
                                                          masks=masks)
            want = [want_ctx] + want
            out["relu_flips"], flips_ok = {}, True
            for layer, z in pre.items():
                flips = masks[layer] != (z > 0)
                f = out["relu_flips"][layer] = {
                    "count": int(flips.sum()), "share": float(flips.float().mean()),
                    "largest_abs_preactivation":
                        float(z[flips].abs().max()) if flips.any() else 0.0,
                    "largest_abs_preactivation_of_all": float(z.abs().max())}
                flips_ok = flips_ok and f["share"] <= K8B_FLIP_SHARE and (
                    f["largest_abs_preactivation"]
                    <= K8_BF16_TOL * f["largest_abs_preactivation_of_all"])
        launched = [c.launches - n for c, n in zip(counters, before)]
        same_bits = all(torch.equal(x, y) for x, y in zip(got, [again[0], *again[1]]))
        names = ["ctx"] + [n for n, _ in ev.named_parameters()]
        errs = {}
        ok = launched == [2, 2, 2] and same_bits and flips_ok
        # A float64 autograd of the same values: the accuracy of both.
        ev64 = copy.deepcopy(ev).double()
        leaf64 = ctx.detach().double().requires_grad_(True)
        A.evaluator_scores_plain(ev64, planes.double(), feats.double(), leaf64,
                                 torch.float64).backward(ds.double())
        exact = [leaf64.grad] + [p.grad for p in ev64.parameters()]
        del ev64, leaf64
        for name, x, y, z, e64 in zip(names, got, want, autograd, exact):
            x, y = x.double(), y.double()
            scale = float(y.abs().max())
            excess = float(((x - y).abs() - rel * y.abs() - rel * scale).max())
            errs[name] = {"max_abs_err": float((x - y).abs().max()), "max_abs_plain": scale,
                          "within": excess <= 0 and bool(torch.isfinite(x).all()),
                          "vs_autograd": {"max_abs_err": float((x - z.double()).abs().max()),
                                          "rel_l2": rel_l2(x, z)},
                          "accuracy_rel_l2_vs_float64": {"kernels": rel_l2(x, e64),
                                                         "autograd": rel_l2(z, e64)}}
            ok = ok and errs[name]["within"]
        # K8w alone: its splits' partials summed against dz0^T x0 in float64.
        hp = (h + 7) // 8 * 8
        dz0, x0 = w.dz0_matrix()[:, :hp], w.x0_matrix()
        kx = x0.shape[1]
        partials = w.partw.view(-1, hp, kx)
        exact = dz0.double().t() @ x0.double()
        k8w_err = float((partials.sum(0).double() - exact).abs().max())
        k8w_scale = float(exact.abs().max())
        out["k8w_vs_float64"] = {"max_abs_err": k8w_err, "max_abs": k8w_scale,
                                 "within": k8w_err <= K8W_REL * k8w_scale}
        ok = ok and out["k8w_vs_float64"]["within"]
        # The reduction against the same sums in float64 (its plain version,
        # `_GradWork.reduce_plain`): dctx and every gradient within tol of
        # it.  Its library time: the block records (19 C1 + C2 (9 C1 + 1) +
        # 2 H + 1 floats each) and K8w's partials summed by torch.sum, and
        # dctx as torch.matmul of the slot sums of the tiles' dz0 sums by
        # W0's context columns.
        exact_ctx, exact = w.reduce_plain(torch.float64)
        red = {}
        for name, x, y in (("ctx", w.dctx, exact_ctx), ("grads", w.flat, exact)):
            x, y = x.double(), y.double()
            excess = float(((x - y).abs() - rel * y.abs() - rel * y.abs().max()).max())
            red[name] = {"max_abs_err": float((x - y).abs().max()),
                         "max_abs": float(y.abs().max()), "within": excess <= 0}
        out["reduction_vs_float64"] = red
        ok = ok and all(r["within"] for r in red.values())
        records = w.part.view(w.plan["k8b_blocks"], -1)[:, :19 * c1 + c2 * (9 * c1 + 1) + 2 * h + 1]
        tiles = w.stile.view(b * 3, -1, hp)[:, :, :h]
        wctx = ev.dense0.weight.detach()[:, 64 * c2 + 3:].to(dtype).float().contiguous()
        dz0_c, x0_c = dz0.contiguous(), x0.contiguous()
        dz0_f, x0_f = dz0_c.float(), x0_c.float()
        reps, inner = (15, 10) if fast else (5, 2)
        kernels = {}
        for name, launch, names_k, plain_fn, lib_fn in (
                ("K8b", A._evaluator_grad_tiles,
                 ("evaluator_grad_tiles_kernel", "evaluator_layout_kernel"), plain, library),
                ("K8w", A._evaluator_grad_dense0, ("evaluator_grad_dense0_kernel",),
                 lambda: torch.matmul(dz0_f.t(), x0_f),
                 lambda: torch.matmul(dz0_c.t(), x0_c)),
                ("reduction", A._evaluator_grad_reduce, None,
                 lambda: w.reduce_plain(torch.float32),
                 lambda: (records.sum(0), partials.sum(0),
                          torch.matmul(tiles.sum(1), wctx)))):
            def fn(launch=launch):
                with torch.no_grad():
                    launch(w)
            if names_k:
                dev = [kernel_device_ms(fn, k) for k in names_k]
                by_kernel = dict(zip(names_k, dev))
                device = (sum(dev) if all(isinstance(x, float) for x in dev)
                          else "not measured")
            else:  # every kernel the call launches, each apart
                calls = calls_device(fn)
                by_kernel = {k: v[0] for k, v in calls["kernels"].items()}
                device = calls["device_ms"]
            kernels[name] = dict(
                ms=time_ms(fn, reps, inner),
                device_ms=device,
                device_ms_by_kernel=by_kernel,
                host_us=host_us(fn, reps=20 if fast else 5),
                plain_ms=time_ms(plain_fn, reps, inner),
                library_ms=time_ms(lib_fn, reps, inner) if lib_fn else None)
        whole = {"kernels": [], "plain": [], "library": []}

        def kernels_fn():
            for p in (*params, leaf):
                p.grad = None
            A.EvaluatorFunction.apply(ev, planes, feats, leaf, dtype, *params).backward(ds)

        for which in ("library", "plain", "kernels", "kernels", "plain", "library"):
            fn = {"library": library, "plain": plain, "kernels": kernels_fn}[which]
            whole[which].append(time_ms(fn, reps=7 if fast else 3, inner=3 if fast else 1))
        out["whole"] = {k: statistics.mean(v) for k, v in whole.items()}
    out.update(equal=ok, launches_a_call=launched, same_bits=same_bits, errors=errs,
               max_abs_err=max(e["max_abs_err"] for e in errs.values()),
               tolerance=f"{rel} |plain| + {rel} max |plain| per tensor, K8's ReLU "
                         f"decisions at conv2 and dense0 ("
                         + ", ".join(f"{k} {v['count']}" for k, v in out["relu_flips"].items())
                         + f" apart from the plain version's, within {K8_BF16_TOL} of "
                           f"the largest pre-activation of 0)",
               kernels=kernels)
    es = dtype.itemsize
    peak = PEAK_BF16_FLOPS_PER_S if dtype == torch.bfloat16 else PEAK_SCALAR_OPS_PER_S
    n_params = sum(p.numel() for p in params)
    bounds = {
        # inputs and the upstream gradient read, x0 and dz0 written.
        "K8b": (k8_bytes(b, widths, es) + b * 192 * es + (w.x0.numel() + w.dz0.numel()) * es
                + (w.stile.numel() + w.part.numel()) * 4, k8b_flops(b, widths)),
        "K8w": ((w.x0.numel() + w.dz0.numel()) * es + w.partw.numel() * 4,
                k8w_flops(b, widths)),
        "reduction": ((w.part.numel() + w.partw.numel() + w.stile.numel() + n_params) * 4
                      + b * 3 * d * es, w.part.numel() + w.partw.numel() + 2 * b * 3 * d * h),
    }
    for name, (nbytes, ops) in bounds.items():
        k = kernels[name]
        k["bound_ms"], k["bound_by"] = bound_ms(nbytes, ops, peak if name != "reduction"
                                                else PEAK_SCALAR_OPS_PER_S)
    return out


def k9_case(mask, seed) -> dict:
    """K9 and its plain version on one mask and seed: bit for bit, times,
    and the library's `torch.multinomial` over the mask's rows (a row with
    no valid action weighted on action 0, which K9 returns there)."""
    import torch

    from bbx_torch.env import vector as V

    n = mask.shape[0]
    got = V._sample_valid_actions_cuda(mask, seed)
    want = V.sample_valid_actions_plain(mask, seed)
    weights = mask.float()
    weights[:, 0] += (~mask.any(dim=1)).float()

    def fn():
        return V._sample_valid_actions_cuda(mask, seed)

    nbytes, ops = n * 192 + 8 + n * 4, n * 192
    t, by = bound_ms(nbytes, ops)
    return dict(lanes=n, equal=bool(torch.equal(got, want)) and got.dtype == want.dtype,
                max_abs_err=max_abs_err(got, want), empty_rows=int((~mask.any(dim=1)).sum()),
                ms=time_ms(fn), device_ms=kernel_device_ms(fn, "sample_kernel"),
                host_us=host_us(fn),
                plain_ms=time_ms(lambda: V.sample_valid_actions_plain(mask, seed)),
                library_ms=time_ms(lambda: torch.multinomial(weights, 1)),
                bound_ms=t, bound_by=by)


def k5_case(cfg, g, t: int, n: int) -> dict:
    """K5 and its plain version on seeded [t, n] rewards and values, ~2%
    dones (and dones at t = 0 and t = T - 1): bit for bit, times, bound
    (17 bytes an element and last_value; 8 float operations an element)."""
    import torch

    from bbx_torch.agent import ppo as P

    device = g.device
    args = (torch.randn((t, n), generator=g, device=device),
            torch.rand((t, n), generator=g, device=device) < 0.02,
            torch.randn((t, n), generator=g, device=device),
            torch.randn(n, generator=g, device=device))
    args[1][0, ::7] = True
    args[1][-1, ::5] = True
    got = P.compute_gae(cfg, *args)
    want = P.compute_gae_plain(cfg, *args)

    def fn():
        return P.compute_gae(cfg, *args)

    return with_bound(dict(
        shape_tn=[t, n], equal=all(torch.equal(x, y) for x, y in zip(got, want)),
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
        ms=time_ms(fn), device_ms=kernel_device_ms(fn, "gae_kernel"), host_us=host_us(fn),
        plain_ms=time_ms(lambda: P.compute_gae_plain(cfg, *args), reps=5, inner=2),
        nbytes=t * n * (4 + 1 + 4 + 4 + 4) + n * 4, ops=t * n * 8))


def k4_bytes(b: int, elem: int) -> int:
    """K4: board and pieces read (1,024 B a lane); 192 actions x (128
    plane values and 3 features of `elem` bytes, and an overlap byte)
    written."""
    return b * 1024 + b * 192 * (131 * elem + 1)


def k4_ops(b: int) -> int:
    """K4: about 60 64-bit operations an action for the move (120 32-bit)."""
    return b * 192 * 120


def k4_case(bd, pc, dtype) -> dict:
    """K4 against its plain version on boards `bd` and pieces `pc` in
    `dtype`: every output exactly equal, times and the bound's bytes and
    operations."""
    from bbx_torch.models import afterstate as A

    def fn():
        return A.afterstate_buffer(bd, pc, dtype)

    equal, err = compare(fn(), A.afterstate_buffer_plain(bd, pc, dtype))
    b = bd.shape[0]
    return dict(lanes=b, dtype=str(dtype), equal=equal, max_abs_err=err,
                ms=time_ms(fn), device_ms=kernel_device_ms(fn, "afterstate_kernel"),
                host_us=host_us(fn),
                plain_ms=time_ms(lambda: A.afterstate_buffer_plain(bd, pc, dtype)),
                nbytes=k4_bytes(b, dtype.itemsize), ops=k4_ops(b))


# The numbers a kernel's row takes from its main case.
CASE_KEYS = ("equal", "max_abs_err", "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
             "bound_by", "launches_a_call")


def launches_a_call(fn, counter) -> int:
    """Kernel launches one call of `fn` adds to the wrapper's counter."""
    before = counter.launches
    fn()
    return counter.launches - before


def k1_case(bits, ids) -> dict:
    """K1 and its plain version on one input: bit for bit, times, launches
    a call, bound."""
    import torch

    from bbx_torch.engine import solvability as S

    k = bits.shape[0]
    got, want = S.valid3_bits(bits, ids), S.valid3_bits_plain(bits, ids)

    def fn():
        return S.valid3_bits(bits, ids)

    return with_bound(dict(
        lanes=k, equal=bool(torch.equal(got, want)), max_abs_err=max_abs_err(got, want),
        ms=time_ms(fn), device_ms=kernel_device_ms(fn, "valid3_kernel"), host_us=host_us(fn),
        plain_ms=time_ms(lambda: S.valid3_bits_plain(bits, ids)),
        launches_a_call=launches_a_call(fn, S.valid3_bits),
        nbytes=k1_bytes(k, int(ids.unique().numel())), ops=k1_ops(k)))


def k2_case(bits, ids, v3) -> dict:
    """K2 and its plain version on one input (its `want` kept for K3):
    bit for bit, times, launches a call, bound (valid3 and ids read, the
    NO_CONFLICT rows of the input's piece pairs once (all of the 700 KB
    table at 4,096 lanes), one bool out; an OR step -- OR, lowest bit,
    clear lowest -- per (valid a0, a1) pair)."""
    import torch

    from bbx_torch.engine import solvability as S
    from bbx_torch.engine.tables import tables

    k = bits.shape[0]
    got = S.solvable_disjoint_bits(bits, ids, v3)
    want = S.solvable_disjoint_bits_plain(bits, ids, v3)
    pid = ids.long()
    m01 = S.unpack_cells(tables(bits.device).NO_CONFLICT_BITS[pid[:, 0], pid[:, 1]]
                         & S.pack_cells(v3[:, 1])[:, None, :])
    or_steps = int((m01 & v3[:, 0, :, None]).sum().item())
    pairs = torch.cat([pid[:, i] * 37 + pid[:, j] for i, j in ((0, 1), (0, 2), (1, 2))])

    def fn():
        return S.solvable_disjoint_bits(bits, ids, v3)

    return with_bound(dict(
        lanes=k, want=want, equal=bool(torch.equal(got, want)),
        max_abs_err=max_abs_err(got, want), ms=time_ms(fn),
        device_ms=kernel_device_ms(fn, "disjoint_kernel"), host_us=host_us(fn),
        plain_ms=time_ms(lambda: S.solvable_disjoint_bits_plain(bits, ids, v3)),
        launches_a_call=launches_a_call(fn, S.solvable_disjoint_bits),
        nbytes=k * 192 + k * 12 + int(pairs.unique().numel()) * 64 * 8 + k,
        ops=or_steps * 8 + k * 64 * 16))


def k3_case(bits, ids, v3) -> dict:
    """K3 and its plain version on one input: bit for bit, times, launches
    a call, bound (bits, ids and valid3 read, one bool out, the PLACE rows,
    shifts and anchor masks of the input's pieces once; the search's
    operations as `exact_ops` counts them, whatever the kernel skips)."""
    import torch

    from bbx_torch.engine import solvability as S

    k = bits.shape[0]
    got = S.solvable_exact_bits(bits, ids, v3)
    want = S.solvable_exact_bits_plain(bits, ids, v3)

    def fn():
        return S.solvable_exact_bits(bits, ids, v3)

    return with_bound(dict(
        lanes=k, equal=bool(torch.equal(got, want)), max_abs_err=max_abs_err(got, want),
        ms=time_ms(fn), device_ms=kernel_device_ms(fn, "exact_kernel"), host_us=host_us(fn),
        plain_ms=time_ms(lambda: S.solvable_exact_bits_plain(bits, ids, v3), reps=5, inner=2),
        launches_a_call=launches_a_call(fn, S.solvable_exact_bits),
        nbytes=k * (16 + 12 + 192 + 1) + int(ids.unique().numel()) * (64 * 8 + 9 * 4 + 8),
        ops=exact_ops(bits, ids, v3, want)))


def k1_bytes(k: int, pieces: int) -> int:
    """K1: bits and ids read, [k,3,64] bool written, the tables' rows of
    the `pieces` distinct pieces drawn once."""
    return k * 16 + k * 12 + k * 192 + pieces * (9 * 4 + 8)


def k1_ops(k: int) -> int:
    """K1: about 40 32-bit operations per (lane, slot)."""
    return 3 * k * 40


def k6_move_bytes(n: int) -> int:
    """`bbx_move`: board, ids, used, done, streak, action read (88 B); board,
    ten int32, three bools, used, centre, bits written (130 B); the tables
    once."""
    return n * (88 + 130) + 37 * 64 * 8 + 37 * 8 + 37 * 4


def k6_move_ops(n: int) -> int:
    """`bbx_move`: about 100 64-bit operations a lane."""
    return n * 200


def k6_finish_bytes(n: int) -> int:
    """`bbx_step_finish`: ten state fields (37 B), thirteen of bbx_move's
    outputs (54 B), regen's ids and the fresh draw (24 B) read; the
    observation (1,024 B of f32 planes, a 192 B mask), the board (64 B),
    ids (12 B), used (3 B), five f32 rows (20 B), sixteen int32 rows (64 B)
    and three bool rows (3 B) written (1,382 B); the tables once."""
    return n * (115 + 1382) + 37 * 64 * 8 + 37 * 9 * 4 + 37 * 8


def k6_finish_ops(n: int) -> int:
    """`bbx_step_finish`: three 9-shift fits and the game-over test (about
    60 64-bit operations), the reward and counters (about 40), the
    observation's bit spreading (about 100): about 400 32-bit operations."""
    return n * 400


STATE_FIELDS = ("board", "piece_ids", "used", "score", "streak", "moves",
                "lines_total", "max_streak", "blocks_total", "done", "prev_holes",
                "prev_center", "ep_return", "ep_len")


def flat_tensors(x) -> list:
    """The tensors of a step's outputs, in a fixed order: tuples, dicts (by
    key) and EnvState fields (its generator left out)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in flat_tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in flat_tensors(v)]
    if hasattr(x, "rng"):
        return [t for f in STATE_FIELDS for t in flat_tensors(getattr(x, f))]
    return []


def compare(got, want):
    """(every tensor equal in dtype, shape and value; the largest absolute
    difference) of two structures of tensors."""
    import torch

    a, b = flat_tensors(got), flat_tensors(want)
    equal = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))
    err = max((max_abs_err(x, y) for x, y in zip(a, b) if x.shape == y.shape),
              default=0.0)
    return equal, err


def k6_case(state, actions, rng_state, auto_reset: bool = True) -> dict:
    """K6's two entry points and the whole step on one engine-path input,
    each against its plain version on the card, from the generator state
    `rng_state` (regen's seed, then the fresh draw, as `step` draws them):
    `bbx_move` against `_move_core_plain`, `bbx_step_finish` against
    `_step_finish_plain` on K6's and K7's outputs, and the step (K6, K7,
    K6) against `_step_plain` and against its parts.  Each entry point is
    called as the step calls it (`_launch_move` and `_step_finish_cuda` on
    the state checked once, `bbx_move`'s blocks handed on by pointer): its
    time (CUDA events around calls), device time (profiler), host time a
    call, plain time and bound's bytes and operations; the step's time,
    host time, plain time, and device time and launches a step.  With
    `auto_reset` False (the search's simulated step) no fresh triple is
    drawn."""
    import torch

    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST
    from bbx_torch.engine.tables import tables
    from bbx_torch.ops import build

    device, n, rc, gen = state.device, state.num_envs, ST.RewardConfig(), state.rng
    checked = ST._require_state(state, actions)
    stream, tb = build.stream_of(state.board), tables(device)
    gen.set_state(rng_state)
    blocks = ST._launch_move(state, checked, stream, tb)
    moved = blocks.moved()
    seed = ES.regen_seed(gen, device)
    ids, _ = ES.regen_pieces(moved.bits, state.piece_ids, seed, moved.need)
    fresh = ES.fresh_pieces(n, gen, device) if auto_reset else None
    ar = auto_reset
    fin_bytes = k6_finish_bytes(n) - (0 if ar else 12 * n)  # no fresh triple
    finished = ST._step_finish_cuda(state, blocks, ids, fresh, rc, ar, stream, tb)
    gen.set_state(rng_state)
    whole = ST.step(state, actions, rc, ar)
    gen.set_state(rng_state)
    whole_plain = ST._step_plain(state, actions, rc, ar)
    checks = {"bbx_move": compare(moved, ST._move_core_plain(state, actions)),
              "bbx_step_finish": compare(finished, ST._step_finish_plain(
                  state, moved, ids, fresh, rc, ar)),
              "step": compare(whole, whole_plain),
              "step_is_its_parts": compare(tuple(whole)[:5], finished)}

    def entry(fn, plain, kernel, nbytes, ops):
        return with_bound(dict(ms=time_ms(fn), device_ms=kernel_device_ms(fn, kernel),
                               host_us=host_us(fn), plain_ms=time_ms(plain),
                               nbytes=nbytes, ops=ops))

    entry_points = {
        "bbx_move": entry(lambda: ST._launch_move(state, checked, stream, tb),
                          lambda: ST._move_core_plain(state, actions), "move_kernel",
                          k6_move_bytes(n), k6_move_ops(n)),
        "bbx_step_finish": entry(
            lambda: ST._step_finish_cuda(state, blocks, ids, fresh, rc, ar, stream, tb),
            lambda: ST._step_finish_plain(state, moved, ids, fresh, rc, ar),
            "step_finish_kernel", fin_bytes, k6_finish_ops(n))}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reps = 20
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            ST.step(state, actions, rc, ar)
        torch.cuda.synchronize()
    by_name = device_ms_by_kernel(prof)
    whole_step = {
        "ms": time_ms(lambda: ST.step(state, actions, rc, ar)),
        "host_us": host_us(lambda: ST.step(state, actions, rc, ar)),
        "plain_ms": time_ms(lambda: ST._step_plain(state, actions, rc, ar), reps=3, inner=1),
        "device_ms": sum(t for t, _ in by_name.values()) / reps if by_name else "not measured",
        "launches": sum(c for _, c in by_name.values()) / reps if by_name else "not measured",
        "kernels": {k[:90]: c / reps for k, (_, c) in by_name.items()}}
    gen.set_state(rng_state)
    ep = entry_points.values()
    dev_ms = [e["device_ms"] for e in ep]
    return dict(
        lanes=n, checks={k: v[0] for k, v in checks.items()},
        equal=all(v[0] for v in checks.values()),
        max_abs_err=max(v[1] for v in checks.values()),
        ms=sum(e["ms"] for e in ep), plain_ms=sum(e["plain_ms"] for e in ep),
        device_ms=sum(dev_ms) if all(isinstance(d, float) for d in dev_ms) else "not measured",
        host_us=sum(e["host_us"] for e in ep),
        nbytes=k6_move_bytes(n) + fin_bytes,
        ops=k6_move_ops(n) + k6_finish_ops(n),
        entry_points=entry_points, step=whole_step)


def engine_step_inputs(device) -> dict:
    """The kernels' inputs in one step of the engine path's fleet.

    ENGINE_LANES lanes of `VectorEnv` run one chunk of random valid moves
    (`sample_valid_actions_device`, as the benchmark's warm-up does); for
    the next step, the state and actions (K6's inputs) and regen's new
    board bits, ids, seed and need (K7's) are computed as `step` computes
    them, from a copy of the generator's state, and then the step itself
    runs from that state, so that its `regen_attempts` can confirm them."""
    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST
    from bbx_torch.env import VectorEnv, sample_valid_actions_device

    env = VectorEnv(ENGINE_LANES, seed=SEED, device=device)
    env.reset()
    act_rng = ES.make_generator(SEED + 1, device)
    mask = ST.observe(env.state)["action_mask"]
    for _ in range(ENGINE_CHUNK):
        mask = env.step_device(sample_valid_actions_device(act_rng, mask)).obs["action_mask"]
    state, actions = env.state, sample_valid_actions_device(act_rng, mask)
    rng_state = state.rng.get_state()
    moved = ST._move_core(state, actions)
    out = dict(state=state, mask=mask, actions=actions, bits=moved.bits,
               ids=state.piece_ids, seed=ES.regen_seed(state.rng, device),
               need=moved.need)
    state.rng.set_state(rng_state)
    out["rng_state"] = rng_state
    out["step_attempts"] = env.step_device(actions).regen_attempts
    if not out["need"].any():
        raise AssertionError("no lane of the captured engine step needs new pieces")
    return out


def k7_case(bits, ids, seed, need) -> dict:
    """K7 and its plain version on one input: equality in ids and attempts,
    the draws, both times and the bound's bytes and operations."""
    import torch

    from bbx_torch.engine import state as ES

    got = ES.regen_pieces(bits, ids, seed, need)
    want = ES.regen_pieces_plain(bits, ids, seed, need)
    att = want[1][need].to(torch.float64)
    n = bits.shape[0]
    return dict(
        lanes=n, attempts=got[1],
        equal=all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want)),
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
        needy=int(need.sum()), attempts_mean=float(att.mean()),
        attempts_max=int(att.max()),
        ms=time_ms(lambda: ES.regen_pieces(bits, ids, seed, need)),
        device_ms=kernel_device_ms(lambda: ES.regen_pieces(bits, ids, seed, need),
                            "regen_kernel"),
        host_us=host_us(lambda: ES.regen_pieces(bits, ids, seed, need)),
        plain_ms=time_ms(lambda: ES.regen_pieces_plain(bits, ids, seed, need),
                         reps=3, inner=1),
        # bits, ids, need read, ids and attempts written, the seed, the
        # tables once (the 700 KB conflict table among them).
        nbytes=n * (16 + 12 + 1 + 12 + 4) + 8 + 37 * 64 * 8 + 37 * 9 * 4
        + 37 * 8 + 37 * 37 * 64 * 8,
        ops=regen_ops(bits, seed, need, want[1]))


def exact_ops(bits, ids, valid3, solvable) -> int:
    """32-bit operations the exact search needs on these lanes: a clear and
    a fit (about 80 ops) for every valid (order, a1), then for every valid
    (order, a1, a2) candidate of an unsolvable lane, and one candidate for
    each solvable lane (an exhaustive search may stop at its first hit)."""
    import torch

    from bbx_torch.engine import solvability as S
    from bbx_torch.engine.tables import tables

    tb = tables(bits.device)
    pid = ids.long()
    pb = tb.PLACE_BITS[pid]
    first, cands = 0, None
    for i in range(3):
        s0, s1 = S._clear_lines_words(bits[:, None, 0] | pb[:, i, :, 0],
                                      bits[:, None, 1] | pb[:, i, :, 1])
        for j in range(3):
            if j == i:
                continue
            f0, f1 = S.piece_fit_words(s0, s1, pid[:, j])
            n2 = (S.unpack_cells(torch.stack([f0, f1], -1))
                  & valid3[:, i, :, None]).sum(dim=(1, 2))
            cands = n2 if cands is None else cands + n2
            first += int(valid3[:, i].sum().item())
    need = int(cands[~solvable].sum().item()) + int(solvable.sum().item())
    return 80 * (first + need)


def regen_ops(bits, seed, need, attempts, lane_base: int = 0) -> int:
    """32-bit operations K7 needs for these lanes, replaying every draw a
    lane made: per draw the hash (about 40) and three fits (about 40 each),
    then the disjoint tier as in K2's count, then, for the draws it rejects,
    the exact tier as `exact_ops` counts it.  Lane i hashes as lane_base +
    i."""
    import torch

    from bbx_torch.engine import solvability as S
    from bbx_torch.engine import state as ES
    from bbx_torch.engine.tables import tables

    tb = tables(bits.device)
    ops = 0
    for j in range(int(attempts.max())):
        lanes = (need & (attempts > j)).nonzero().squeeze(1)
        if lanes.numel() == 0:
            break
        b = bits[lanes]
        ids = ES.regen_draw(seed, lanes + lane_base, j)
        v3 = S.valid3_bits_plain(b, ids)
        pid = ids.long()
        m01 = S.unpack_cells(tb.NO_CONFLICT_BITS[pid[:, 0], pid[:, 1]]
                             & S.pack_cells(v3[:, 1])[:, None, :])
        ops += lanes.numel() * (40 + 3 * 40 + 64 * 16)
        ops += int((m01 & v3[:, 0, :, None]).sum().item()) * 8
        rest = (~S.solvable_disjoint_bits_plain(b, ids, v3)).nonzero().squeeze(1)
        if rest.numel():
            solved = S.solvable_exact_bits_plain(b[rest], ids[rest], v3[rest])
            ops += exact_ops(b[rest], ids[rest], v3[rest], solved)
    return ops


def eval_phase(device, report):
    """Phase 5: the main path through the eval entry point."""
    import torch

    from bbx_torch.cli import evaluate
    from bbx_torch.models import network_from_config
    from bbx_torch.utils.checkpoints import save_checkpoint

    counters = kernel_counters()
    net = network_from_config(RUN9_NETWORK,
                              generator=torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, "run9_seeded.pt", {"params": net.state_dict()},
                               config={"network": RUN9_NETWORK})
        out_json = os.path.join(tmp, "eval.json")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = evaluate.main(["--checkpoint", ckpt, "--episodes", str(EVAL_EPISODES),
                            "--deterministic", "--seed", str(SEED),
                            "--output", out_json])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        with open(out_json) as f:
            results = json.load(f)
    log(f"  results: {json.dumps(results)}")
    moves = results["length_mean"] * results["completed"]
    report["eval"] = {"results": results, "seconds": seconds,
                      "env_steps": moves, "env_steps_per_s": moves / seconds,
                      "episodes_per_s": results["completed"] / seconds,
                      "launches": launches}
    log(f"  eval: rc {rc}, {results['completed']}/{EVAL_EPISODES} episodes, "
        f"{seconds:.3f} s, {moves:.0f} env-steps, "
        f"{moves / seconds:.1f} env-steps/s; launches {launches}")
    if rc != 0:
        raise AssertionError(f"evaluate.main returned {rc}")
    if results["completed"] != EVAL_EPISODES:
        raise AssertionError(f"only {results['completed']} episodes completed")
    nums = [v for v in results.values() if isinstance(v, float)]
    nums += list(results["percentiles"].values())
    if not all(math.isfinite(v) for v in nums) or results["score_min"] < 0:
        raise AssertionError(f"bad statistics: {results}")
    check_launches("eval", launches)


def kernel_counters():
    """Each kernel's wrapper (whose ``launches`` counts its launches), by
    the name the kernels line gives it."""
    from bbx_torch.agent import ppo as P
    from bbx_torch.engine import solvability as S
    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST
    from bbx_torch.env import vector as V
    from bbx_torch.models import afterstate as A

    return {"evaluator_scores": A.evaluator_scores,
            "_evaluator_grad_tiles": A._evaluator_grad_tiles,
            "_evaluator_grad_dense0": A._evaluator_grad_dense0,
            "_evaluator_grad_reduce": A._evaluator_grad_reduce,
            "sample_valid_actions_device": V.sample_valid_actions_device,
            "valid3_bits": S.valid3_bits,
            "solvable_disjoint_bits": S.solvable_disjoint_bits,
            "solvable_exact_bits": S.solvable_exact_bits,
            "afterstate_buffer": A.afterstate_buffer,
            "compute_gae": P.compute_gae,
            "_move_core": ST._move_core,
            "_step_finish_cuda": ST._step_finish_cuda,
            "regen_pieces": ES.regen_pieces}


def check_launches(path: str, launches: dict) -> None:
    """Fail unless every kernel of `path` was launched in its run."""
    missing = [n for n in PATH_KERNELS[path] if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def reference_phase(device, report):
    """Phase 6: the card against the CPU on small inputs."""
    import numpy as np
    import torch

    from bbx_torch.device import float32_exact
    from bbx_torch.engine.parity import ParityEngine
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe
    from bbx_torch.models import network_from_config

    # float32 forward at run9 widths, card (K8's float32 instantiation) vs
    # CPU (the plain evaluator), with TF32 off.
    from bbx_torch.models import afterstate as A

    cfg = dict(RUN9_NETWORK, compute_dtype="float32")
    net = network_from_config(cfg, generator=torch.Generator().manual_seed(SEED))
    state = reset(8, make_generator(SEED, "cpu"), "cpu")
    obs = observe(state)
    with float32_exact(), torch.inference_mode():
        l_cpu, v_cpu = net(obs["board"], obs["pieces"], obs["action_mask"])
        net_gpu = net.to(device)
        before = A.evaluator_scores.launches
        l_gpu, v_gpu = net_gpu(*(obs[k].to(device) for k in
                                 ("board", "pieces", "action_mask")))
        k8_launched = A.evaluator_scores.launches - before
    l_gpu, v_gpu = l_gpu.cpu(), v_gpu.cpu()
    mask = obs["action_mask"]
    fwd_err = max(max_abs_err(l_gpu[mask], l_cpu[mask]), max_abs_err(v_gpu, v_cpu))
    fwd_ok = (fwd_err <= 1e-4 and torch.equal(l_gpu[~mask], l_cpu[~mask])
              and torch.isfinite(l_gpu).all().item() and k8_launched == 1)

    # Three seeded games, card vs CPU, move for move (exact), with the
    # launches of the parity engine's kernels counted.
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    moves_rng = np.random.default_rng(SEED)
    game_ok, n_moves = True, 0
    for seed in (SEED, SEED + 1, SEED + 2):
        eng = {d: ParityEngine(seed=seed, device=d) for d in ("cpu", device)}
        while game_ok and not eng["cpu"].game_over:
            vm = eng["cpu"].get_valid_moves()
            if vm != eng[device].get_valid_moves():
                game_ok = False
                break
            mv = vm[moves_rng.integers(len(vm))]
            for e in eng.values():
                e.make_move(*mv)
            a, b = eng["cpu"], eng[device]
            game_ok = (np.array_equal(a.board, b.board)
                       and np.array_equal(a.piece_ids, b.piece_ids)
                       and a.score == b.score and a.game_over == b.game_over)
            n_moves += 1
    launches = {name: fn.launches for name, fn in counters.items()}
    report["reference"] = {"forward_f32_max_abs_err": fwd_err,
                           "forward_f32_k8_launches": k8_launched,
                           "forward_ok": fwd_ok, "game_moves": n_moves,
                           "game_ok": game_ok}
    report["parity"] = {"launches": launches}
    log(f"  forward f32 card (K8 launches: {k8_launched}) vs cpu: max abs err "
        f"{fwd_err:.3e} (limit 1e-4), ok={fwd_ok}; 3 seeded games card vs cpu: "
        f"{n_moves} moves, equal={game_ok}")
    if not (fwd_ok and game_ok):
        raise AssertionError("card disagrees with the CPU reference")
    check_launches("parity", launches)


def device_ms_by_kernel(prof):
    """{kernel name: (device ms, calls)} of a `torch.profiler` run (the
    schedule's step markers, which span the device's timeline, left out)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def profile_phase(device, report):
    """Phase 7: where the time of an eval step goes.  The first 16 steps of
    the eval loop (512 lanes from reset, greedy, run9 widths) run twice:
    once with a host clock around the forward and the step separately (a
    synchronise after each), once under `torch.profiler` for the device
    time by kernel.  A profiler that records no device time is reported as
    "not measured", not as a failure."""
    import torch

    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe, step
    from bbx_torch.models import distributions as D
    from bbx_torch.models import network_from_config

    steps = 16
    net = network_from_config(RUN9_NETWORK,
                              generator=torch.Generator().manual_seed(SEED))
    net = net.to(device).eval()

    def run(timed):
        state = reset(EVAL_EPISODES, make_generator(SEED, device), device)
        obs = observe(state)
        fwd = stp = 0.0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, _ = net(obs["board"], obs["pieces"], obs["action_mask"])
            action = D.mode(logits)
            if timed:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(state, action, auto_reset=False)
            state, obs = out.state, out.obs
            if timed:
                torch.cuda.synchronize()
            fwd += t1 - t0
            stp += time.perf_counter() - t1
        torch.cuda.synchronize()
        return time.perf_counter() - t_start, fwd, stp

    with torch.inference_mode():
        run(False)  # warm-up: cuDNN plans, allocator
        _, fwd, stp = run(True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall, _, _ = run(False)
    by_name = device_ms_by_kernel(prof)
    device_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    prof_out = {
        "steps": steps, "lanes": EVAL_EPISODES,
        "host_ms_per_step_forward": fwd / steps * 1e3,
        "host_ms_per_step_step": stp / steps * 1e3,
        "profiled_wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": device_ms / steps if device_ms else "not measured",
        "device_busy_share": device_ms / (wall * 1e3) if device_ms else "not measured",
        "top_device_kernels": [{"name": k[:90], "ms_per_step": t / steps,
                                "calls_per_step": n / steps} for k, (t, n) in top],
    }
    # A session may record no kernel (a process's first), or lose some of
    # its records, which leaves a count a call that is not a whole number:
    # such a session is taken again, twice at most.
    for attempt in range(1, 4):
        prof_out["forward"] = fwd_k = forward_kernels(device)
        prof_out["forward_attempts"] = attempt
        if fwd_k["kernels"] and all(float(n).is_integer()
                                    for _, n in fwd_k["kernels"].values()):
            break
    # One forward runs K8 (and its weight layout) once, and no convolution
    # but the value head's two.
    names = fwd_k["kernels"]
    checks = {
        "k8_launches": sum(v[1] for k, v in names.items() if "evaluator_kernel" in k),
        "k8_layout_launches": sum(v[1] for k, v in names.items()
                                  if "evaluator_layout_kernel" in k),
        "convolution_launches": sum(v[1] for k, v in names.items()
                                    if any(w in k.lower() for w in CONV_KERNEL_WORDS)),
    }
    checks["ok"] = (checks["k8_launches"] == 1 and checks["k8_layout_launches"] == 1
                    and checks["convolution_launches"] <= len(RUN9_NETWORK["value_channels"]))
    prof_out["forward_checks"] = checks
    report["profile"] = prof_out
    log(f"  one forward at {EVAL_EPISODES} lanes: {fwd_k['launches']} kernel launches, "
        f"device {fwd_k['device_ms']} ms; checks {checks}; kernels (device ms, launches): "
        + "; ".join(f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in fwd_k["kernels"].items()))
    log(f"  per step (host clock, synchronised): forward {prof_out['host_ms_per_step_forward']:.3f} ms, "
        f"step {prof_out['host_ms_per_step_step']:.3f} ms; profiled: wall "
        f"{prof_out['profiled_wall_ms_per_step']:.3f} ms, device {prof_out['device_ms_per_step']}"
        f" ms, busy share {prof_out['device_busy_share']}")
    for row in prof_out["top_device_kernels"]:
        log(f"    {row['ms_per_step']:.4f} ms/step  x{row['calls_per_step']:.2f}  {row['name']}")
    if not checks["ok"]:
        raise AssertionError(f"one forward's kernels: {checks} (want K8 and its layout "
                             f"once, and only the value head's convolutions)")


def train_phase(device, report):
    """Phase 8: the train path through the train entry point, at run9's
    width and shape, with each iteration's rollout and update timed (a
    synchronise on each side) and the update's peak device memory read."""
    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent.trainer import PPOTrainer
    from bbx_torch.cli import train as cli_train
    from bbx_torch.utils.config import load_config

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = {"ppo": RUN9_PPO, "training": RUN9_TRAINING,
           "network": RUN9_NETWORK, "rewards": RUN9_REWARDS,
           "logging": {"log_interval": 1, "save_interval": 3,
                       "eval_interval": 0, "eval_episodes": 64},
           "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                     "log_dir": os.path.join(work, "logs")}}
    cfg_path = os.path.join(work, "run9.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)

    from bbx_torch.models import distributions as D

    counters = kernel_counters()
    k4, k8 = counters["afterstate_buffer"], counters["evaluator_scores"]
    k8b = counters["_evaluator_grad_tiles"]
    iters, stats = [], {}
    rollout0, update0, train0, loss0 = P.rollout, P.update, cli_train.train, P.ppo_loss
    first_minibatch = {}

    def timed_rollout(*args, **kwargs):
        before = k4.launches, k8.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout0(*args, **kwargs)
        torch.cuda.synchronize()
        iters.append({"rollout_s": time.perf_counter() - t0,
                      "afterstate_launches_rollout": k4.launches - before[0],
                      "evaluator_launches_rollout": k8.launches - before[1]})
        return out

    def timed_update(*args, **kwargs):
        before = k4.launches, k8.launches, k8b.launches
        first_minibatch.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = update0(*args, **kwargs)
        torch.cuda.synchronize()
        iters[-1].update(update_s=time.perf_counter() - t0,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                         afterstate_launches_update=k4.launches - before[0],
                         evaluator_launches_update=k8.launches - before[1],
                         evaluator_grad_launches_update=k8b.launches - before[2],
                         first_minibatch={k: float(v) for k, v in first_minibatch.items()},
                         metrics={k: float(v) for k, v in metrics.items()})
        return metrics

    def watched_loss(config, logits, value, batch, *coefs):
        # The update's first minibatch, before any optimizer step: its
        # forward (K8 under `EvaluatorFunction`, with gradients) against the
        # logp the rollout stored (K8, no gradient).
        out = loss0(config, logits, value, batch, *coefs)
        if not first_minibatch:
            with torch.no_grad():
                gap = (D.log_prob(logits, batch["action"]) - batch["logp"]).abs().max()
            first_minibatch.update(max_abs_logp_gap=gap,
                                   clip_fraction=out[1]["clip_fraction"].detach())
        return out

    def captured_train(*args, **kwargs):
        out = train0(*args, **kwargs)
        stats.update({k: v for k, v in out.items() if k != "trainer"})
        return out

    P.rollout, P.update, cli_train.train = timed_rollout, timed_update, captured_train
    P.ppo_loss = watched_loss
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_train.main(["--config", cfg_path, "--total-timesteps",
                             str(TRAIN_TIMESTEPS), "--seed", str(TRAIN_SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        P.rollout, P.update, cli_train.train = rollout0, update0, train0
        P.ppo_loss = loss0

    for i, r in enumerate(iters):
        log(f"  iteration {i + 1}: rollout {r['rollout_s']:.3f} s, update "
            f"{r['update_s']:.3f} s, update peak memory {r['peak_memory_gb']:.3f} GB, "
            f"K4 launches {r['afterstate_launches_rollout']} (rollout) + "
            f"{r['afterstate_launches_update']} (update), K8 launches "
            f"{r['evaluator_launches_rollout']} (rollout) + "
            f"{r['evaluator_launches_update']} (update), K8b launches "
            f"{r['evaluator_grad_launches_update']} (update); first minibatch, before any "
            f"optimizer step: {r['first_minibatch']}; "
            + ", ".join(f"{k} {v:.6g}" for k, v in r["metrics"].items()))
    steps_per_s = stats.get("steps_per_sec", 0.0)
    log(f"  train: rc {rc}, {stats.get('global_step')} env-steps in "
        f"{stats.get('elapsed_sec', 0.0):.3f} s of the loop ({wall:.3f} s with "
        f"set-up) = {steps_per_s:.1f} train env-steps/s; launches {launches}")

    # Resume: load `latest` and run one more iteration.
    trainer = PPOTrainer(load_config(cfg_path), seed=TRAIN_SEED,
                         total_timesteps=TRAIN_TIMESTEPS, device=device)
    trainer.load(os.path.join(cfg["paths"]["checkpoint_dir"], "latest"))
    resumed_from = trainer.global_step
    resumed = {k: float(v) for k, v in trainer.iterate().items()}
    log(f"  resumed at {resumed_from} env-steps, one more iteration: "
        + ", ".join(f"{k} {v:.6g}" for k, v in resumed.items()))

    report["train"] = {"iterations": iters, "launches": launches,
                       "wall_seconds": wall, "stats": stats,
                       "train_env_steps_per_s": steps_per_s,
                       "resumed_from": resumed_from, "resumed_metrics": resumed}
    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    if len(iters) != 3 or stats.get("global_step") != TRAIN_TIMESTEPS:
        raise AssertionError(f"{len(iters)} iterations, {stats.get('global_step')} steps")
    values = [v for r in iters for v in r["metrics"].values()] + list(resumed.values())
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("a training metric is not finite")
    check_launches("train", launches)
    if launches["compute_gae"] != 3 or not all(
            r["afterstate_launches_rollout"] > 0 and r["afterstate_launches_update"] > 0
            for r in iters):
        raise AssertionError("GAE or the afterstate kernel missed an iteration")
    # K8 scores every rollout step and the last value, and every update
    # minibatch's forward; K8's backward (K8b, K8w, the reduction) runs once
    # in every update minibatch.
    minibatches = RUN9_PPO["num_epochs"] * (RUN9_TRAINING["num_envs"]
                                            * RUN9_TRAINING["rollout_steps"]
                                            // RUN9_TRAINING["batch_size"])
    if not all(r["evaluator_launches_rollout"] == RUN9_TRAINING["rollout_steps"] + 1
               and r["evaluator_launches_update"] == minibatches
               and r["evaluator_grad_launches_update"] == minibatches for r in iters):
        raise AssertionError(f"K8 missed a rollout forward, or K8 or K8b an update "
                             f"minibatch ({minibatches} an update)")
    if not (launches["_evaluator_grad_tiles"] == launches["_evaluator_grad_dense0"]
            == launches["_evaluator_grad_reduce"]):
        raise AssertionError(f"K8b, K8w and the reduction launched apart: {launches}")
    if not all(math.isfinite(v) for r in iters for v in r["first_minibatch"].values()):
        raise AssertionError("the first minibatch's logp gap is not finite")
    if resumed_from != TRAIN_TIMESTEPS:
        raise AssertionError(f"latest holds step {resumed_from}")
    train_determinism(device, report, work)
    train_bf16_mu(device, report)


# Phase 8's determinism check: each configuration trained twice from one
# seed for DETERMINISM_ITERATIONS iterations, and saved after the first
# and resumed into a fresh trainer for the second; the end states compared
# bit for bit.  run9 at full width (K8 and K8's backward, the value head in
# cuDNN) must agree; config/default.yaml's flat CNN in float32 is reported.
DETERMINISM_ITERATIONS = 2
DETERMINISM_SEED = 21


def trainer_tensors(trainer) -> dict:
    """Every tensor a checkpoint carries, as CPU copies, in a fixed order:
    the parameters and buffers, Adam's state, the fleet, each generator."""
    import dataclasses

    from bbx_torch.engine.state import EnvState

    out = {f"params.{k}": v.detach().cpu().clone()
           for k, v in trainer.network.state_dict().items()}
    opt = trainer.train_state.optimizer.state_dict()["state"]
    for i in sorted(opt):
        for k, v in opt[i].items():
            out[f"adam.{i}.{k}"] = v.detach().cpu().clone()
    for f in dataclasses.fields(EnvState):
        if f.name != "rng":
            out[f"fleet.{f.name}"] = getattr(trainer.env_state, f.name).cpu().clone()
    for k, g in trainer.rngs.items():
        out[f"rng.{k}"] = g.get_state().clone()
    return out


def tensor_gaps(a: dict, b: dict) -> dict:
    """Each tensor of `a` that differs from `b`'s: the share of its
    elements that differ and, for floats, the largest |difference|."""
    import torch

    gaps = {}
    for k, x in a.items():
        y = b[k]
        if torch.equal(x, y):
            continue
        gaps[k] = {"share": float((x != y).float().mean()),
                   "max_abs": (float((x.double() - y.double()).abs().max())
                               if x.is_floating_point() else None)}
    return gaps


def metric_gaps(a: dict, b: dict) -> dict:
    return {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def determinism_case(device, cfg: dict, work: str) -> dict:
    """Two runs of `cfg` from DETERMINISM_SEED, DETERMINISM_ITERATIONS
    iterations each, and a third saved after its first iteration and
    resumed into a fresh trainer (another seed: the load must win) for the
    rest: the tensors that differ, first run against second and resumed
    against the first, and the metrics of each iteration after the save."""
    from bbx_torch.agent.trainer import PPOTrainer

    def floats(m):
        return {k: float(v) for k, v in m.items()}

    runs = []
    for _ in range(2):
        t = PPOTrainer(cfg, seed=DETERMINISM_SEED, device=device)
        metrics = [floats(t.iterate()) for _ in range(DETERMINISM_ITERATIONS)]
        runs.append((trainer_tensors(t), metrics))
        del t
    t = PPOTrainer(cfg, seed=DETERMINISM_SEED, device=device)
    t.iterate()
    path = t.save(work, "after_1")
    del t
    resumed = PPOTrainer(cfg, seed=DETERMINISM_SEED + 1, device=device)
    resumed.load(path)
    tail = [floats(resumed.iterate()) for _ in range(DETERMINISM_ITERATIONS - 1)]
    (first, m_first), (second, m_second) = runs
    again = tensor_gaps(first, second)
    resume = tensor_gaps(first, trainer_tensors(resumed))
    return {"tensors": len(first),
            "run_twice": {"tensors_apart": again,
                          "metrics_apart": [metric_gaps(a, b)
                                            for a, b in zip(m_first, m_second)]},
            "resumed": {"tensors_apart": resume,
                        "metrics_apart": [metric_gaps(a, b)
                                          for a, b in zip(m_first[1:], tail)]},
            "equal": not again and not resume and m_first == m_second
            and m_first[1:] == tail}


def first_nondeterministic_layer(device, cfg: dict) -> dict:
    """Where an update's backward stops being reproducible without cuDNN's
    deterministic algorithms: one minibatch step (the whole batch) of a
    fresh trainer of `cfg` after its first rollout, with each
    convolution's and dense layer's inputs and output gradient recorded
    (`F.conv2d` and `F.linear`, which the networks call); then each such
    op's backward alone, outside the update (input and weight gradients
    from the recorded tensors), twice, in the order the backward reached
    them.  The first op whose two gradients differ is named with the CUDA
    kernels `torch.profiler` shows for its backward, and the same backward
    is tried twice under ``torch.backends.cudnn.deterministic``."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent.trainer import PPOTrainer

    trainer = PPOTrainer(cfg, seed=DETERMINISM_SEED, device=device)
    ops, order = [], []
    recording = [False]

    def recorded(name, fn):
        def op(x, w, b=None, **kw):
            out = fn(x, w, b, **kw)
            if recording[0] and out.requires_grad:
                rec = {"op": name, "fn": fn, "x": x.detach(), "w": w.detach(),
                       "b": None if b is None else b.detach(), "kw": kw,
                       "index": len(ops)}
                ops.append(rec)

                def reached(g, rec=rec):
                    rec["grad_out"] = g.detach()
                    order.append(rec["index"])

                out.register_hook(reached)
            return out
        return op

    conv0, linear0, update0 = F.conv2d, F.linear, P.update

    def one_step(config, ts, *args, **kwargs):
        recording[0] = True
        one = dataclasses.replace(config, num_epochs=1, minibatch_size=config.batch_size)
        return update0(one, ts, *args, **kwargs)

    F.conv2d, F.linear = recorded("conv2d", conv0), recorded("linear", linear0)
    P.update = one_step
    try:
        trainer.iterate()
    finally:
        F.conv2d, F.linear, P.update = conv0, linear0, update0

    def backward(rec):
        x = rec["x"].clone().requires_grad_()
        w = rec["w"].clone().requires_grad_()
        out = rec["fn"](x, w, rec["b"], **rec["kw"])
        return torch.autograd.grad(out, (x, w), rec["grad_out"])

    found = {"ops_checked": len(order)}
    for i in order:
        rec = ops[i]
        a, b = backward(rec), backward(rec)
        if all(torch.equal(x, y) for x, y in zip(a, b)):
            continue
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            backward(rec)
            torch.cuda.synchronize()
        kernels = sorted({e.key for e in prof.key_averages()
                          if getattr(e, "device_time_total",
                                     getattr(e, "cuda_time_total", 0)) > 0})
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            c, d = backward(rec), backward(rec)
        finally:
            torch.backends.cudnn.deterministic = saved
        found.update(
            op=rec["op"], forward_index=i, backward_rank=order.index(i),
            input_shape=list(rec["x"].shape), weight_shape=list(rec["w"].shape),
            dtype=str(rec["x"].dtype),
            apart={"input_grad": not torch.equal(a[0], b[0]),
                   "weight_grad": not torch.equal(a[1], b[1])},
            max_abs=[float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)],
            kernels=kernels,
            deterministic_cudnn_equal=all(torch.equal(x, y) for x, y in zip(c, d)))
        break
    return found


def train_determinism(device, report, work: str) -> None:
    """Phase 8's determinism and exact-resume check (DETERMINISM_*): run9
    at full width and the flat CNN of config/default.yaml in float32, with
    cuDNN's and cuBLAS's default TF32 and without it (`float32_exact`, as
    phase 15's float32 comparisons run), must each agree bit for bit.  For
    the flat CNN without TF32, the one whose update needs cuDNN's
    deterministic algorithms (`bbx_torch.device.deterministic_cudnn`),
    also: the first convolution or dense layer whose backward does not
    repeat without them (`first_nondeterministic_layer`), and the update's
    seconds with them and without, in turns."""
    import torch

    from bbx_torch.device import float32_exact

    out = report.setdefault("train_determinism", {})
    run9 = {"ppo": RUN9_PPO, "network": RUN9_NETWORK, "rewards": RUN9_REWARDS,
            "training": dict(RUN9_TRAINING, total_timesteps=TRAIN_TIMESTEPS)}
    cnn = {"ppo": DEFAULT_PPO, "network": dict(DEFAULT_NETWORK, compute_dtype="float32"),
           "training": DEFAULT_TRAINING}
    for name, cfg, exact in (("run9", run9, False), ("flat_cnn_float32", cnn, False),
                             ("flat_cnn_float32_without_tf32", cnn, True)):
        t0 = time.perf_counter()
        with float32_exact() if exact else contextlib.nullcontext():
            case = determinism_case(device, cfg, os.path.join(work, name))
            if exact:
                case["without_deterministic_cudnn"] = first_nondeterministic_layer(
                    device, cfg)
        if exact:
            case["update_s"] = deterministic_update_cost(device, cfg, exact)
        case["seconds"] = time.perf_counter() - t0
        out[name] = case
        log(f"  determinism, {name}: {DETERMINISM_ITERATIONS} iterations twice from one "
            f"seed and saved/resumed after the first; every tensor of the end state "
            f"({case['tensors']}) and the metrics equal: {case['equal']}; run twice, "
            f"apart: {case['run_twice']}; resumed against uninterrupted, apart: "
            f"{case['resumed']} ({case['seconds']:.1f} s)")
        if exact:
            log(f"  {name}: the first layer whose backward does not repeat without "
                f"cuDNN's deterministic algorithms: {case['without_deterministic_cudnn']}; "
                f"one update's seconds with them and without, in turns: "
                f"{case['update_s']}")
        torch.cuda.empty_cache()
    apart = [name for name, case in out.items() if not case["equal"]]
    if apart:
        raise AssertionError(f"not bit-reproducible on the card (two runs from one seed, "
                             f"or a resumed run against the uninterrupted one): {apart}")


def deterministic_update_cost(device, cfg: dict, exact: bool) -> dict:
    """One iteration of `cfg` from one seed four times, in turns: the
    update as it runs (under `deterministic_cudnn`), then without it, then
    without, then with (`exact`: all without TF32): each update's seconds
    between synchronises."""
    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent.trainer import PPOTrainer
    from bbx_torch.device import float32_exact

    update0 = P.update
    times = {"deterministic": [], "default": []}
    for kind in ("deterministic", "default", "default", "deterministic"):
        trainer = PPOTrainer(cfg, seed=DETERMINISM_SEED, device=device)
        # Without: the update's body outside its `deterministic_cudnn`.
        fn = update0 if kind == "deterministic" else update0.__wrapped__

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            return out

        P.update = timed
        try:
            with float32_exact() if exact else contextlib.nullcontext():
                trainer.iterate()
        finally:
            P.update = update0
        del trainer
    return times


def train_bf16_mu(device, report) -> None:
    """One run9 iteration with ``adam_mu_dtype: bfloat16`` beside one with
    float32 mu, each from the same seed, in turns (float32, bf16, bf16,
    float32): the update's seconds and peak memory and the moments' bytes;
    mu bf16 and nu float32 after it; the losses finite."""
    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent.trainer import PPOTrainer

    res = {"float32": [], "bfloat16": []}
    update0 = P.update
    for mu in ("float32", "bfloat16", "bfloat16", "float32"):
        ppo = dict(RUN9_PPO, adam_mu_dtype=None if mu == "float32" else mu)
        cfg = {"ppo": ppo, "network": RUN9_NETWORK, "rewards": RUN9_REWARDS,
               "training": dict(RUN9_TRAINING, total_timesteps=TRAIN_TIMESTEPS)}
        trainer = PPOTrainer(cfg, seed=TRAIN_SEED, device=device)
        rec = {}

        def timed_update(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = update0(*args, **kwargs)
            torch.cuda.synchronize()
            rec.update(update_s=time.perf_counter() - t0,
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            return metrics

        P.update = timed_update
        try:
            metrics = {k: float(v) for k, v in trainer.iterate().items()}
        finally:
            P.update = update0
        states = list(trainer.train_state.optimizer.state.values())
        rec.update(mu_dtypes=sorted({str(s["exp_avg"].dtype) for s in states}),
                   nu_dtypes=sorted({str(s["exp_avg_sq"].dtype) for s in states}),
                   moments_mb=sum(t.numel() * t.element_size() for s in states
                                  for t in (s["exp_avg"], s["exp_avg_sq"])) / 1e6,
                   metrics=metrics)
        res[mu].append(rec)
        del trainer
    report["train_bf16_mu"] = res
    for mu, recs in res.items():
        log(f"  Adam's mu in {mu}: update " + ", ".join(
            f"{r['update_s']:.3f} s (peak {r['peak_memory_gb']:.4f} GB, moments "
            f"{r['moments_mb']:.3f} MB)" for r in recs)
            + f"; mu {recs[0]['mu_dtypes']}, nu {recs[0]['nu_dtypes']}")
    bf = res["bfloat16"][0]
    if bf["mu_dtypes"] != ["torch.bfloat16"] or bf["nu_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"bf16 mu: moments {bf['mu_dtypes']}, {bf['nu_dtypes']}")
    if not all(math.isfinite(v) for recs in res.values() for r in recs
               for v in r["metrics"].values()):
        raise AssertionError("a bf16-mu training metric is not finite")


def train_profile_phase(device, report):
    """Phase 10: where the time of a training iteration goes.  Under
    `torch.profiler`, after a warm-up of each: a rollout of 16 steps at
    512 lanes and an update of one epoch of 4 minibatches of 2048, both at
    run9 widths (bf16) from a seeded network.  Reports each window's host
    wall time, device time, busy share and top kernels; a profiler that
    records no device time is reported as "not measured".  Then the
    evaluator's layout timings (`evaluator_layouts`)."""
    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import RewardConfig
    from bbx_torch.models import network_from_config

    t_len, n = 16, RUN9_TRAINING["num_envs"]
    cfg = P.PPOConfig(**dict(RUN9_PPO, num_epochs=1), rollout_steps=t_len,
                      num_envs=n, minibatch_size=RUN9_TRAINING["batch_size"])
    net = network_from_config(RUN9_NETWORK,
                              generator=torch.Generator().manual_seed(SEED)).to(device)
    ts = P.TrainState(net, P.make_optimizer(cfg, net))
    env = reset(n, make_generator(SEED, device), device)
    act_rng = make_generator(SEED + 1, device)
    shuffle_rng = make_generator(SEED + 2, device)

    def rollout():
        nonlocal env
        env, traj, last_value, _ = P.rollout(net, cfg, RewardConfig(), env, act_rng)
        return traj, last_value

    def update(traj, last_value):
        adv, ret = P.compute_gae(cfg, traj["reward"], traj["done"],
                                 traj["value"], last_value)
        P.update(cfg, ts, traj, adv, ret, shuffle_rng)

    update(*rollout())  # warm-up: cuDNN plans (forward and backward), allocator

    def profiled(fn):
        torch.cuda.synchronize()
        result, wall, prof = profiled_calls(fn, record_shapes=True)
        return result, wall, device_ms_by_kernel(prof), prof

    (traj, last_value), wall_r, kernels_r, _ = profiled(rollout)
    _, wall_u, kernels_u, prof_u = profiled(lambda: update(traj, last_value))
    # An update minibatch runs no convolution of the evaluator's size (its
    # input's batch M = 2048 x 192): K8 and K8's backward do that work; the
    # value head's convolutions (batch 2048) remain.
    m = cfg.minibatch_size * 192
    conv_ops = {}
    for evt in prof_u.key_averages(group_by_input_shape=True):
        if "conv" in evt.key and evt.key.startswith("aten::"):
            shapes = [sh for sh in evt.input_shapes if sh]
            size = "evaluator" if any(sh[0] == m for sh in shapes) else "other"
            conv_ops[size] = conv_ops.get(size, 0) + evt.count / cfg.num_minibatches
    conv_kernels = sum(c for k, (_, c) in kernels_u.items()
                       if any(w in k.lower() for w in CONV_KERNEL_WORDS)) / cfg.num_minibatches
    # Launches of each a minibatch: the reduction launches its kernel twice
    # (the gradients' sums, then dctx).
    expected = {"evaluator_kernel": 1, "evaluator_grad_tiles_kernel": 1,
                "evaluator_grad_dense0_kernel": 1, "evaluator_grad_reduce_kernel": 2}
    ours = {k: sum(c for name, (_, c) in kernels_u.items() if k in name) / cfg.num_minibatches
            for k in expected}
    update_checks = {"convolution_ops_per_minibatch": conv_ops,
                     "convolution_kernels_per_minibatch": conv_kernels,
                     "k8_kernels_per_minibatch": ours,
                     "ok": conv_ops.get("evaluator", 0) == 0 and bool(kernels_u)
                     and ours == expected}
    out = {"update_checks": update_checks}
    for name, units, unit, wall, by_name in (
            ("rollout", t_len, "step", wall_r, kernels_r),
            ("update", cfg.num_minibatches, "minibatch", wall_u, kernels_u)):
        device_ms = sum(t for t, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out[name] = {
            "units": units, "unit": unit,
            "wall_ms_per_unit": wall * 1e3 / units,
            "device_ms_per_unit": device_ms / units if device_ms else "not measured",
            "device_busy_share": device_ms / (wall * 1e3) if device_ms else "not measured",
            "top_device_kernels": [{"name": k[:90], "ms_per_unit": t / units,
                                    "calls_per_unit": c / units}
                                   for k, (t, c) in top],
        }
        log(f"  {name}: {units} x {unit}, wall {out[name]['wall_ms_per_unit']:.3f} ms "
            f"per {unit}, device {out[name]['device_ms_per_unit']} ms, busy share "
            f"{out[name]['device_busy_share']}")
        for row in out[name]["top_device_kernels"]:
            log(f"    {row['ms_per_unit']:.4f} ms/{unit}  x{row['calls_per_unit']:.2f}  "
                f"{row['name']}")
    report["train_profile"] = out
    log(f"  update minibatch checks: {update_checks}")
    if not update_checks["ok"]:
        raise AssertionError(f"an update minibatch ran a convolution of the evaluator's "
                             f"size or missed K8 or its backward: {update_checks}")
    # The evaluator in both layouts, after the train path so that neither
    # path's first forward finds cuDNN's plans for these shapes made.
    report["evaluator_layouts"] = layouts = evaluator_layouts(device)
    for t in layouts["turns"]:
        log(f"  evaluator alone, {t['layout']}: forward at M = {K4_LANES} x 192 "
            f"{t['forward_ms']:.4f} ms"
            + (f", forward at M = {RUN9_TRAINING['batch_size']} x 192 "
               f"{t['forward_2048_ms']:.4f} ms" if "forward_2048_ms" in t else "")
            + (f", forward + backward (checkpointed) at M = {RUN9_TRAINING['batch_size']}"
               f" x 192 {t['train_ms']:.4f} ms" if "train_ms" in t else ""))
    log(f"  torch.compile yardstick: {layouts['compiled_status']}")


def update_reference_phase(device, report):
    """Phase 9: one float32 PPO update at run9 widths (TF32 off) on a fixed
    batch of T = 4 x N = 64 transitions, one epoch of one minibatch, from
    the same params on the card, and on the CPU in float64 (the reference)
    and in float32.  The stored log-probs are drawn from [-6, -2] so that
    ratios spread and clipping is exercised.  Against the float64 update,
    the card's continuous metrics must agree within 1e-4 relative, the clip
    fraction within one sample (1/256), the post-Adam params within 1e-6 +
    1e-3 x lr (Adam's step is about lr per element; the grads differ only
    by rounding).  The reference is float64, not
    the CPU's float32: a float32 ReLU that flips on a pre-activation within
    rounding of 0 moves a gradient element by its whole term, and Adam's
    first step, about lr x sign(grad), carries that into the params (at
    run9 widths the CPU's float32 update lies 5.5e-5 from the float64 one
    in `evaluator.dense0.weight`, the card's within 1e-8 of it).  Each
    parameter's error is reported, and the CPU's float32 update against
    the float64 one and against the card."""
    import copy

    import numpy as np
    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.device import float32_exact
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe, step
    from bbx_torch.models import network_from_config

    t_len, n = 4, 64
    cfg = P.PPOConfig(**dict(RUN9_PPO, num_epochs=1), minibatch_size=t_len * n,
                      rollout_steps=t_len, num_envs=n)
    rng = np.random.default_rng(SEED)
    state = reset(n, make_generator(SEED, "cpu"), "cpu")
    obs = observe(state)
    cols = {k: [] for k in ("board", "piece_ids", "used", "mask", "action",
                            "reward", "done")}
    for _ in range(t_len):
        act = torch.tensor([rng.choice(np.flatnonzero(m))
                            for m in obs["action_mask"].numpy()], dtype=torch.int32)
        out = step(state, act, auto_reset=True)
        for k, v in (("board", state.board), ("piece_ids", state.piece_ids.to(torch.int8)),
                     ("used", state.used), ("mask", obs["action_mask"]),
                     ("action", act), ("reward", out.reward), ("done", out.done)):
            cols[k].append(v)
        state, obs = out.state, out.obs
    traj = {k: torch.stack(v) for k, v in cols.items()}
    traj["logp"] = torch.from_numpy(rng.uniform(-6, -2, (t_len, n)).astype(np.float32))
    traj["value"] = torch.from_numpy(rng.normal(size=(t_len, n)).astype(np.float32))
    last_value = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    adv, ret = P.compute_gae_plain(cfg, traj["reward"], traj["done"],
                                   traj["value"], last_value)

    net = network_from_config(dict(RUN9_NETWORK, compute_dtype="float32"),
                              generator=torch.Generator().manual_seed(SEED))
    exact = copy.deepcopy(net).double()
    exact.compute_dtype = torch.float64
    res = {}
    counters = kernel_counters()
    k8_names = ("evaluator_scores", "_evaluator_grad_tiles", "_evaluator_grad_dense0",
                "_evaluator_grad_reduce")
    before = [counters[k].launches for k in k8_names]
    for name, dev, model in (("cpu_float64", "cpu", exact), ("cpu", "cpu", net),
                             ("card", device, net)):
        net_d = copy.deepcopy(model).to(dev)
        wide = model is exact
        ts = P.TrainState(net_d, P.make_optimizer(cfg, net_d))
        with float32_exact():
            metrics = P.update(
                cfg, ts, {k: (v.double() if wide and v.is_floating_point() else v).to(dev)
                          for k, v in traj.items()},
                (adv.double() if wide else adv).to(dev), (ret.double() if wide else ret).to(dev),
                torch.Generator(device=dev).manual_seed(SEED))
        res[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: p.detach().cpu().double() for k, p in net_d.named_parameters()})

    def versus(a, b):
        """(metrics' relative errors, clip-fraction difference, each
        parameter's largest absolute error) of run `a` against run `b`."""
        (ma, pa), (mb, pb) = res[a], res[b]
        rel = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
               for k in mb if k not in ("clip_fraction", "bc_loss")}
        return rel, abs(ma["clip_fraction"] - mb["clip_fraction"]), {
            k: max_abs_err(pa[k], pb[k]) for k in pb}

    # The card's update ran K8 (float32) and K8's backward once each.
    k8_launches = [counters[k].launches - n for k, n in zip(k8_names, before)]
    rel, clip_diff, param_errs = versus("card", "cpu_float64")
    param_err = max(param_errs.values())
    moved = max(max_abs_err(res["cpu_float64"][1][k], v.double())
                for k, v in net.named_parameters())
    atol = 1e-6 + 1e-3 * cfg.learning_rate
    ok = (max(rel.values()) <= 1e-4 and clip_diff <= 1 / (t_len * n)
          and param_err <= atol and k8_launches == [1, 1, 1, 1])
    others = {pair: versus(*pair.split("_vs_"))[2]
              for pair in ("cpu_vs_cpu_float64", "card_vs_cpu")}
    report["update_reference"] = {"metrics": {k: m for k, (m, _) in res.items()},
                                  "rel_err": rel, "clip_fraction_diff": clip_diff,
                                  "param_max_abs_err": param_err,
                                  "param_atol": atol, "param_max_move": moved,
                                  "param_abs_err": param_errs,
                                  "param_abs_err_of": others,
                                  "k8_launches": dict(zip(k8_names, k8_launches)), "ok": ok}

    def largest(errs):
        return ", ".join(f"{k} {e:.3e}" for k, e in
                         sorted(errs.items(), key=lambda kv: -kv[1])[:3])

    log(f"  update f32 card vs float64 cpu: metrics max rel err {max(rel.values()):.3e} "
        f"(limit 1e-4), clip_fraction {res['cpu_float64'][0]['clip_fraction']:.4f} vs "
        f"{res['card'][0]['clip_fraction']:.4f}, params max abs err {param_err:.3e} "
        f"(limit {atol:.3e}; the update moved them by up to {moved:.3e}); "
        f"largest: {largest(param_errs)}; K8 and its backward launched "
        f"{dict(zip(k8_names, k8_launches))}; ok={ok}")
    for pair, errs in others.items():
        log(f"  params, {pair.replace('_vs_', ' vs ')} (reported): {largest(errs)}")
    if not ok:
        raise AssertionError("the card's update disagrees with the CPU's float64 update")


def engine_phase(device, report):
    """Phase 4: the engine path through `bbx_torch.cli.benchmark`: a
    random-valid-action fleet of ENGINE_LANES lanes (chunks of 64 steps,
    5 windows of 10 chunks; `fleet_rate` pins its thread to one core and
    fails on the 20% spread gate; measured again while a measurement breaks
    it, see ENGINE_ATTEMPTS) with the launch counters set to 0 before and
    read after; the fleet-size sweep; then, on a fresh fleet of
    ENGINE_LANES lanes warmed by one chunk, one chunk recording the step's
    `regen_attempts`, one chunk under `torch.profiler` (busy share, K7's
    share of the device time) and one step under sync-debug mode
    "error"."""
    import torch

    from bbx_torch.cli import benchmark as B
    from bbx_torch.engine import step as ST
    from bbx_torch.engine.state import make_generator
    from bbx_torch.env import VectorEnv, sample_valid_actions_device

    counters = kernel_counters()
    attempts_by_size = {}

    def gated(n, attempts):
        """bench_vec_env at n lanes, taken again while its windows break the
        gate (at most `attempts` measurements); the counters are reset
        before each, so they count the kept one.  None if none kept it."""
        tries = attempts_by_size.setdefault(str(n), [])
        for _ in range(attempts):
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            try:
                r = B.bench_vec_env(num_envs=n, steps=ENGINE_CHUNK,
                                    iters=ENGINE_CHUNKS, device=device)
            except B.SpreadError as e:
                r = e.result
            torch.cuda.synchronize()
            kept = len(r["windows"]) >= 3 and r["rel_spread"] <= B.MAX_REL_SPREAD
            tries.append({"env_steps_per_sec": r["env_steps_per_sec"],
                          "rel_spread": r["rel_spread"], "kept": kept})
            log(f"  {n} lanes, measurement {len(tries)}: {r['env_steps_per_sec']:.1f} "
                f"env-steps/s, windows {[round(w, 1) for w in r['windows']]}, spread "
                f"{r['rel_spread']:.4f} (gate {B.MAX_REL_SPREAD}): "
                f"{'kept' if kept else 'broke the gate'}")
            if kept:
                return r
        return None

    main_run = gated(ENGINE_LANES, ENGINE_ATTEMPTS)
    if main_run is None:
        raise AssertionError(f"{ENGINE_LANES} lanes: none of {ENGINE_ATTEMPTS} "
                             f"measurements kept the {B.MAX_REL_SPREAD} gate")
    launches = {name: fn.launches for name, fn in counters.items()}
    steps_run = ENGINE_CHUNK * (1 + ENGINE_CHUNKS * main_run["timed_windows"])
    log(f"  {ENGINE_LANES} lanes: {main_run['env_steps_per_sec']:.1f} env-steps/s "
        f"(median of windows {[round(r, 1) for r in main_run['windows']]}, spread "
        f"{main_run['rel_spread']:.4f}, gate {B.MAX_REL_SPREAD}; measurement "
        f"{len(attempts_by_size[str(ENGINE_LANES)])}); launches over its {steps_run} "
        f"steps: {launches}")
    check_launches("engine", launches)
    sweep = {ENGINE_LANES: main_run}
    for n in ENGINE_SWEEP:
        if n not in sweep:
            sweep[n] = gated(n, SWEEP_ATTEMPTS)
        tries = attempts_by_size[str(n)]
        if sweep[n] is None:
            log(f"  sweep {n} lanes: no steady measurement ({len(tries)} broke the gate)")
            continue
        log(f"  sweep {n} lanes: {sweep[n]['env_steps_per_sec']:.1f} env-steps/s, "
            f"spread {sweep[n]['rel_spread']:.4f}, "
            f"{n / sweep[n]['env_steps_per_sec'] * 1e3:.4f} ms per step, kept at "
            f"measurement {len(tries)}")

    env = VectorEnv(ENGINE_LANES, seed=SEED, device=device)
    env.reset()
    act_rng = make_generator(SEED + 1, device)
    mask = ST.observe(env.state)["action_mask"]

    def chunk(mask, attempts=None):
        total = torch.zeros((), device=device)
        for _ in range(ENGINE_CHUNK):
            out = env.step_device(sample_valid_actions_device(act_rng, mask))
            mask = out.obs["action_mask"]
            total = total + out.reward.sum()
            if attempts is not None:
                attempts.append(out.regen_attempts)
        return mask, total.item()

    attempts = []
    with torch.inference_mode():
        mask, _ = chunk(mask)                      # warm-up: a mid-game mix
        mask, _ = chunk(mask, attempts)
        att = torch.stack(attempts).to(torch.float64)        # [steps, lanes]
        needy = att > 0
        regen = {"steps": len(attempts),
                 "needy_lanes_per_step": float(needy.sum(1).double().mean()),
                 "needy_share": float(needy.double().mean()),
                 "attempts_mean": float(att[needy].mean()),
                 "attempts_max": int(att.max()),
                 "draws_per_step": float(att.sum(1).mean())}
        log(f"  regen over {regen['steps']} steps: {regen['needy_lanes_per_step']:.1f} "
            f"lanes in need per step ({regen['needy_share']:.4f} of the fleet), "
            f"{regen['attempts_mean']:.4f} draws each on average, at most "
            f"{regen['attempts_max']}")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            mask, _ = chunk(mask)
            wall = time.perf_counter() - t0
        by_name = device_ms_by_kernel(prof)
        device_ms = sum(t for t, _ in by_name.values())
        k7_ms = sum(t for k, (t, _) in by_name.items() if "regen_kernel" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        launches_per_step = sum(c for _, c in by_name.values()) / ENGINE_CHUNK
        profile = {
            "steps": ENGINE_CHUNK, "lanes": ENGINE_LANES,
            "wall_ms_per_step": wall * 1e3 / ENGINE_CHUNK,
            "device_launches_per_step": launches_per_step,
            "device_ms_per_step": device_ms / ENGINE_CHUNK if device_ms else "not measured",
            "device_busy_share": device_ms / (wall * 1e3) if device_ms else "not measured",
            "regen_kernel_share_of_device": k7_ms / device_ms if device_ms else "not measured",
            "port_kernels_ms_per_step": {
                name: sum(t for k, (t, _) in by_name.items() if name in k) / ENGINE_CHUNK
                for name in ("move_kernel", "regen_kernel", "step_finish_kernel")},
            "top_device_kernels": [{"name": k[:90], "ms_per_step": t / ENGINE_CHUNK,
                                    "calls_per_step": c / ENGINE_CHUNK}
                                   for k, (t, c) in top]}
        log(f"  profiled chunk: wall {profile['wall_ms_per_step']:.4f} ms per step, "
            f"{launches_per_step:.2f} kernels per step (at most "
            f"{ENGINE_MAX_LAUNCHES_PER_STEP}), device {profile['device_ms_per_step']} ms, "
            f"busy share {profile['device_busy_share']}, K7 share of device time "
            f"{profile['regen_kernel_share_of_device']}; device ms a step of the "
            f"port's kernels {profile['port_kernels_ms_per_step']}")
        for row in profile["top_device_kernels"]:
            log(f"    {row['ms_per_step']:.4f} ms/step  x{row['calls_per_step']:.2f}  "
                f"{row['name']}")

        actions = sample_valid_actions_device(act_rng, mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = env.step_device(actions)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync_free = bool(torch.isfinite(out.reward).all())
    log(f"  one step of {ENGINE_LANES} lanes under sync-debug mode 'error': no host "
        f"synchronisation, rewards finite={sync_free}")
    report["engine"] = {"main": main_run, "launches": launches,
                        "steps_in_main_run": steps_run,
                        "measurements": attempts_by_size,
                        "sweep": {str(n): r for n, r in sweep.items()},
                        "regen": regen, "profile": profile,
                        "sync_free_step": sync_free}
    if not sync_free:
        raise AssertionError("the sync-debug step gave non-finite rewards")
    if device_ms and launches_per_step > ENGINE_MAX_LAUNCHES_PER_STEP:
        raise AssertionError(f"{launches_per_step} kernel launches a step, more "
                             f"than {ENGINE_MAX_LAUNCHES_PER_STEP}")


def flat_cnn_phase(device, report):
    """Phase 11: the flat CNN.  (a) At default widths in float32 with TF32
    off and dropout off, one train-mode forward (batch statistics, which
    move the running statistics) and one eval-mode forward on the card
    against the same on the CPU, limit 1e-4; (b) `bench_network` at its
    batch sizes (bf16, eval mode); (c) `bench_train` at bbx's defaults
    (1,024 envs x 64 steps, minibatch 16,384, 10 epochs, bf16, dropout
    0.1) for 2 timed iterations after one warm-up, every loss finite."""
    import copy

    import torch

    from bbx_torch.cli import benchmark as B
    from bbx_torch.device import float32_exact
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe, step
    from bbx_torch.models import BlockBlastNetwork
    from bbx_torch.models import distributions as D

    g = make_generator(SEED, "cpu")
    state = reset(64, g, "cpu")
    obs = observe(state)
    for _ in range(12):
        logits = D.mask_logits(torch.zeros(64, 192), obs["action_mask"])
        out = step(state, D.sample(g, logits), auto_reset=True)
        state, obs = out.state, out.obs
    net_cpu = BlockBlastNetwork(dropout_rate=0.0, compute_dtype=torch.float32,
                                generator=torch.Generator().manual_seed(SEED))
    net_gpu = copy.deepcopy(net_cpu).to(device)
    inputs = [obs[k] for k in ("board", "pieces", "action_mask")]
    errs = {}
    with float32_exact(), torch.no_grad():
        for mode in ("train", "eval"):
            net_cpu.train(mode == "train")
            net_gpu.train(mode == "train")
            lc, vc = net_cpu(*inputs)
            lg, vg = net_gpu(*(x.to(device) for x in inputs))
            m = inputs[2]
            errs[mode] = max(max_abs_err(lg.cpu()[m], lc[m]), max_abs_err(vg.cpu(), vc))
            if not torch.equal(lg.cpu()[~m], lc[~m]):
                errs[mode] = float("inf")
        errs["running_stats"] = max(max_abs_err(a.cpu(), b) for a, b in zip(
            net_gpu.buffers(), net_cpu.buffers()))
    fwd_ok = errs["train"] <= 1e-4 and errs["eval"] <= 1e-4 and errs["running_stats"] <= 1e-4
    log(f"  forward f32 at default widths, card vs cpu: train mode {errs['train']:.3e}, "
        f"eval mode {errs['eval']:.3e}, running statistics {errs['running_stats']:.3e} "
        f"(limit 1e-4), ok={fwd_ok}")

    net_bench = B.bench_network(device=device)
    for row in net_bench["rows"]:
        log(f"  network batch {row['batch']:>5}: {row['latency_ms']:.4f} ms, "
            f"{row['samples_per_sec']:.1f} samples/s")
    torch.cuda.reset_peak_memory_stats()
    train = B.bench_train(iters=2, device=device)
    train["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate([train["warmup_metrics"], *train["metrics"]]):
        log(f"  train iteration {i} ({'warm-up' if i == 0 else 'timed'}): "
            + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    log(f"  bench_train: {train['num_envs']} envs x {train['rollout']} steps, minibatch "
        f"{train['minibatch']}, {train['epochs']} epochs: "
        f"{train['train_env_steps_per_sec']:.1f} train env-steps/s, peak memory "
        f"{train['peak_memory_gb']:.3f} GB")
    report["flat_cnn"] = {"forward_errors": errs, "forward_ok": fwd_ok,
                          "network": net_bench, "train": train}
    values = [v for m in (train["warmup_metrics"], *train["metrics"]) for v in m.values()]
    if not fwd_ok:
        raise AssertionError("the flat CNN on the card disagrees with the CPU")
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("a flat-CNN training metric is not finite")


def search_step(net, state, gen, **kwargs):
    """One `lookahead_actions` call (its keyword arguments `kwargs`) with
    its simulated step recorded: (the call's result, the tiled state, the
    actions, the step's output, the search generator's state before it)."""
    from bbx_torch.agent import lookahead as L

    seen, step0 = [], L.step

    def recording_step(s, a, rc, auto_reset):
        out = step0(s, a, rc, auto_reset=auto_reset)
        seen.append((s, a, out))
        return out

    rng_state = gen.get_state()
    L.step = recording_step
    try:
        result = L.lookahead_actions(net, state, gen, **kwargs)
    finally:
        L.step = step0
    return (result, *seen[0], rng_state)


def search_eval_phase(device, report):
    """Phase 12: policy+1-ply search through the eval entry point, at run9
    widths (bf16, random weights from SEED), at top-k 0 (all 192 actions:
    98,304 simulated lanes a step) and SEARCH_TOPK (8,192), each with the
    launch counters set to 0 before and read after; K6 and K7 against
    their plain versions on the simulated fleet's inputs at both sizes;
    one float32 lookahead call at 512 lanes, card against CPU."""
    import torch

    from bbx_torch.agent import lookahead as L
    from bbx_torch.cli import evaluate
    from bbx_torch.device import float32_exact
    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST
    from bbx_torch.engine.state import EnvState
    from bbx_torch.models import network_from_config
    from bbx_torch.utils.checkpoints import save_checkpoint

    counters = kernel_counters()
    net = network_from_config(RUN9_NETWORK, generator=torch.Generator().manual_seed(SEED))
    look0, calls = evaluate.lookahead_actions, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return look0(*args, **kwargs)

    runs, total = {}, {}
    evaluate.lookahead_actions = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = save_checkpoint(tmp, "run9_seeded.pt", {"params": net.state_dict()},
                                   config={"network": RUN9_NETWORK})
            for topk in (0, SEARCH_TOPK):
                out_json = os.path.join(tmp, f"search_{topk}.json")
                calls[0] = 0
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = evaluate.main(["--checkpoint", ckpt, "--episodes", str(EVAL_EPISODES),
                                    "--lookahead", "--topk", str(topk), "--seed", str(SEED),
                                    "--output", out_json])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {name: fn.launches for name, fn in counters.items()}
                with open(out_json) as f:
                    results = json.load(f)
                moves = results["length_mean"] * results["completed"]
                runs[str(topk)] = dict(
                    rc=rc, results=results, seconds=seconds, steps=calls[0],
                    simulated_lanes=EVAL_EPISODES * (topk or 192), env_steps=moves,
                    env_steps_per_s=moves / seconds, launches=launches,
                    evaluator_launches_a_step=launches["evaluator_scores"] / max(calls[0], 1))
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                log(f"  search eval top-k {topk}: rc {rc}, {results['completed']}/"
                    f"{EVAL_EPISODES} episodes, {calls[0]} steps, {seconds:.3f} s, "
                    f"{moves / seconds:.1f} env-steps/s, score mean "
                    f"{results['score_mean']:.1f}; launches {launches}")
    finally:
        evaluate.lookahead_actions = look0
    report["search_eval"] = {"runs": runs, "launches": total}

    bad = []
    for topk, r in runs.items():
        res, steps, lc = r["results"], r["steps"], r["launches"]
        nums = [v for v in res.values() if isinstance(v, float)] + list(
            res["percentiles"].values())
        if r["rc"] != 0 or res["completed"] != EVAL_EPISODES or not res["lookahead"]:
            bad.append(f"top-k {topk}: rc {r['rc']}, {res['completed']} completed")
        if not all(math.isfinite(v) for v in nums) or res["score_min"] < 0:
            bad.append(f"top-k {topk}: bad statistics {res}")
        # The value-only path: no evaluator at full width, the policy's
        # forward once a step for the top-k; a real and a simulated step.
        want_k8 = steps if topk != "0" else 0
        if lc["evaluator_scores"] != want_k8 or lc["_move_core"] != 2 * steps:
            bad.append(f"top-k {topk}: K8 {lc['evaluator_scores']} (want {want_k8}), "
                       f"K6 {lc['_move_core']} (want {2 * steps}) in {steps} steps")
    check_launches("search_eval", total)

    # K6 and K7 on the simulated fleet's inputs: SEARCH_TOPK and all 192
    # candidates of 512 mid-game lanes.
    state = midgame_boards(device)[0]
    state = state.replace(**{f: getattr(state, f)[:EVAL_EPISODES].contiguous()
                             for f in STATE_FIELDS})
    net = net.to(device).eval()
    gen = ES.make_generator(SEED + 2, device)
    cases = {}
    for topk in (SEARCH_TOPK, 0):
        _, tiled, actions, _, rng_state = search_step(net, state, gen, topk=topk)
        # Where a lookahead call's time goes: 8 calls under the profiler.
        reps = 8
        _, wall, prof = profiled_calls(
            lambda: L.lookahead_actions(net, state, gen, topk=topk), reps)
        by_name = device_ms_by_kernel(prof)
        dev_ms = sum(t for t, _ in by_name.values()) / reps
        call = {"wall_ms": 1e3 * wall / reps, "device_ms": dev_ms,
                "busy_share": dev_ms / (1e3 * wall / reps),
                "launches": sum(c for _, c in by_name.values()) / reps,
                "kernels": {k[:90]: [t / reps, c / reps] for k, (t, c) in sorted(
                    by_name.items(), key=lambda kv: -kv[1][0])[:10]}}
        k6 = with_bound(k6_case(tiled, actions, rng_state, auto_reset=False))
        moved = ST._move_core(tiled, actions)
        gen.set_state(rng_state)
        seed = ES.regen_seed(gen, device)
        k7 = k7_case(moved.bits, tiled.piece_ids, seed, moved.need)
        gen.set_state(rng_state)
        step_attempts = ST.step(tiled, actions, ST.RewardConfig(), False).regen_attempts
        k7["matches_the_step"] = torch.equal(k7.pop("attempts"), step_attempts)
        k7["equal"] = k7["equal"] and k7["matches_the_step"]
        with_bound(k7)
        cases[tiled.num_envs] = (k6, k7)
        report["search_eval"].setdefault("lookahead_call", {})[str(tiled.num_envs)] = call
        log(f"  one lookahead call, {tiled.num_envs} simulated lanes: {call}")
        log(f"  simulated fleet of {tiled.num_envs} lanes: K6 equal={k6['equal']}, "
            f"{k6['ms']:.4f} ms (device {k6['device_ms']}), plain {k6['plain_ms']:.4f} "
            f"ms, bound {k6['bound_ms']:.6f} ms; K7 equal={k7['equal']} ({k7['needy']} "
            f"in need, {k7['attempts_mean']:.3f} draws on average), {k7['ms']:.4f} ms "
            f"(device {k7['device_ms']}), plain {k7['plain_ms']:.4f} ms, bound "
            f"{k7['bound_ms']:.6f} ms")
        if not (k6["equal"] and k7["equal"]):
            bad.append(f"K6 or K7 != plain at {tiled.num_envs} simulated lanes")
    rows = {r["name"]: r for r in report.get("kernels", [])}
    for name, i in (("_move_core/_step_finish_cuda", 0), ("regen_pieces", 1)):
        if name in rows:
            rows[name]["at_search_shapes"] = {str(n): c[i] for n, c in cases.items()}

    # One float32 lookahead call at 512 lanes, card against CPU, on the same
    # policy logits (the card's): the CPU steps the card's tiled fleet with
    # the card's regen seed (its plain step), and computes V(s') on the
    # card's simulated states.
    f32 = dict(RUN9_NETWORK, compute_dtype="float32")
    card = network_from_config(f32, generator=torch.Generator().manual_seed(SEED)).to(device)
    cpu = network_from_config(f32, generator=torch.Generator().manual_seed(SEED))
    gen = ES.make_generator(SEED + 3, device)
    rc = ST.RewardConfig()
    with float32_exact(), torch.no_grad():
        obs = ST.observe(state)
        logits, _ = card(obs["board"], obs["pieces"], obs["action_mask"])
        (action, cand, q), tiled, actions, out, rng_state = search_step(
            card, state, gen, reward_config=rc, topk=SEARCH_TOPK, policy_logits=logits,
            return_q=True)
        gen.set_state(rng_state)
        seed = ES.regen_seed(gen, device).cpu()
        t_cpu = EnvState(**{f: getattr(tiled, f).cpu() for f in STATE_FIELDS}, rng=None)
        moved = ST._move_core_plain(t_cpu, actions.cpu())
        ids, _ = ES.regen_pieces_plain(moved.bits, t_cpu.piece_ids, seed, moved.need)
        s2, _, reward, done, _ = ST._step_finish_plain(t_cpu, moved, ids, None, rc, False)
        s_cpu = EnvState(**{f: getattr(state, f).cpu() for f in STATE_FIELDS}, rng=None)
        cand_cpu = torch.sort(logits.cpu(), dim=1, descending=True,
                              stable=True).indices[:, :SEARCH_TOPK].to(torch.int32)
        v2 = cpu.value(out.obs["board"].cpu(), out.obs["pieces"].cpu())
        n = state.num_envs
        q_cpu = reward + 0.99 * v2 * (1.0 - done.to(torch.float32))
        cand_mask = torch.gather(ST.observe(s_cpu)["action_mask"], 1, cand_cpu.long())
        q_cpu = torch.where(cand_mask, q_cpu.reshape(n, SEARCH_TOPK), -torch.inf)
    q_card = q.cpu()
    finite = cand_mask
    err = float((q_card[finite] - q_cpu[finite]).abs().max())
    top2 = q_cpu.sort(dim=1, descending=True).values[:, :2]
    clear = cand_mask.any(dim=1) & ((top2[:, 0] - top2[:, 1]) > SEARCH_F32_ATOL)
    best = torch.gather(cand_cpu, 1, q_cpu.argmax(dim=1, keepdim=True))[:, 0]
    parity = {
        "candidates_equal": torch.equal(cand.cpu(), cand_cpu),
        "reward_equal": torch.equal(out.reward.cpu(), reward),
        "done_equal": torch.equal(out.done.cpu(), done),
        "states_equal": compare(EnvState(**{f: getattr(out.state, f).cpu()
                                            for f in STATE_FIELDS}, rng=None), s2)[0],
        "invalid_equal": torch.equal(torch.isinf(q_card), ~cand_mask),
        "max_abs_q_err": err, "tolerance": SEARCH_F32_ATOL,
        "actions_compared": int(clear.sum()),
        "actions_equal": torch.equal(action.cpu()[clear], best[clear]),
    }
    report["search_eval"]["card_vs_cpu"] = parity
    log(f"  float32 lookahead at {n} lanes, top-k {SEARCH_TOPK}, card vs CPU: {parity}")
    if not (all(v for k, v in parity.items() if k.endswith("_equal"))
            and err <= SEARCH_F32_ATOL):
        bad.append(f"card vs CPU lookahead: {parity}")
    if bad:
        raise AssertionError("; ".join(bad))


def distill_config(work: str) -> dict:
    """config/run8.yaml as phase 13 runs it: its `ppo:`, `training:` and
    `network:` sections as written, no `rewards:` (run8 sets none, so the
    defaults), and logging and paths under `work`."""
    return {"ppo": RUN8_PPO, "training": RUN8_TRAINING, "network": RUN8_NETWORK,
            "logging": {"log_interval": 1, "save_interval": 2, "eval_interval": 0},
            "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                      "log_dir": os.path.join(work, "logs")}}


def distill_phase(device, report):
    """Phase 13: config/run8.yaml (from-scratch Q-soft distillation on the
    flat CNN) through `bbx_torch.cli.train.main` at its widths and shape,
    cut to DISTILL_TIMESTEPS (2 iterations, so the anneal, 55% of that
    horizon, ends after the first: iteration 1 searches, iteration 2 is
    pure-policy PPO), each iteration's rollout and update timed, with the
    launch counters set to 0 before and read after; then `latest` is
    loaded and one more iteration run.  Then a 16-step search rollout of
    a fresh run8 trainer with each search call timed (a synchronise on
    each side): the search's share of a rollout step."""
    import dataclasses

    import torch

    from bbx_torch.agent import ppo as P
    from bbx_torch.agent import trainer as TR
    from bbx_torch.cli import train as cli_train
    from bbx_torch.utils.config import load_config

    work = os.path.join(ROOT, "build", "chip_smoke_distill")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = distill_config(work)
    cfg_path = os.path.join(work, "run8.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)

    counters = kernel_counters()
    iters, stats = [], {}
    rollout0, update0, train0 = P.rollout, P.update, cli_train.train
    it0 = TR.train_iteration

    def timed_rollout(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout0(*args, **kwargs)
        torch.cuda.synchronize()
        iters.append({"rollout_s": time.perf_counter() - t0})
        return out

    def timed_update(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = update0(*args, **kwargs)
        torch.cuda.synchronize()
        iters[-1]["update_s"] = time.perf_counter() - t0
        return metrics

    def watched_iteration(*args, **kwargs):
        out = it0(*args, **kwargs)
        iters[-1]["metrics"] = {k: float(v) for k, v in out[2].items()}
        return out

    def captured_train(*args, **kwargs):
        out = train0(*args, **kwargs)
        stats.update({k: v for k, v in out.items() if k != "trainer"})
        return out

    P.rollout, P.update, cli_train.train = timed_rollout, timed_update, captured_train
    TR.train_iteration = watched_iteration
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_train.main(["--config", cfg_path, "--total-timesteps",
                             str(DISTILL_TIMESTEPS), "--seed", str(TRAIN_SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        P.rollout, P.update, cli_train.train = rollout0, update0, train0
        TR.train_iteration = it0
    trainer = TR.PPOTrainer(load_config(cfg_path), seed=TRAIN_SEED,
                            total_timesteps=DISTILL_TIMESTEPS, device=device)
    trainer.load(os.path.join(cfg["paths"]["checkpoint_dir"], "latest"))
    resumed_from = trainer.global_step
    resumed = {k: float(v) for k, v in trainer.iterate().items()}
    for i, r in enumerate(iters):
        log(f"  iteration {i + 1}: rollout {r['rollout_s']:.3f} s, update "
            f"{r.get('update_s', 0.0):.3f} s; "
            + ", ".join(f"{k} {v:.6g}" for k, v in r.get("metrics", {}).items()))
    log(f"  distill train: rc {rc}, {stats.get('global_step')} env-steps in "
        f"{stats.get('elapsed_sec', 0.0):.3f} s of the loop ({wall:.3f} s with set-up) "
        f"= {stats.get('steps_per_sec', 0.0):.1f} train env-steps/s; launches {launches}")

    # The search's share of a rollout step: 16 steps of a fresh trainer's
    # first (searching) rollout.
    short = TR.PPOTrainer(load_config(cfg_path), seed=TRAIN_SEED + 1,
                       total_timesteps=DISTILL_TIMESTEPS, device=device)
    cfg16 = dataclasses.replace(short.ppo, rollout_steps=16)
    look0, search_s = P.lookahead_actions, []

    def timed_search(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = look0(*args, **kwargs)
        torch.cuda.synchronize()
        search_s.append(time.perf_counter() - t0)
        return out

    for timed in (False, True):  # a warm-up, then the measurement
        P.lookahead_actions = timed_search if timed else look0
        try:
            search_s.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout0(short.network, cfg16, short.rewards, short.env_state,
                     short.rngs["action"], short.rngs["dropout"], update_step=0,
                     search_rng=short.rngs["search"])
            torch.cuda.synchronize()
            short_s = time.perf_counter() - t0
        finally:
            P.lookahead_actions = look0
    profile = {"rollout_steps": 16, "rollout_s": short_s, "search_s": sum(search_s),
               "search_calls": len(search_s), "search_share": sum(search_s) / short_s,
               "search_ms_a_step": 1e3 * sum(search_s) / max(len(search_s), 1),
               "step_ms": 1e3 * short_s / 16}
    log(f"  search share of a rollout step (16 steps, 512 envs, top-k "
        f"{RUN8_PPO['search_topk']}): {profile}")
    report["distill"] = {"iterations": iters, "launches": launches, "wall_seconds": wall,
                         "stats": stats, "resumed_from": resumed_from,
                         "resumed_metrics": resumed, "search_profile": profile,
                         "train_env_steps_per_s": stats.get("steps_per_sec", 0.0)}

    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    if len(iters) != 2 or stats.get("global_step") != DISTILL_TIMESTEPS:
        raise AssertionError(f"{len(iters)} iterations, {stats.get('global_step')} steps")
    values = [v for r in iters for v in r["metrics"].values()] + list(resumed.values())
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("a training metric is not finite")
    first = iters[0]["metrics"]
    if not (first["bc_loss"] > 0.0 and first["search_frac"] > 0.0):
        raise AssertionError(f"the first iteration did not search and clone: {first}")
    if resumed_from != DISTILL_TIMESTEPS:
        raise AssertionError(f"latest holds step {resumed_from}")
    check_launches("distill", launches)
    if profile["search_calls"] != 16:
        raise AssertionError(f"{profile['search_calls']} search calls in 16 steps")


# Phase 14: the train CLI's profile at a small fleet (run9's network and
# PPO recipe), long enough to reach the trace after update 20.
PROFILE_TRAINING = {"num_envs": 64, "rollout_steps": 32, "batch_size": 512}
PROFILE_ITERATIONS = 21
# Phase 14's single-env game: the env's seed and the `np.random.seed` of
# its `sample_valid_action` draws.
HOST_GAME_SEED, HOST_NP_SEED = SEED, 0


def captured(fn, *args, **kwargs):
    """(fn's result, what it printed to standard output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def single_env_transition(env, before, rng_state, action, result) -> dict:
    """The single env's transition from `before` (its generator at
    `rng_state`) by `action`, which gave `result` (obs, reward,
    terminated, truncated, info), against the engine's plain step on the
    card from the same state and generator state: the new state (every
    field, the episode return too) and the observation exactly, the reward
    bit for bit, the info's counters and flags equal."""
    import numpy as np
    import torch

    from bbx_torch.engine import step as ST

    obs, reward, terminated, _, info = result
    g = torch.Generator(device=before.device)
    g.set_state(rng_state)
    acts = torch.tensor([action], dtype=torch.int32, device=before.device)
    plain = ST._step_plain(before.replace(rng=g), acts, env.reward_config, False)
    state_equal, err = compare(env.state, plain.state)
    pi = {k: v[0].item() for k, v in plain.info.items()}
    want_info = {"score": pi["score"], "moves": pi["moves"],
                 "lines_cleared": pi["lines_cleared"], "max_combo": pi["max_combo"],
                 "blocks_placed": pi["blocks_placed"], "holes": pi["holes"],
                 "board_fill": float(plain.state.board.sum().item() / 64.0),
                 "invalid_action": pi["invalid_action"],
                 "last_move": {"blocks_placed": pi["last_blocks_placed"],
                               "lines_cleared": pi["last_lines_cleared"],
                               "combo_multiplier": pi["last_combo_multiplier"],
                               "score_gained": pi["last_score_gained"]}}
    checks = {
        "state": state_equal,
        "obs": all(np.array_equal(obs[k], plain.obs[k][0].cpu().numpy().astype(obs[k].dtype))
                   for k in ("board", "pieces", "action_mask")),
        "reward": np.float32(reward).tobytes() == plain.reward[0].cpu().numpy().tobytes(),
        "terminated": terminated == bool(plain.done[0]),
        "info": info == want_info,
    }
    return {"equal": all(checks.values()), "checks": checks, "max_abs_err": err}


def single_env_parts(env, steps: int = 300) -> dict:
    """Host µs a step of the single env's parts on the card, over `steps`
    random valid moves (a reset at each game's end), the body of
    `BlockBlastEnv.step` timed part by part: the action's copy to the
    card, the engine's step (its enqueue), the wait for the device, the
    one host copy of what the step returns (`_fetch`), and the rest (the
    observation and info dicts from that copy, and the draw of the next
    action)."""
    import numpy as np
    import torch

    from bbx_torch.engine import step as ST

    parts = dict.fromkeys(("action_copy", "engine_step", "device_wait", "fetch", "rest"), 0.0)
    np.random.seed(HOST_NP_SEED)
    env.reset(seed=HOST_GAME_SEED)
    a = env.sample_valid_action()
    for _ in range(steps):
        t0 = time.perf_counter()
        acts = torch.tensor([a], dtype=torch.int32, device=env.device)
        t1 = time.perf_counter()
        out = ST.step(env.state, acts, env.reward_config, auto_reset=False)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        env.state = out.state
        env._fetch(out.obs, out.info["holes"], out)
        t4 = time.perf_counter()
        env._get_observation(), env._get_info(last_move=True)
        if env._host["terminated"]:
            env.reset()
        a = env.sample_valid_action()
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k] += dt
    return {k: v / steps * 1e6 for k, v in parts.items()}


def host_api_phase(device, report):
    """Phase 14: the host API on the card.  A `BlockBlastEnv` game under
    `sample_valid_action` (`np.random.seed`), each transition held against
    the engine's plain step, then replayed from the same seeds; the flat
    env's observation; the play CLI's random mode; `watch` of a seeded,
    freshly initialised run9 AfterstateNetwork (bf16) from a checkpoint,
    with the launch counters set to 0 before and read after; K4 and K8 at
    one lane against their plain versions; the benchmark CLI's `--env`;
    the eval CLI's `--render`; the train CLI's `--profile` for
    PROFILE_ITERATIONS iterations at a small fleet (mfu rows, the phase
    report, the trace), with the launch counters read; and run9's mfu from
    phase 8's iterations."""
    import re

    import numpy as np
    import torch

    from bbx_torch.agent.policy_agent import PolicyAgent
    from bbx_torch.agent.trainer import PEAK_FLOPS, iteration_flops, ppo_config_from
    from bbx_torch.cli import benchmark as BM
    from bbx_torch.cli import evaluate
    from bbx_torch.cli import play
    from bbx_torch.cli import train as cli_train
    from bbx_torch.engine.step import observe
    from bbx_torch.env.single import BlockBlastEnv, BlockBlastEnvFlat
    from bbx_torch.models import network_from_config
    from bbx_torch.utils.checkpoints import save_checkpoint

    out = report.setdefault("host_api", {})
    counters = kernel_counters()

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    # The single env: a game to its end, each transition held to the plain
    # step; then the same seeds replay it.
    env = BlockBlastEnv(seed=HOST_GAME_SEED, device=device)

    def game(check: bool):
        np.random.seed(HOST_NP_SEED)
        env.reset(seed=HOST_GAME_SEED)
        trail, cases, mid = [], [], None
        while True:
            before, rng_state = env.state, env.state.rng.get_state()
            a = env.sample_valid_action()
            result = env.step(a)
            trail.append((a, result[1], result[4]["score"], result[2]))
            if check:
                cases.append(single_env_transition(env, before, rng_state, a, result))
            if mid is None and len(trail) == 5:
                mid = env.state
            if result[2] or len(trail) > 10_000:
                return trail, cases, mid

    zero_counters()
    t0 = time.perf_counter()
    trail, cases, mid_state = game(check=True)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    out["single_env"] = {"launches": launches()}
    replay, _, _ = game(check=False)
    bad = [i for i, c in enumerate(cases) if not c["equal"]]
    out["game"] = {"moves": len(trail), "score": trail[-1][2], "checked_seconds": checked_s,
                   "transitions_equal": len(cases) - len(bad),
                   "first_mismatch": cases[bad[0]] if bad else None,
                   "replayed_identically": replay == trail}
    log(f"  single env: a {len(trail)}-move game (score {trail[-1][2]}), "
        f"{len(cases) - len(bad)}/{len(cases)} transitions equal to the plain step, "
        f"replayed identically={replay == trail}; launches {out['single_env']['launches']}")
    flat = BlockBlastEnvFlat(seed=HOST_GAME_SEED, device=device)
    flat_shape = flat.reset(seed=HOST_GAME_SEED)[0]["obs"].shape

    # The play CLI's random mode.
    rc_random, text = captured(play.main, ["--mode", "random", "--games", "3"])
    out["play_random"] = {"rc": rc_random, "summary": text.strip().splitlines()[-1]}
    log(f"  play --mode random --games 3: rc {rc_random}; {out['play_random']['summary']}")

    # watch, eval --render and K4 / K8 at one lane on a seeded run9 network.
    work = os.path.join(ROOT, "build", "chip_smoke_host_api")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    net = network_from_config(RUN9_NETWORK, generator=torch.Generator().manual_seed(SEED))
    ckpt = save_checkpoint(work, "run9_seeded.pt", {"params": net.state_dict()},
                           config={"network": RUN9_NETWORK})
    zero_counters()
    t0 = time.perf_counter()
    watched, text = captured(play.watch, ckpt, games=1, delay=0.0, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moves = watched["moves"][0]
    watch_launches = launches()
    # Again, warm (the first call selects the value head's cuDNN plans).
    t0 = time.perf_counter()
    captured(play.watch, ckpt, games=1, delay=0.0, seed=SEED)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    agent = PolicyAgent.from_checkpoint(ckpt, device=device)
    mid_obs = {k: v[0].cpu().numpy() for k, v in observe(mid_state).items()}
    t0 = time.perf_counter()
    for _ in range(50):
        agent.select_action(mid_obs, deterministic=True)
    act_ms = (time.perf_counter() - t0) / 50 * 1e3
    out["watch"] = {"launches": watch_launches, "moves": moves, "score": watched["scores"][0],
                    "seconds": seconds, "ms_per_move": seconds / max(moves, 1) * 1e3,
                    "warm_ms_per_move": warm / max(moves, 1) * 1e3,
                    "select_action_ms": act_ms}
    log(f"  watch: {moves} moves (score {watched['scores'][0]}) in {seconds:.3f} s = "
        f"{out['watch']['ms_per_move']:.3f} ms a move, rendering included (warm "
        f"{out['watch']['warm_ms_per_move']:.3f}; `select_action` alone {act_ms:.3f} ms); "
        f"launches {watch_launches}")

    one = observe(mid_state)
    bd, pc = one["board"].contiguous(), one["pieces"].contiguous()
    bf16, f32 = torch.bfloat16, torch.float32
    out["one_lane"] = {
        "afterstate_buffer": {f"1_{str(dt)[6:]}": with_bound(k4_case(bd, pc, dt))
                              for dt in (bf16, f32)},
        "evaluator_scores": {f"1_{str(dt)[6:]}": k8_case(device, RUN9_EVAL_WIDTHS, bd, pc, dt)
                             for dt in (bf16, f32)}}
    for name, cs in out["one_lane"].items():
        for key, c in cs.items():
            log(f"  {name} at one lane, {key}: equal={c['equal']} (err {c['max_abs_err']:.4g}), "
                f"{c['ms']:.4f} ms (device {c['device_ms']}; host {c['host_us']:.1f} us), "
                f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms ({c['bound_by']})")

    rc_bench, text = captured(BM.main, ["--env"])
    line = next(l for l in text.splitlines() if l.startswith("single_env:"))
    out["bench_single_env"] = {"rc": rc_bench, **{
        k: float(v.replace(",", "")) for k, v in re.findall(r"(\w+)=([\d,.]+)", line)}}
    log(f"  benchmark --env: rc {rc_bench}; {line}")
    out["single_env_parts_us"] = single_env_parts(env)
    log(f"  single env, host µs a step by part: {out['single_env_parts_us']}")

    rc_eval, text = captured(evaluate.main, [
        "--checkpoint", ckpt, "--episodes", "16", "--deterministic", "--seed", str(SEED),
        "--render", "--render-games", "1"])
    out["eval_render"] = {"rc": rc_eval, "rendered": "game 1: score=" in text
                          and "Available pieces" in text}
    log(f"  evaluate --render --render-games 1: rc {rc_eval}, rendered "
        f"{out['eval_render']['rendered']}")

    # The train CLI's profile.
    cfg = {"ppo": RUN9_PPO, "network": RUN9_NETWORK, "rewards": RUN9_REWARDS,
           "training": dict(RUN9_TRAINING, **PROFILE_TRAINING),
           "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0},
           "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                     "log_dir": os.path.join(work, "logs")}}
    cfg_path = os.path.join(work, "profile.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    per_iter = PROFILE_TRAINING["num_envs"] * PROFILE_TRAINING["rollout_steps"]
    zero_counters()
    rc_train, text = captured(cli_train.main, [
        "--config", cfg_path, "--profile", "--seed", str(TRAIN_SEED),
        "--total-timesteps", str(PROFILE_ITERATIONS * per_iter)])
    out["train_profile"] = {"launches": launches()}
    logs = os.path.join(work, "logs")
    rows = [json.loads(l) for n in sorted(os.listdir(logs)) if n.endswith(".jsonl")
            for l in open(os.path.join(logs, n))]
    trace_dir = os.path.join(logs, "trace")
    traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    mfu = [r.get("mfu") for r in rows]
    lines = text.splitlines()
    at = next((i for i, l in enumerate(lines) if l.startswith("phase timing:")), len(lines))
    report_text = "\n".join([lines[at], *(l for l in lines[at + 1:] if l.startswith("  "))]
                             if at < len(lines) else [])
    peak_line = next((l for l in text.splitlines() if l.startswith("mfu:")), "")
    flops = iteration_flops(ppo_config_from(cfg), net)
    out["train_profile"].update(
        rc=rc_train, rows=len(rows), mfu=mfu, peak_line=peak_line, traces=traces,
        phase_report=report_text.strip(), flops_per_iteration=flops,
        env_steps_per_s=[r["fps"] for r in rows])
    log(f"  train --profile: rc {rc_train}, {len(rows)} rows, mfu {mfu}; {peak_line}")
    for l in report_text.strip().splitlines():
        log(f"    {l}")
    log(f"  trace files in {trace_dir}: {traces}")

    # Run9's mfu: phase 8's rollout + update seconds an iteration.
    peak = PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(bf16)
    run9_flops = iteration_flops(ppo_config_from(
        {"ppo": RUN9_PPO, "training": RUN9_TRAINING}), net)
    run9 = [run9_flops / (it["rollout_s"] + it["update_s"]) / peak
            for it in report.get("train", {}).get("iterations", [])] if peak else []
    out["run9_mfu"] = {"flops_per_iteration": run9_flops, "peak_flops": peak,
                       "from_phase8_rollout_plus_update": run9}
    log(f"  run9 iteration: {run9_flops:,} FLOPs; mfu over phase 8's rollout + update "
        f"seconds {run9} (peak {peak})")

    failures = []
    if bad or not cases:
        failures.append(f"transitions {bad} differ from the plain step")
    if replay != trail:
        failures.append("the seeded game did not replay identically")
    if flat_shape != (178,):
        failures.append(f"flat observation of shape {flat_shape}")
    if rc_random or rc_bench or rc_eval or rc_train:
        failures.append(f"a CLI returned non-zero: random {rc_random}, bench {rc_bench}, "
                        f"eval {rc_eval}, train {rc_train}")
    if not out["eval_render"]["rendered"]:
        failures.append("eval --render rendered no game")
    if not all(c["equal"] for cs in out["one_lane"].values() for c in cs.values()):
        failures.append("K4 or K8 at one lane differs from its plain version")
    if out["bench_single_env"].get("env_steps_per_sec", 0.0) <= 0:
        failures.append("benchmark --env reported no rate")
    if (len(rows) != PROFILE_ITERATIONS - 1
            or not all(isinstance(m, float) and math.isfinite(m) and 0.0 < m <= 1.0
                       for m in mfu)):
        failures.append(f"mfu rows {mfu}")
    if not report_text or not traces or not peak_line:
        failures.append("no phase report, trace or peak line")
    for path in ("single_env", "watch", "train_profile"):
        try:
            check_launches(path, out[path]["launches"])
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("; ".join(failures))


# Phase 15: two ranks on the one card.  Each rank is this script run with
# --parallel-rank (`parallel_rank`), which drives the train CLI under gloo
# on cuda:0 and records its iterations.
PARALLEL_RANKS = 2
PARALLEL_ITERATIONS = 2
PARALLEL_TIMEOUT_S = 420
# The first update's losses, 2 ranks against 1 (bf16).  Its first
# minibatch (the same parameters on both sides): each rank's sums over its
# rows, added, against one rank's means; the rows' outputs may differ by a
# bf16 rounding where cuDNN / cuBLAS pick another algorithm for the value
# head and the context at half the rows, so within PARALLEL_FIRST_RTOL /
# PARALLEL_FIRST_ATOL.  The update's averages over its 64 minibatch steps:
# the ranks' float32 sums split the rows and K8b / K8w's tile sums
# otherwise, so the parameters part in the last bits after the first Adam
# step and bf16 activations (0.4% a rounding) round apart from then on:
# within PARALLEL_LOSS_RTOL / PARALLEL_LOSS_ATOL (measured on an NVIDIA H100
# 80GB HBM3 at 700 W: the clip fraction 0.0800 against 0.0769, the approx
# KL 0.00666 against 0.00648).
PARALLEL_FIRST_RTOL = 2e-3
PARALLEL_FIRST_ATOL = 1e-5
PARALLEL_LOSS_RTOL = 1e-1
PARALLEL_LOSS_ATOL = 5e-3
PARALLEL_LOSSES = ("policy_loss", "value_loss", "entropy", "total_loss", "approx_kl",
                   "clip_fraction")
# The rollout statistics that an equal rollout makes equal (integer game
# outcomes, summed in float32 below 2**24).
PARALLEL_EXACT = ("episodes", "mean_score", "max_score", "mean_length", "invalid_frac")
# The flat CNN's BatchNorm running statistics after the first rollout
# step (one train-mode forward of the same fleet: the statistics of the
# global batch), 2 ranks against 1: within PARALLEL_BN_TOL x the tensor's
# largest |value| (bf16 activations of cuDNN convolutions at 32 rows and
# at 64).  In bf16 the statistics after the whole iteration are reported,
# not held: bf16 roundings flip sampled actions, the trajectories part,
# and so do the statistics (on an NVIDIA H100 80GB HBM3 at 700 W: by up to
# 26% of their largest value).  The same run in float32 without TF32
# has every statistic of the first rollout equal to 1 rank's, and holds
# the whole iteration.  The running statistics after the first rollout step
# within PARALLEL_F32_BN_FIRST_TOL and the first minibatch's losses within
# PARALLEL_F32_FIRST_RTOL / _ATOL: float32 sums split over 2 ranks
# (measured on an NVIDIA H100 80GB HBM3 at 700 W: 2.1e-7 of the largest
# value; the losses within 4e-7 relative).  From the update's second
# minibatch on, the losses part as they do between two 1-rank runs on the
# card (its backward is not deterministic: in three calls, 1 rank against
# itself has the second or third minibatch apart by 7.7e-8 to 3.9e-7, the
# update's averages by up to 2.5% and the running statistics after it by
# up to 9.4% of the largest value; 2 ranks against 1, up to 2.2% and
# 11.0%; scripts_dev/torch_parallel_spread.py): the update's
# averaged losses within PARALLEL_F32_LOSS_RTOL / _ATOL and the running
# statistics after the iteration within PARALLEL_F32_BN_TOL x the largest
# |value|, the card's own spread with room (each phase also reports a
# second 1-rank run against the first).
PARALLEL_BN_TOL = 1e-2
PARALLEL_F32_BN_FIRST_TOL = 1e-5
PARALLEL_F32_FIRST_RTOL = 1e-5
PARALLEL_F32_FIRST_ATOL = 1e-6
PARALLEL_F32_BN_TOL = 0.25
PARALLEL_F32_LOSS_RTOL = 1e-1
PARALLEL_F32_LOSS_ATOL = 1e-3
# config/default.yaml's `network:` and `training:` (the flat CNN with
# BatchNorm and dropout, 64 envs x 128 steps, minibatch 2048, 10 epochs).
DEFAULT_NETWORK = {"conv_channels": [64, 128, 128], "fc_hidden": [512, 256],
                   "use_batch_norm": True, "use_residual": True,
                   "compute_dtype": "bfloat16"}
DEFAULT_TRAINING = {"num_envs": 64, "batch_size": 2048, "total_timesteps": 10000000,
                    "rollout_steps": 128, "seed": 42}
DEFAULT_PPO = {"learning_rate": 0.0003, "gamma": 0.99, "gae_lambda": 0.95,
               "clip_epsilon": 0.2, "entropy_coef": 0.01, "value_coef": 0.5,
               "max_grad_norm": 0.5, "num_epochs": 10}
# Phase 16: the GUI's training runner at phase 14's small fleet, stopped
# by its callback after GUI_ROWS rows; the watch loop for GUI_MOVES moves.
GUI_ROWS = 2
GUI_MOVES = 50


class FirstRecords:
    """While installed: the BatchNorm running statistics of `net` when the
    first action is drawn (after the rollout's first forward), each
    minibatch's loss terms (`ppo_loss`'s metrics: `series`; `losses` the
    first minibatch's), and each search call of the first rollout (its
    actions, candidates, float32 Q and the policy logits that chose the
    candidates, on the CPU: `search`)."""

    def __init__(self):
        self.net = None
        self.bn = None
        self.series = []
        self.search = []

    @property
    def losses(self):
        return self.series[0] if self.series else None

    def __enter__(self):
        from bbx_torch.agent import ppo as P
        from bbx_torch.models import distributions as D

        self._saved = ((D, "sample", D.sample), (P, "ppo_loss", P.ppo_loss),
                       (P, "lookahead_actions", P.lookahead_actions))
        sample0, loss0, look0 = D.sample, P.ppo_loss, P.lookahead_actions

        def sample(*args, **kwargs):
            if self.bn is None and self.net is not None:
                self.bn = {name: buf.detach().double().cpu().reshape(-1).tolist()
                           for name, buf in self.net.state_dict().items()
                           if "running" in name}
            return sample0(*args, **kwargs)

        def ppo_loss(*args, **kwargs):
            out = loss0(*args, **kwargs)
            self.series.append({k: float(v.detach()) for k, v in out[1].items()})
            return out

        def lookahead_actions(*args, **kwargs):
            out = look0(*args, **kwargs)
            if not self.series:
                self.search.append(tuple(x.cpu() for x in (*out, kwargs["policy_logits"])))
            return out

        D.sample, P.ppo_loss, P.lookahead_actions = sample, ppo_loss, lookahead_actions
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def parallel_rank(cfg_path: str, out_path: str, seed: int, exact: bool = False) -> int:
    """One rank of phase 15 (``--parallel-rank``): the train CLI on cuda:0
    under gloo (the group from the torchrun variables the phase sets),
    with the launch counters set to 0 before; each rollout, search call,
    update, gradient all-reduce and collective save timed between
    synchronises; each iteration's metrics and whether the parameters and
    buffers are bit for bit equal on every rank after it (a digest
    gathered from each); `FirstRecords` (this rank's minibatch sums over
    its rows, divided by the global minibatch; its first rollout's search
    calls into ``<out_path>.search.pt``).  With `exact`, float32
    convolutions and matmuls run in full float32 (no TF32).  Writes its
    record to `out_path`; returns the CLI's code."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from bbx_torch.agent import ppo as P
    from bbx_torch.agent import trainer as T
    from bbx_torch.cli import train as cli_train
    from bbx_torch.device import float32_exact

    rec = {"rank": int(os.environ["RANK"]), "rollout_s": [], "update_s": [],
           "search_s": [], "allreduce_s": [], "save_s": [], "metrics": [],
           "same_params": []}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    iterate0 = T.PPOTrainer.iterate
    first = FirstRecords()

    def iterate(self):
        first.net = self.network
        metrics = iterate0(self)
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        digest = hashlib.sha256(b"".join(
            v.detach().cpu().numpy().tobytes()
            for v in self.network.state_dict().values())).hexdigest()
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, digest)
        rec["same_params"].append(len(set(digests)) == 1)
        return metrics

    P.rollout, P.update = timed(P.rollout, "rollout_s"), timed(P.update, "update_s")
    P.reduce_gradients = timed(P.reduce_gradients, "allreduce_s")
    P.lookahead_actions = timed(P.lookahead_actions, "search_s")
    T.PPOTrainer.save = timed(T.PPOTrainer.save, "save_s")
    T.PPOTrainer.iterate = iterate
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with first, (float32_exact() if exact else contextlib.nullcontext()):
        rec["rc"] = cli_train.main(["--config", cfg_path, "--device", "cuda:0",
                                    "--backend", "gloo", "--seed", str(seed)])
    rec["launches"] = {name: fn.launches for name, fn in counters.items()}
    rec["first_bn"], rec["first_losses"] = first.bn, first.losses
    rec["loss_series"] = first.series
    torch.save(first.search, out_path + ".search.pt")
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return rec["rc"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cfg_path: str, work: str, seed: int, exact: bool = False) -> list:
    """PARALLEL_RANKS processes of `parallel_rank` on cuda:0 (`exact`:
    without TF32), started together; each wait has PARALLEL_TIMEOUT_S,
    after which every rank is killed.  Returns each rank's record (raises
    if one failed)."""
    port = free_port()
    procs, outs = [], []
    for r in range(PARALLEL_RANKS):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(PARALLEL_RANKS), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(PARALLEL_RANKS))
        out = os.path.join(work, f"rank{r}.json")
        log_path = os.path.join(work, f"rank{r}.log")
        outs.append((out, log_path))
        with open(log_path, "w") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", cfg_path,
                 out, str(seed), *(["exact"] if exact else [])], env=env, stdout=logf, stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + PARALLEL_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, (out, log_path)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or not os.path.exists(out):
            with open(log_path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{tail}")
        with open(out) as f:
            recs.append(json.load(f))
    return recs


def k7_lane_base_case(device, width: int = 1) -> dict:
    """K7 on rank 1's shard of a 512-lane fleet (lanes 256-511) after a
    random valid move of reachable mid-game boards, or with `width` > 1 on
    that shard of the search's tiled fleet (each lane's top-`width`
    actions by random masked logits, tiled by `tile_state`: 256 x width
    lanes at lane base 256 x width), against `regen_pieces_plain` at the
    same base and against those lanes of the whole (tiled) fleet's K7 at
    base 0, each bit for bit; the shard's and the whole fleet's times in
    turns."""
    import dataclasses

    import torch

    from bbx_torch.agent.lookahead import tile_state
    from bbx_torch.engine import state as ES
    from bbx_torch.engine import step as ST

    n, half = 2 * 256, 256
    g = ES.make_generator(SEED, device)
    state = ES.reset(n, g, device)
    obs = ST.observe(state)
    for _ in range(20):
        u = torch.rand(obs["action_mask"].shape, generator=g, device=device)
        out = ST.step(state, torch.where(obs["action_mask"], u, -1.0).argmax(1)
                      .to(torch.int32))
        state, obs = out.state, out.obs
    u = torch.rand(obs["action_mask"].shape, generator=g, device=device)
    if width == 1:
        moved = ST._move_core(state, torch.where(obs["action_mask"], u, -1.0).argmax(1)
                              .to(torch.int32))
        fleet = state
    else:
        logits = torch.where(obs["action_mask"], u, -1e9)
        cand = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :width]
        fleet = tile_state(state, width, g)
        shard = state.replace(**{f.name: getattr(state, f.name)[half:]
                                 for f in dataclasses.fields(state) if f.name != "rng"}
                              ).sharded(half, n)
        if tile_state(shard, width, g).lane_base != half * width:
            raise AssertionError("tile_state placed the shard's tiling elsewhere")
        moved = ST._move_core(fleet, cand.reshape(-1).to(torch.int32))
    base, lanes = half * width, half * width
    seed = ES.regen_seed(g, device)
    whole_in = (moved.bits, fleet.piece_ids, seed, moved.need)
    part_in = (moved.bits[base:].contiguous(), fleet.piece_ids[base:].contiguous(), seed,
               moved.need[base:].contiguous())
    whole = ES.regen_pieces(*whole_in)
    got = ES.regen_pieces(*part_in, lane_base=base)
    want = ES.regen_pieces_plain(*part_in, lane_base=base)
    equal = all(torch.equal(a, b) and torch.equal(a, w[base:])
                for a, b, w in zip(got, want, whole))
    times = {"shard": [], "whole": []}
    for name in ("shard", "whole", "whole", "shard"):
        fn = ((lambda: ES.regen_pieces(*part_in, lane_base=base)) if name == "shard"
              else (lambda: ES.regen_pieces(*whole_in)))
        times[name].append(time_ms(fn))
    att = want[1][part_in[3]].to(torch.float64)
    return {"lanes": lanes, "lane_base": base, "width": width, "equal": equal,
            # As `k7_case` counts them: the lanes' bytes, the seed, the tables.
            "nbytes": lanes * (16 + 12 + 1 + 12 + 4) + 8 + 37 * 64 * 8 + 37 * 9 * 4
            + 37 * 8 + 37 * 37 * 64 * 8,
            "ops": regen_ops(part_in[0], seed, part_in[3], want[1], base),
            "max_abs_err": max(max_abs_err(a, b) for a, b in zip(got, want)),
            "needy": int(part_in[3].sum()), "attempts_mean": float(att.mean()),
            "ms": min(times["shard"]), "ms_turns": times["shard"],
            "whole_ms": min(times["whole"]), "whole_ms_turns": times["whole"],
            "device_ms": kernel_device_ms(lambda: ES.regen_pieces(*part_in, lane_base=base),
                                          "regen_kernel"),
            "plain_ms": time_ms(lambda: ES.regen_pieces_plain(*part_in, lane_base=base),
                                reps=3, inner=1)}


def search_rows(ranks: list, one: list) -> dict:
    """The first rollout's search calls of each rank (`FirstRecords.search`:
    a step's actions [n], candidates [n, w], float32 Q [n, w] and policy
    logits [n, 192]) against one rank's over the whole fleet, the ranks'
    lanes in rank order.  A lane plays alike when its action and its set
    of candidates are equal; `equal` when every lane of every step does,
    with each candidate's Q finite alike.  Candidates listed in another
    order (two logits inside the top-k swapped) play alike and are
    counted.  At the first step where a lane plays otherwise, each such
    lane is explained, or not, by a near-tie: another candidate set where
    the two logits at the top-k boundary lie closer than twice the row's
    largest |logit difference| between the two runs, or another action
    where the two best Q lie closer than twice the row's largest |Q
    difference| (float32 sums that round with the batch size can swap such
    a pair, and nothing else).  Q's and the logits' largest |difference|
    before that step are reported."""
    import torch

    steps = min(len(one), *(len(r) for r in ranks))
    res = {"steps": steps, "equal": steps == len(one), "q_max_abs": 0.0,
           "logit_max_abs": 0.0, "reordered_lanes": 0}
    for t in range(steps):
        got = [torch.cat([r[t][i] for r in ranks]) for i in range(4)]
        want = one[t]
        # Each side's candidates in action order, with their Q.
        order_g, order_w = got[1].long().argsort(dim=1), want[1].long().argsort(dim=1)
        cand_g, cand_w = got[1].gather(1, order_g), want[1].gather(1, order_w)
        q_g, q_w = got[2].gather(1, order_g), want[2].gather(1, order_w)
        apart = ((got[0] != want[0]) | (cand_g != cand_w).any(dim=1)
                 | (torch.isfinite(q_g) != torch.isfinite(q_w)).any(dim=1))
        res["reordered_lanes"] += int(((got[1] != want[1]).any(dim=1) & ~apart).sum())
        if not apart.any():
            both = torch.isfinite(q_g) & torch.isfinite(q_w)
            if both.any():
                res["q_max_abs"] = max(res["q_max_abs"],
                                       float((q_g - q_w)[both].abs().max()))
            res["logit_max_abs"] = max(res["logit_max_abs"],
                                       float((got[3] - want[3]).abs().max()))
            continue
        width = got[1].shape[1]
        lanes = []
        for lane in apart.nonzero()[:, 0].tolist():
            dlogit = float((got[3][lane] - want[3][lane]).abs().max())
            if not torch.equal(cand_g[lane], cand_w[lane]):
                edge = [torch.sort(x[lane], descending=True).values[width - 1:width + 1]
                        .tolist() for x in (got[3], want[3])]
                gap = min(abs(a - b) for a, b in edge)
                lanes.append({"lane": lane, "kind": "candidates", "boundary_logits": edge,
                              "gap": gap, "max_abs_logit_diff": dlogit,
                              "explained": gap <= 2 * dlogit})
            else:
                best = [torch.topk(q[lane], 2).values.tolist() for q in (q_g, q_w)]
                gap = min(b[0] - b[1] for b in best)
                fin = torch.isfinite(q_g[lane]) & torch.isfinite(q_w[lane])
                dq = float((q_g[lane] - q_w[lane])[fin].abs().max())
                lanes.append({"lane": lane, "kind": "action", "two_best_q": best,
                              "gap": gap, "max_abs_q_diff": dq,
                              "explained": gap <= 2 * dq})
        res.update(equal=False, first_apart={"step": t, "lanes": lanes},
                   explained=all(x["explained"] for x in lanes))
        break
    return res


def nccl_allreduce_case(device) -> dict:
    """A 1-rank nccl group on the card, and one all-reduce of the run9
    network's gradients through the trainer's gradient path
    (`reduce_gradients`): the sum over one rank leaves them equal; its
    time between synchronises."""
    import torch
    import torch.distributed as dist

    from bbx_torch.models import network_from_config
    from bbx_torch.parallel import initialize_multihost, reduce_gradients

    if not initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                                device=device, timeout_s=120):
        raise AssertionError("no nccl group formed")
    try:
        net = network_from_config(RUN9_NETWORK, generator=torch.Generator().manual_seed(SEED)
                                  ).to(device)
        for p in net.parameters():
            p.grad = torch.randn_like(p)
        before = [p.grad.clone() for p in net.parameters()]
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduce_gradients(net.parameters())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        equal = all(torch.equal(p.grad, b) for p, b in zip(net.parameters(), before))
        return {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
                "elements": sum(p.numel() for p in net.parameters()), "equal": equal,
                "ms": times}
    finally:
        dist.destroy_process_group()


def parallel_phase(device, report):
    """Phase 15: two ranks of the train CLI on the one card (gloo), for
    run9 at full width (PARALLEL_ITERATIONS iterations, then the collective
    save of `final`) and for one iteration of config/default.yaml's flat
    CNN, each against a 1-rank run of the same config and seed in this
    process; the 2-rank `final` resumed on 1 rank; K7 at a lane base; a
    1-rank nccl all-reduce.  Two ranks share one card here: their times
    are no scaling number."""
    import torch

    from bbx_torch.agent.trainer import PPOTrainer
    from bbx_torch.device import float32_exact
    from bbx_torch.utils.checkpoints import load_checkpoint

    out = report.setdefault("parallel_run", {})
    failures = []
    root = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)

    def config(name, ppo, training, network, iterations):
        work = os.path.join(root, name)
        os.makedirs(work)
        per_iter = training["num_envs"] * training["rollout_steps"]
        cfg = {"ppo": ppo, "network": network, "rewards": RUN9_REWARDS,
               "training": dict(training, total_timesteps=iterations * per_iter),
               "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0},
               "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                         "log_dir": os.path.join(work, "logs")}}
        path = os.path.join(work, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        return cfg, path, work

    def reference(cfg, seed, exact=False):
        """A 1-rank trainer of `cfg` after its first iteration (`exact`:
        without TF32), that iteration's metrics, and its `FirstRecords`."""
        trainer = PPOTrainer(cfg, seed=seed, device=device)
        with FirstRecords() as first, (float32_exact() if exact
                                       else contextlib.nullcontext()):
            first.net = trainer.network
            metrics = {k: float(v) for k, v in trainer.iterate().items()}
        return trainer, metrics, first

    def summary(recs):
        res = {}
        for rec in recs:
            steps = len(rec["allreduce_s"]) // max(1, len(rec["update_s"]))
            res[f"rank{rec['rank']}"] = {
                "rollout_s": rec["rollout_s"], "update_s": rec["update_s"],
                "search_s_a_rollout": sum(rec["search_s"]) / max(1, len(rec["rollout_s"])),
                "search_calls": len(rec["search_s"]),
                "allreduce_ms_a_minibatch": 1e3 * sum(rec["allreduce_s"])
                / max(1, len(rec["allreduce_s"])),
                "allreduce_s_an_update": sum(rec["allreduce_s"]) / max(1, len(rec["update_s"])),
                "minibatch_steps_an_update": steps, "save_s": rec["save_s"],
                "same_params": rec["same_params"], "launches": rec["launches"]}
            log(f"  rank {rec['rank']}: rollout {rec['rollout_s']} s (search "
                f"{res[f'rank{rec['rank']}']['search_s_a_rollout']:.3f} s of each, "
                f"{len(rec['search_s'])} calls), update {rec['update_s']} s, gradient "
                f"all-reduce "
                f"{res[f'rank{rec['rank']}']['allreduce_ms_a_minibatch']:.3f} ms a minibatch "
                f"({res[f'rank{rec['rank']}']['allreduce_s_an_update']:.3f} s an update of "
                f"{steps} steps), collective save {rec['save_s']} s, parameters equal on "
                f"every rank after each update: {rec['same_params']}")
        return res

    def launches_of(recs):
        return {k: sum(r["launches"].get(k, 0) for r in recs) for k in recs[0]["launches"]}

    # run9 at full width on 2 ranks, then 1 rank.
    cfg, path, work = config("run9", RUN9_PPO, RUN9_TRAINING, RUN9_NETWORK,
                             PARALLEL_ITERATIONS)
    t0 = time.perf_counter()
    recs = run_ranks(path, work, TRAIN_SEED)
    wall = time.perf_counter() - t0
    out["run9"] = summary(recs) | {"wall_s": wall}
    report["parallel"] = {"launches": launches_of(recs)}
    for rec in recs:
        try:
            check_launches("parallel", rec["launches"])
        except AssertionError as e:
            failures.append(f"rank {rec['rank']}: {e}")
        if not all(rec["same_params"]) or len(rec["same_params"]) != PARALLEL_ITERATIONS:
            failures.append(f"rank {rec['rank']}: parameters apart {rec['same_params']}")
    ref_trainer, ref, ref_first = reference(cfg, TRAIN_SEED)
    two = recs[0]["metrics"][0]
    exact = {k: (two[k], ref[k]) for k in PARALLEL_EXACT}
    first = {k: (sum(r["first_losses"][k] for r in recs), ref_first.losses[k])
             for k in PARALLEL_LOSSES}
    first = {k: (a, b, abs(a - b)) for k, (a, b) in first.items()}
    losses = {k: (two[k], ref[k], abs(two[k] - ref[k])) for k in PARALLEL_LOSSES}
    out["run9"].update(first_iteration_rollout=exact, first_minibatch_losses=first,
                       first_update_losses=losses,
                       tolerances={"first_minibatch": [PARALLEL_FIRST_RTOL,
                                                       PARALLEL_FIRST_ATOL],
                                   "update": [PARALLEL_LOSS_RTOL, PARALLEL_LOSS_ATOL]})
    log(f"  run9, 2 ranks vs 1, first iteration's rollout: {exact}")
    log(f"  run9, first minibatch's losses (2 ranks, 1 rank, |difference|): {first}")
    log(f"  run9, first update's losses (2 ranks, 1 rank, |difference|): {losses}")
    if any(a != b for a, b in exact.values()):
        failures.append(f"first iteration's rollout statistics differ: {exact}")
    for name, got, rtol, atol in (("first minibatch", first, PARALLEL_FIRST_RTOL,
                                   PARALLEL_FIRST_ATOL),
                                  ("first update", losses, PARALLEL_LOSS_RTOL,
                                   PARALLEL_LOSS_ATOL)):
        bad = [k for k, (a, b, d) in got.items() if not d <= atol + rtol * abs(b)]
        if bad:
            failures.append(f"{name}'s losses beyond tolerance: {bad}")
    # The 2-rank `final`, resumed on 1 rank for one iteration.
    resumed = PPOTrainer(cfg, seed=999, device=device)
    resumed.load(os.path.join(cfg["paths"]["checkpoint_dir"], "final"))
    step0 = resumed.global_step
    m = {k: float(v) for k, v in resumed.iterate().items()}
    out["run9"]["resumed_on_one_rank"] = {"from_step": step0, "metrics": m}
    log(f"  the 2-rank final resumed on 1 rank at step {step0}: one iteration, "
        f"finite: {all(math.isfinite(v) for v in m.values())}")
    if step0 != PARALLEL_ITERATIONS * ref_trainer.ppo.batch_size or \
            not all(math.isfinite(v) for v in m.values()):
        failures.append(f"the resumed run: step {step0}, metrics {m}")
    del ref_trainer, resumed

    def flat_cnn(name, dtype, bn_tol, exact=False, ppo=DEFAULT_PPO,
                 training=DEFAULT_TRAINING, network=DEFAULT_NETWORK,
                 path_name="parallel_cnn", again=False):
        """One iteration of a flat CNN config (BatchNorm, dropout;
        config/default.yaml's by default) in `dtype` (`exact`: without
        TF32) on 2 ranks and on 1: the phase's record of it, with the
        BatchNorm running statistics after the first rollout step (held
        within `bn_tol` x the largest |value|) and after the iteration, the
        first rollout's statistics and the losses of the first minibatch,
        of each and of the update, 2 ranks against 1; with search, the
        first rollout's search rows (`search_rows`); `again`: a second
        1-rank run against the first (the card's own spread); the ranks'
        launches, held to `path_name`'s kernels.  Returns the ranks'
        records, the record and the config."""
        cfg, path, work = config(name, ppo, training,
                                 dict(network, compute_dtype=dtype), 1)
        recs = run_ranks(path, work, TRAIN_SEED, exact)
        res = summary(recs)
        for rec in recs:
            try:
                check_launches(path_name, rec["launches"])
            except AssertionError as e:
                failures.append(f"{name} rank {rec['rank']}: {e}")
            if not all(rec["same_params"]):
                failures.append(f"{name} rank {rec['rank']}: parameters apart")
        ref_trainer, ref, ref_first = reference(cfg, TRAIN_SEED, exact)
        if ref_first.search:
            res["first_rollout_search"] = search_rows(
                [torch.load(os.path.join(work, f"rank{r}.json.search.pt"))
                 for r in range(PARALLEL_RANKS)], ref_first.search)
            log(f"  {name}: the first rollout's search, 2 ranks vs 1: "
                f"{res['first_rollout_search']}")
        saved = load_checkpoint(os.path.join(cfg["paths"]["checkpoint_dir"],
                                             "final"))["params"]
        stats, after = {}, {}
        for key, buf in ref_trainer.network.state_dict().items():
            if "running" not in key:
                continue
            want = torch.tensor(ref_first.bn[key], dtype=torch.float64)
            got = [torch.tensor(r["first_bn"][key], dtype=torch.float64) for r in recs]
            top = float(want.abs().max())
            err = float((got[0] - want).abs().max())
            stats[key] = {"max_abs_err": err, "ref_max": top,
                          "ranks_equal": all(torch.equal(g, got[0]) for g in got),
                          "within": err <= bn_tol * top}
            end = buf.cpu().double()
            after[key] = {"max_abs_err": float((saved[key].double() - end).abs().max()),
                          "ref_max": float(end.abs().max())}
        two = recs[0]["metrics"][0]
        series = [{k: sum(r["loss_series"][i][k] for r in recs) for k in PARALLEL_LOSSES}
                  for i in range(min(len(r["loss_series"]) for r in recs))]
        # Each minibatch's total loss, 2 ranks against 1: |difference| / |1 rank's|.
        apart = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                 for a, b in zip(series, ref_first.series)]
        res.update(
            running_stats_first_step=stats, running_stats_after_iteration=after,
            first_iteration_rollout={k: (two[k], ref[k]) for k in PARALLEL_EXACT},
            first_minibatch_losses={k: (series[0][k], ref_first.losses[k],
                                        abs(series[0][k] - ref_first.losses[k]))
                                    for k in PARALLEL_LOSSES},
            minibatch_total_loss_rel_diff=apart,
            update_losses={k: (two[k], ref[k], abs(two[k] - ref[k]))
                           for k in PARALLEL_LOSSES},
            bn_tolerance=bn_tol)
        log(f"  flat CNN ({dtype}) BatchNorm running statistics after the first "
            f"rollout step, 2 ranks vs 1: largest |difference| "
            f"{max(v['max_abs_err'] for v in stats.values()):.3g} over {len(stats)} "
            f"tensors (largest |value| {max(v['ref_max'] for v in stats.values()):.3g}), "
            f"equal on both ranks: {all(v['ranks_equal'] for v in stats.values())}, "
            f"within tolerance: {all(v['within'] for v in stats.values())}; after the "
            f"iteration: largest |difference| "
            f"{max(v['max_abs_err'] for v in after.values()):.3g}, relative to the "
            f"tensor's largest |value| "
            f"{max(v['max_abs_err'] / max(v['ref_max'], 1e-30) for v in after.values()):.3g}"
            f"; first rollout 2 ranks / 1: {res['first_iteration_rollout']}; the first "
            f"minibatch's losses (2 ranks, 1 rank, |difference|): "
            f"{res['first_minibatch_losses']}; each minibatch's total loss, "
            f"|difference| / |1 rank's|: {apart}; the update's losses: "
            f"{res['update_losses']}")
        if not stats or not all(v["within"] and v["ranks_equal"] for v in stats.values()):
            failures.append(f"{name} running statistics beyond tolerance")
        if again:
            # The card's own spread: the 1-rank run again, against the first.
            again, ref2, first2 = reference(cfg, TRAIN_SEED, exact)
            res["one_rank_again"] = {
                "update_losses": {k: (ref2[k], ref[k], abs(ref2[k] - ref[k]))
                                  for k in PARALLEL_LOSSES},
                "minibatch_total_loss_rel_diff": [
                    abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                    for a, b in zip(first2.series, ref_first.series)],
                "running_stats_after_iteration_rel": max(
                    float((v.cpu().double() - ref_trainer.network.state_dict()[k]
                           .cpu().double()).abs().max()) / max(after[k]["ref_max"], 1e-30)
                    for k, v in again.network.state_dict().items() if "running" in k)}
            log(f"  {name}, 1 rank run again against its first run (the "
                f"card's own spread): {res['one_rank_again']}")
            del again
        del ref_trainer
        return recs, res, cfg

    # The flat CNN as config/default.yaml runs it (bf16): its first step held.
    recs, out["flat_cnn"], _ = flat_cnn("flat_cnn", "bfloat16", PARALLEL_BN_TOL)
    report["parallel_cnn"] = {"launches": launches_of(recs)}
    # In float32 without TF32 its whole iteration is held: the first
    # rollout equal, the first step's running statistics and the first
    # minibatch's losses tight, the running statistics after the iteration
    # and the update's losses within the card's own run-to-run spread.
    _, res, _ = flat_cnn("flat_cnn_float32", "float32", PARALLEL_F32_BN_FIRST_TOL,
                         exact=True, again=True)
    out["flat_cnn_float32"] = res | {"tolerances": {
        "bn_first_step": PARALLEL_F32_BN_FIRST_TOL,
        "first_minibatch": [PARALLEL_F32_FIRST_RTOL, PARALLEL_F32_FIRST_ATOL],
        "bn_after_iteration": PARALLEL_F32_BN_TOL,
        "update_losses": [PARALLEL_F32_LOSS_RTOL, PARALLEL_F32_LOSS_ATOL]}}
    bad = [k for k, (a, b, d) in res["first_minibatch_losses"].items()
           if not d <= PARALLEL_F32_FIRST_ATOL + PARALLEL_F32_FIRST_RTOL * abs(b)]
    if bad:
        failures.append(f"flat CNN (float32): the first minibatch's losses beyond "
                        f"tolerance: {bad}")
    exact = res["first_iteration_rollout"]
    if any(a != b for a, b in exact.values()):
        failures.append(f"flat CNN (float32): first rollout's statistics differ: {exact}")
    bad = [k for k, v in res["running_stats_after_iteration"].items()
           if not v["max_abs_err"] <= PARALLEL_F32_BN_TOL * v["ref_max"]]
    if bad:
        failures.append(f"flat CNN (float32): running statistics after the iteration "
                        f"beyond tolerance: {bad}")
    bad = [k for k, (a, b, d) in res["update_losses"].items()
           if not d <= PARALLEL_F32_LOSS_ATOL + PARALLEL_F32_LOSS_RTOL * abs(b)]
    if bad:
        failures.append(f"flat CNN (float32): the update's losses beyond tolerance: {bad}")

    # config/run8.yaml (Q-soft search distillation on the flat CNN, top-16,
    # 512 envs) at full width for one iteration: in float32 without TF32
    # the first rollout, its search rows included, equal to 1 rank's; in
    # bf16 the first step's running statistics held and the rollout
    # statistics reported beside 1 rank's; the bf16 run's 2-rank `final`
    # resumed on 1 rank.
    _, res, _ = flat_cnn("run8_float32", "float32", PARALLEL_F32_BN_FIRST_TOL, exact=True,
                         ppo=RUN8_PPO, training=RUN8_TRAINING, network=RUN8_NETWORK,
                         path_name="parallel_run8")
    out["run8_float32"] = res
    search = res["first_rollout_search"]
    if search["equal"]:
        # No near-tie swapped: the whole first rollout is held.
        exact = res["first_iteration_rollout"]
        if any(a != b for a, b in exact.values()):
            failures.append(f"run8 (float32): first rollout's statistics differ: {exact}")
        bad = [k for k, (a, b, d) in res["first_minibatch_losses"].items()
               if not d <= PARALLEL_F32_FIRST_ATOL + PARALLEL_F32_FIRST_RTOL * abs(b)]
        if bad:
            failures.append(f"run8 (float32): the first minibatch's losses beyond "
                            f"tolerance: {bad}")
    elif not search.get("explained"):
        # Every step before the first lane apart is equal by construction;
        # a lane apart must be a near-tie the rounding explains.  After it
        # the trajectories part: reported, not held.
        failures.append(f"run8 (float32): the first rollout's search parts where no "
                        f"near-tie explains it: {search}")
    recs, res, cfg8 = flat_cnn("run8", "bfloat16", PARALLEL_BN_TOL, ppo=RUN8_PPO,
                               training=RUN8_TRAINING, network=RUN8_NETWORK,
                               path_name="parallel_run8")
    report["parallel_run8"] = {"launches": launches_of(recs)}
    out["run8"] = res
    resumed = PPOTrainer(cfg8, seed=999, device=device)
    resumed.load(os.path.join(cfg8["paths"]["checkpoint_dir"], "final"))
    step0 = resumed.global_step
    m = {k: float(v) for k, v in resumed.iterate().items()}
    res["resumed_on_one_rank"] = {"from_step": step0, "metrics": m}
    log(f"  run8: the 2-rank final resumed on 1 rank at step {step0}: one iteration, "
        f"finite: {all(math.isfinite(v) for v in m.values())}, bc_loss {m['bc_loss']:.6g}, "
        f"search_frac {m['search_frac']:.6g}")
    losses = [v for r in recs for it in r["metrics"] for v in it.values()]
    if not all(math.isfinite(v) for v in losses + list(m.values())):
        failures.append("run8: a metric of the 2-rank run or the resumed one is not finite")
    if step0 != RUN8_TRAINING["num_envs"] * RUN8_TRAINING["rollout_steps"] or \
            not recs[0]["metrics"][0]["bc_loss"] > 0.0:
        failures.append(f"run8: resumed at step {step0}; the 2-rank iteration "
                        f"{recs[0]['metrics'][0]}")
    del resumed

    # K7 at a lane base and at the search's tiled base, into the kernels
    # line's K7 row.
    for width, key in ((1, "rank_shard_256_lanes_base_256"),
                       (SEARCH_TOPK, "rank_search_shard_4096_lanes_base_4096")):
        case = with_bound(k7_lane_base_case(device, width))
        out[f"k7_lane_base_width_{width}"] = case
        for row in report.get("kernels", []):
            if row["name"] == "regen_pieces":
                row.setdefault("at_other_shapes", {})[key] = case
        log(f"  K7 at lane base {case['lane_base']} ({case['lanes']} lanes, {width} "
            f"a fleet lane): equal={case['equal']}, {case['ms']:.4f} ms (device "
            f"{case['device_ms']}); the whole {2 * case['lanes']} lanes "
            f"{case['whole_ms']:.4f} ms; plain {case['plain_ms']:.3f} ms")
        if not case["equal"]:
            failures.append(f"K7 at lane base {case['lane_base']} differs from its "
                            f"plain version")

    # A 1-rank nccl group and one all-reduce through the gradient path.
    nccl = nccl_allreduce_case(device)
    out["nccl"] = nccl
    log(f"  nccl, 1 rank: all-reduce of {nccl['elements']:,} gradient elements "
        f"{nccl['ms']} ms, gradients unchanged: {nccl['equal']}")
    if not nccl["equal"] or nccl["backend"] != "nccl":
        failures.append(f"nccl all-reduce: {nccl}")
    log("  (two ranks share one card here: these times are no scaling number)")
    if failures:
        raise AssertionError("; ".join(failures))


def gui_phase(device, report):
    """Phase 16: the GUI's workers on the card.  `TrainingRunner` on run9's
    network at phase 14's small fleet, stopped by its callback after
    GUI_ROWS rows, `final` written; `watch_frames` for GUI_MOVES moves of
    phase 5's seeded run9 network from a checkpoint, move for move equal to
    `PolicyAgent` on `BlockBlastEnv`.  The launch counters are set to 0
    before each and read after."""
    import queue

    import torch

    from bbx_torch.agent.policy_agent import PolicyAgent
    from bbx_torch.env.single import BlockBlastEnv
    from bbx_torch.gui import workers
    from bbx_torch.models import network_from_config
    from bbx_torch.utils.checkpoints import checkpoint_exists, save_checkpoint

    work = os.path.join(ROOT, "build", "chip_smoke_gui")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counters = kernel_counters()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    failures = []
    cfg = {"ppo": RUN9_PPO, "network": RUN9_NETWORK, "rewards": RUN9_REWARDS,
           "training": dict(RUN9_TRAINING, **PROFILE_TRAINING),
           "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0},
           "paths": {"checkpoint_dir": os.path.join(work, "checkpoints"),
                     "log_dir": os.path.join(work, "logs")}}
    class StopAfterRows(workers.TrainingRunner):
        """The runner, stopped from its callback after GUI_ROWS rows."""

        rows = 0

        def callback(self, row):
            self.rows += 1
            if self.rows >= GUI_ROWS:
                self.stop()
            return super().callback(row)

    events = queue.Queue()
    runner = StopAfterRows(cfg, events, device=device, seed=TRAIN_SEED)
    zero()
    t0 = time.perf_counter()
    stats = runner.run()
    seconds = time.perf_counter() - t0
    tags = []
    while not events.empty():
        tags.append(events.get_nowait()[0])
    final = checkpoint_exists(os.path.join(cfg["paths"]["checkpoint_dir"], "final"))
    report["gui_train"] = {"launches": launches(), "rows": runner.rows, "stats": stats,
                           "final_written": final, "seconds": seconds,
                           "events": {t: tags.count(t) for t in set(tags)}}
    per_iter = PROFILE_TRAINING["num_envs"] * PROFILE_TRAINING["rollout_steps"]
    log(f"  training runner: {runner.rows} rows, stopped at step "
        f"{stats and stats['global_step']}, final written {final}, {seconds:.1f} s")
    if stats is None or runner.rows != GUI_ROWS or not final \
            or stats["global_step"] != GUI_ROWS * per_iter:
        failures.append(f"training runner: {report['gui_train']}")

    net = network_from_config(RUN9_NETWORK, generator=torch.Generator().manual_seed(SEED))
    ckpt = save_checkpoint(work, "run9_seeded.pt", {"params": net.state_dict()},
                           config={"network": RUN9_NETWORK})
    # Games seeded SEED + 1, SEED + 2, ... as the watch page plays them,
    # until GUI_MOVES moves; each replayed by `PolicyAgent` on the env.
    zero()
    agent = PolicyAgent.from_checkpoint(ckpt, device=device)
    t0 = time.perf_counter()
    games = []
    while sum(len(g) for g in games) < GUI_MOVES:
        left = GUI_MOVES - sum(len(g) for g in games)
        games.append(list(workers.watch_frames(agent, seed=SEED + len(games) + 1,
                                               game=len(games) + 1, max_moves=left,
                                               device=device)))
    seconds = time.perf_counter() - t0
    watch_launches = launches()
    ref = PolicyAgent.from_checkpoint(ckpt, device=device)
    apart = []
    for g, frames in enumerate(games, start=1):
        env = BlockBlastEnv(seed=SEED + g, device=device)
        obs, _ = env.reset(seed=SEED + g)
        for i, frame in enumerate(frames):
            action, _ = ref.select_action(obs, deterministic=True)
            obs, _, done, _, info = env.step(action)
            if frame["action"] != action or frame["score"] != info["score"] \
                    or not (frame["board"] == obs["board"]).all():
                apart.append((g, i))
    moves = sum(len(g) for g in games)
    report["gui_watch"] = {"launches": watch_launches, "moves": moves, "games": len(games),
                           "moves_apart": apart, "ms_a_move": 1e3 * seconds / max(1, moves),
                           "scores": [g[-1]["score"] for g in games if g]}
    log(f"  watch loop: {moves} moves in {len(games)} games, "
        f"{report['gui_watch']['ms_a_move']:.2f} ms a move, equal to PolicyAgent on "
        f"BlockBlastEnv move for move: {not apart}")
    if apart or moves != GUI_MOVES:
        failures.append(f"watch loop: moves apart {apart}, {moves} moves")
    for path in ("gui_train", "gui_watch"):
        try:
            check_launches(path, report[path]["launches"])
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("; ".join(failures))


# Phase 17: the launchers.  `bbx-torch-stable-train` at its recipe (32
# envs x 64 steps) for STABLE_ITERATIONS iterations, then resumed for one
# more; `bbx-torch-quick-bench` QUICK_BENCH_RUNS times.
STABLE_ITERATIONS = 2
QUICK_BENCH_RUNS = 3


def launchers_phase(device, report):
    """Phase 17: the two launchers through their `main` (the console
    scripts' entry points), on their default device, with the launch
    counters set to 0 before and read after each: `bbx-torch-stable-train`
    in a fresh directory under build/ for STABLE_ITERATIONS iterations,
    then with one more iteration's steps, which must resume from its
    checkpoint; and `bbx-torch-quick-bench` QUICK_BENCH_RUNS times, each
    run's exit code (0 PASS, 1 FAIL, 2 no steady measurement) and rate.
    The phase fails on a FAIL, or when no run measured steadily."""
    import io

    import torch

    from bbx_torch.cli import quick_bench as QB
    from bbx_torch.cli import stable_train as STR

    out = report.setdefault("launchers", {})
    work = os.path.join(ROOT, "build", "chip_smoke_launchers")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counters = kernel_counters()
    trainers, measured = [], []
    trainer0, bench0 = STR.PPOTrainer, QB.bench_engine

    class Seen(trainer0):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    def bench(*args, **kwargs):
        try:
            r = bench0(*args, **kwargs)
        except Exception as e:
            measured.append(getattr(e, "result", {"error": str(e)}))
            raise
        measured.append(r)
        return r

    def run(fn, argv):
        for c in counters.values():
            c.launches = 0
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = fn(argv)
        torch.cuda.synchronize()
        return {"rc": rc, "seconds": time.perf_counter() - t0, "stdout": text.getvalue(),
                "launches": {k: c.launches for k, c in counters.items()}}

    per_iter = STR.recipe(32)["training"]["rollout_steps"] * 32
    cwd = os.getcwd()
    STR.PPOTrainer, QB.bench_engine = Seen, bench
    try:
        os.chdir(work)
        first = run(STR.main, ["--steps", str(STABLE_ITERATIONS * per_iter)])
        again = run(STR.main, ["--steps", str((STABLE_ITERATIONS + 1) * per_iter)])
        benches = []
        for _ in range(QUICK_BENCH_RUNS):
            del measured[:]
            r = run(QB.main, [])
            r["measurements"] = list(measured)
            benches.append(r)
    finally:
        os.chdir(cwd)
        STR.PPOTrainer, QB.bench_engine = trainer0, bench0
    devices = sorted({str(t.device) for t in trainers})
    launches = {k: first["launches"][k] + again["launches"][k] for k in counters}
    out["stable_train"] = {"runs": [first, again], "devices": devices,
                           "steps": [t.global_step for t in trainers]}
    report["stable_train"] = {"launches": launches}
    for name, r in (("first", first), ("resumed", again)):
        log(f"  stable_train ({name}): rc {r['rc']}, {r['seconds']:.2f} s: "
            + " | ".join(r["stdout"].strip().splitlines()))
    log(f"  stable_train: trainers on {devices}, at steps {out['stable_train']['steps']}; "
        f"launches {launches}")
    bench_launches = {k: sum(b["launches"][k] for b in benches) for k in counters}
    report["quick_bench"] = {"launches": bench_launches}
    out["quick_bench"] = {"runs": benches, "gate": QB.GATE_ENV_STEPS_PER_SEC,
                          "rates": [b["measurements"][-1].get("env_steps_per_sec")
                                    for b in benches if b["measurements"]]}
    for i, b in enumerate(benches):
        log(f"  quick_bench run {i + 1}: rc {b['rc']} ({b['seconds']:.2f} s): "
            + " | ".join(b["stdout"].strip().splitlines()))
    log(f"  quick_bench: rates {out['quick_bench']['rates']} against the gate "
        f"{QB.GATE_ENV_STEPS_PER_SEC:,}; launches {bench_launches}")

    failures = []
    if first["rc"] or again["rc"] or not trainers or any(
            t.device.type != "cuda" for t in trainers):
        failures.append(f"stable_train: rc {first['rc']}, {again['rc']}, devices {devices}")
    resumed = f"resumed quick_trained at step {STABLE_ITERATIONS * per_iter:,}"
    if resumed not in again["stdout"] or \
            trainers[-1].global_step != (STABLE_ITERATIONS + 1) * per_iter:
        failures.append("stable_train did not resume its checkpoint")
    for path, got in (("stable_train", launches), ("quick_bench", bench_launches)):
        try:
            check_launches(path, got)
        except AssertionError as e:
            failures.append(str(e))
    codes = [b["rc"] for b in benches]
    if 1 in codes or all(c == 2 for c in codes):
        failures.append(f"quick_bench exit codes {codes} (1: FAIL, 2: no steady "
                        f"measurement)")
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    import torch

    if len(sys.argv) in (5, 6) and sys.argv[1] == "--parallel-rank":
        return parallel_rank(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                             exact=sys.argv[5:] == ["exact"])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from bbx_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the bbx_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    report = {"device": torch.cuda.get_device_name(0)}
    failed = []

    def phase(name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"   ({time.perf_counter() - t0:.1f} s)")

    def identify():
        report["nvidia_smi"] = nvidia_smi()
        log(f"  {report['nvidia_smi']} | torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {report['device']}")

    def build_kernels():
        info = build.build_all()
        report["build_seconds"] = info["seconds"]
        log(f"  built in {info['seconds']:.1f} s into {build.build_dir()}")
        for name, text in info["ptxas"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  [{name}] {line.strip()}")

    phase("1. card", identify)
    phase("2. build", build_kernels)
    if "2. build" not in failed:
        phase("3. kernels vs plain versions", lambda: kernel_phase(device, report))
        # The engine path first: its fleet loop is host-bound, and the
        # process's first minutes, before the training phases load the
        # host, time it most steadily.
        phase("4. engine path: random-policy fleet",
              lambda: engine_phase(device, report))
        phase("5. eval path: greedy eval", lambda: eval_phase(device, report))
        phase("6. reference checks", lambda: reference_phase(device, report))
        phase("7. profile of an eval step", lambda: profile_phase(device, report))
        phase("8. train path: PPO at run9 width",
              lambda: train_phase(device, report))
        phase("9. update card vs CPU", lambda: update_reference_phase(device, report))
        phase("10. profile of a training iteration",
              lambda: train_profile_phase(device, report))
        phase("11. flat CNN: forward card vs CPU, network and train benchmarks",
              lambda: flat_cnn_phase(device, report))
        phase("12. search eval: policy+1-ply search at run9 width",
              lambda: search_eval_phase(device, report))
        phase("13. distillation: run8 at full width",
              lambda: distill_phase(device, report))
        phase("14. the host API: single env, play, watch, --env, --render, --profile",
              lambda: host_api_phase(device, report))
        phase("15. two ranks on the one card: run9 and the flat CNN, K7 at a lane "
              "base, nccl", lambda: parallel_phase(device, report))
        phase("16. the GUI's workers: training runner and watch loop",
              lambda: gui_phase(device, report))
        phase("17. the launchers: bbx-torch-stable-train and bbx-torch-quick-bench",
              lambda: launchers_phase(device, report))

    # `launches` sums the paths' runs; `launches_by_path` splits them.
    kernels = []
    by_path = {p: report.get(p, report.get("host_api", {}).get(p, {})).get("launches", {})
               for p in PATH_KERNELS}
    for r in report.get("kernels", []):
        if r["name"] == "evaluator_scores" and "evaluator_layouts" in report:
            # K8's library time: cuDNN's channels-last evaluator forward at
            # M = 512 x 192 (phase 10), measured in turns with K8.
            r["evaluator_layouts"] = report["evaluator_layouts"]
            r["library_ms"] = report["evaluator_layouts"]["channels_last"]["forward_ms"]
            r["at_update_shape"]["library_ms"] = (
                report["evaluator_layouts"]["channels_last"]["forward_2048_ms"])
        # K4 and K8 at one lane (phase 14: the single env's and watch's shape).
        r.get("at_other_shapes", {}).update(
            report.get("host_api", {}).get("one_lane", {}).get(r["name"], {}))
        split = {p: sum(c.get(name, 0) for name in ROW_COUNTERS[r["name"]])
                 for p, c in by_path.items()}
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": sum(split.values()), "launches_by_path": split} | {
                k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "shape")} | {
                k: r[k] for k in ("device_ms", "host_us", "launches_a_call", "bound_flops_ms",
                                  "bound_bytes_ms",
                                  "entry_points", "step", "at_update_shape",
                                  "at_engine_shape", "at_other_shapes", "at_search_shapes",
                                  "evaluator_layouts",
                                  "device_ms_by_kernel", "whole")
                if k in r})
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_report.json"), "w") as f:
        json.dump(report | {"failed": failed}, f, indent=2)
    if failed or len(kernels) != len(ROW_COUNTERS):
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(report["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
