#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bbx_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise):

1. identify the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels K1-K6 from `bbx_torch/csrc/` with nvcc;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (outputs must be exactly equal; K5's floats too, to
   the last bit; K4 at the rollout's 512 lanes and at the update's 2048),
   on reachable mid-game boards made by the port's own engine from a
   seed, and time both with CUDA events;
4. the eval path: a 512-episode greedy eval of a seeded, freshly
   initialised AfterstateNetwork at the widths of `config/run9.yaml`
   (bf16) through `bbx_torch.cli.evaluate.main`, with every kernel's
   launch counter set to 0 before and read after;
5. check the results: finite statistics over 512 completed episodes, the
   float32 forward on the card against the same forward on the CPU, and
   seeded games of `ParityEngine` on the card against the CPU, move for
   move;
6. profile the first 16 steps of the eval loop (host time of the forward
   and of the step, device time by kernel, the device's busy share);
7. the train path: run9's PPO recipe at full width and shape (512 envs x
   128 steps, minibatch 2048, 2 epochs) for 3 iterations through
   `bbx_torch.cli.train.main` from a JSON config, with the launch
   counters set to 0 before and read after, each iteration's rollout and
   update timed and its losses checked finite; then `latest` is loaded and
   one more iteration must be finite;
8. one float32 PPO update at run9 widths on a fixed batch, card against
   CPU (losses and post-Adam parameters);
9. profile a 16-step rollout and a 4-minibatch update at run9 widths
   (device time by kernel, the device's busy share in each).

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernels' numbers, and
``{"ok": true, "device": {...}}``; the full report goes to
``build/chip_smoke_report.json``.  With no CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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
GAE_T, GAE_N = 128, 512   # K5 at run9's rollout shape
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
RUN9_REWARDS = {
    "line_clear_base": 1.0,
    "block_placed": 0.01,
    "game_over_penalty": -1.0,
    "hole_penalty": -0.05,
    "center_bonus": 0.02,
    "combo_multiplier_bonus": 0.5,
    "survival_bonus": 0.001,
}

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, used as the ceiling for the
# kernels' 32-bit integer and bit operations (a 64-bit operation counts 2).
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
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
    from bbx_torch.engine.tables import tables
    from bbx_torch.models import afterstate as A

    state, obs, bits, ids = midgame_boards(device)
    tb = tables(device)
    rows = []

    # K1 at K = 512 lanes x 3 slots.
    b1, i1 = bits[:K1_LANES].contiguous(), ids[:K1_LANES].contiguous()
    got, want = S.valid3_bits(b1, i1), S.valid3_bits_plain(b1, i1)
    k = K1_LANES
    rows.append(dict(
        name="valid3_bits", source="bbx_torch/csrc/valid3.cu",
        replaces="bbx/engine/solvability.py:163 (valid3_bits; piece_fit_words :133)",
        equal=torch.equal(got, want), max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: S.valid3_bits(b1, i1)),
        plain_ms=time_ms(lambda: S.valid3_bits_plain(b1, i1)),
        nbytes=k * 16 + k * 12 + k * 192 + 37 * 9 * 4 + 37 * 8,
        ops=3 * k * 40, shape=f"bits [{k},2], ids [{k},3] -> [{k},3,64]"))

    # K2 on all FLEET lanes.
    v3 = S.valid3_bits_plain(bits, ids)
    got = S.solvable_disjoint_bits(bits, ids, v3)
    want = S.solvable_disjoint_bits_plain(bits, ids, v3)
    pid = ids.long()
    m01 = S.unpack_cells(tb.NO_CONFLICT_BITS[pid[:, 0], pid[:, 1]]
                         & S.pack_cells(v3[:, 1])[:, None, :])
    or_steps = int((m01 & v3[:, 0, :, None]).sum().item())
    k = FLEET
    rows.append(dict(
        name="solvable_disjoint_bits", source="bbx_torch/csrc/solvable_disjoint.cu",
        replaces="bbx/engine/solvability.py:180 (solvable_disjoint_bits)",
        equal=torch.equal(got, want), max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: S.solvable_disjoint_bits(bits, ids, v3)),
        plain_ms=time_ms(lambda: S.solvable_disjoint_bits_plain(bits, ids, v3)),
        # valid3 + ids read, the 700 KB table once, one bool out; an OR step
        # (OR, lowest bit, clear lowest) per (valid a0, a1) pair.
        nbytes=k * 192 + k * 12 + 37 * 37 * 64 * 8 + k,
        ops=or_steps * 8 + k * 64 * 16,
        shape=f"ids [{k},3], valid3 [{k},3,64] -> [{k}]"))
    fast = want

    # K3 on the lanes the disjoint tier leaves (what regen gives it).
    rest = (~fast).nonzero().squeeze(1)
    rb, ri, rv = bits[rest].contiguous(), ids[rest].contiguous(), v3[rest].contiguous()
    got = S.solvable_exact_bits(rb, ri, rv)
    want = S.solvable_exact_bits_plain(rb, ri, rv)
    got_all = S.solvable_exact_bits(bits, ids, v3)
    want_all = S.solvable_exact_bits_plain(bits, ids, v3)
    k = rest.numel()
    rows.append(dict(
        name="solvable_exact_bits", source="bbx_torch/csrc/solvable_exact.cu",
        replaces="bbx/engine/solvability.py:235 (solvable_exact_bits; _clear_lines_words :214)",
        equal=torch.equal(got, want) and torch.equal(got_all, want_all),
        max_abs_err=max(max_abs_err(got, want), max_abs_err(got_all, want_all)),
        ms=time_ms(lambda: S.solvable_exact_bits(rb, ri, rv)),
        plain_ms=time_ms(lambda: S.solvable_exact_bits_plain(rb, ri, rv), reps=5, inner=2),
        nbytes=k * (16 + 12 + 192 + 1) + 37 * 64 * 8 + 37 * 9 * 4 + 37 * 8,
        ops=exact_ops(rb, ri, rv, want),
        shape=f"bits [{k},2], ids [{k},3], valid3 [{k},3,64] -> [{k}] "
              f"(the {k} of {FLEET} draws the disjoint tier leaves)"))

    # K4 at the rollout's B = 512 (observations) and at the update's
    # B = 2048 (planes rebuilt from the compact buffer by the update's own
    # `_minibatch_obs`, used slots zeroed): both exactly equal.
    from bbx_torch.agent import ppo as P

    def k4_row(bd, pc):
        got, want = A.afterstate_buffer(bd, pc), A.afterstate_buffer_plain(bd, pc)
        b = bd.shape[0]
        return dict(
            equal=all(torch.equal(x, y) for x, y in zip(got, want)),
            max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
            ms=time_ms(lambda: A.afterstate_buffer(bd, pc)),
            plain_ms=time_ms(lambda: A.afterstate_buffer_plain(bd, pc)),
            nbytes=b * 256 + b * 768 + b * 192 * (2 * 64 * 4 + 4 + 1),
            ops=b * 192 * 2 * 64)

    b = K4_LANES
    row = k4_row(obs["board"][:b].contiguous(), obs["pieces"][:b].contiguous())
    b2 = RUN9_TRAINING["batch_size"]
    mb = P._minibatch_obs({"board": state.board[:b2], "mask": obs["action_mask"][:b2],
                           "piece_ids": state.piece_ids[:b2].to(torch.int8),
                           "used": state.used[:b2]})
    at_update = k4_row(mb["board"].contiguous(), mb["pieces"].contiguous())
    at_update["bound_ms"], at_update["bound_by"] = bound_ms(
        at_update.pop("nbytes"), at_update.pop("ops"))
    at_update["lanes"] = b2
    row.update(
        name="afterstate_buffer", source="bbx_torch/csrc/afterstate.cu",
        replaces="bbx/models/afterstate.py:52 (afterstate_planes)",
        equal=row["equal"] and at_update["equal"],
        max_abs_err=max(row["max_abs_err"], at_update["max_abs_err"]),
        at_update_shape=at_update,
        shape=f"board [{b},8,8], pieces [{b},3,8,8] -> planes [{b},192,2,8,8], "
              f"lines, overlap; also at the update's B = {b2} "
              f"(equal={at_update['equal']}, {at_update['ms']:.4f} ms, plain "
              f"{at_update['plain_ms']:.4f} ms, bound {at_update['bound_ms']:.6f} ms)")
    rows.append(row)
    # K5 at run9's rollout shape: seeded rewards / values, ~2% dones.
    g = torch.Generator(device=device).manual_seed(SEED)
    t, n = GAE_T, GAE_N
    gae_in = (torch.randn((t, n), generator=g, device=device),
              torch.rand((t, n), generator=g, device=device) < 0.02,
              torch.randn((t, n), generator=g, device=device),
              torch.randn(n, generator=g, device=device))
    cfg = P.PPOConfig(gamma=RUN9_PPO["gamma"], gae_lambda=RUN9_PPO["gae_lambda"])
    got = P.compute_gae(cfg, *gae_in)
    want = P.compute_gae_plain(cfg, *gae_in)
    rows.append(dict(
        name="compute_gae", source="bbx_torch/csrc/gae.cu",
        replaces="bbx/agent/ppo.py:354 (compute_gae)",
        equal=all(torch.equal(x, y) for x, y in zip(got, want)),
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
        ms=time_ms(lambda: P.compute_gae(cfg, *gae_in)),
        plain_ms=time_ms(lambda: P.compute_gae_plain(cfg, *gae_in), reps=5, inner=2),
        # rewards, dones, values read, adv and ret written; 8 flops a step.
        nbytes=t * n * (4 + 1 + 4 + 4 + 4) + n * 4, ops=t * n * 8,
        shape=f"rewards, dones, values [{t},{n}], last_value [{n}] -> adv, ret "
              f"[{t},{n}] (equal bit for bit)"))

    # K6 on reachable boards with some slots used, some lanes done, streaks,
    # and actions that are valid (3 in 4) or random: checked on all FLEET
    # lanes, timed at the main paths' 512 lanes (and at FLEET).
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
    acts = acts.to(torch.int32)
    got = ST._move_core(mv_state, acts)
    want = ST._move_core_plain(mv_state, acts)
    equal = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    ms_fleet = time_ms(lambda: ST._move_core(mv_state, acts))
    n = K6_LANES
    sub = mv_state.replace(**{f: getattr(mv_state, f)[:n].contiguous() for f in (
        "board", "piece_ids", "used", "score", "streak", "moves", "lines_total",
        "max_streak", "blocks_total", "done", "prev_holes", "prev_center",
        "ep_return", "ep_len")})
    sub_acts = acts[:n].contiguous()
    got = ST._move_core(sub, sub_acts)
    want = ST._move_core_plain(sub, sub_acts)
    rows.append(dict(
        name="_move_core", source="bbx_torch/csrc/move.cu",
        replaces="bbx/engine/step.py:89 (_move_core; count_holes, "
                 "center_openness, total_blocks of bbx/engine/kernel.py:135,163,187)",
        equal=equal and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(got, want)),
        max_abs_err=max(err, max(max_abs_err(x, y) for x, y in zip(got, want))),
        ms=time_ms(lambda: ST._move_core(sub, sub_acts)),
        plain_ms=time_ms(lambda: ST._move_core_plain(sub, sub_acts)),
        ms_at_fleet=ms_fleet,
        # board, ids, used, done, streak, action read (88 B); board, ten
        # int32, two bools, used, centre written (113 B); the tables once;
        # about 100 64-bit operations a lane.
        nbytes=n * (88 + 113) + 37 * 64 * 8 + 37 * 8 + 37 * 4, ops=n * 200,
        shape=f"board [{n},8,8] u8, ids/used [{n},3], done/streak/action [{n}] "
              f"-> the 15 outputs ({int(want[0].sum())} valid moves, "
              f"{int((want[4] > 0).sum())} clearing); also checked on all {k} "
              f"lanes, where a call took {ms_fleet:.4f} ms"))

    for r in rows:
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("nbytes"), r.pop("ops"))
        r["route"] = "cuda"
        r["library_ms"] = None
        log(f"  {r['name']}: equal to plain (exact)={r['equal']}, kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}); {r['shape']}")
    report["kernels"] = rows
    bad = [r["name"] for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"kernel != plain version: {bad}")


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


def eval_phase(device, report):
    """Phase 4: the main path through the eval entry point."""
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
    # Every kernel but GAE runs when the eval plays.
    missing = [n for n, c in launches.items() if c <= 0 and n != "compute_gae"]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: {missing}")


def kernel_counters():
    """Each kernel's wrapper (whose ``launches`` counts its launches), by
    the name the kernels line gives it."""
    from bbx_torch.agent import ppo as P
    from bbx_torch.engine import solvability as S
    from bbx_torch.engine import step as ST
    from bbx_torch.models import afterstate as A

    return {"valid3_bits": S.valid3_bits,
            "solvable_disjoint_bits": S.solvable_disjoint_bits,
            "solvable_exact_bits": S.solvable_exact_bits,
            "afterstate_buffer": A.afterstate_buffer,
            "compute_gae": P.compute_gae,
            "_move_core": ST._move_core}


def reference_phase(device, report):
    """Phase 5: the card against the CPU on small inputs."""
    import numpy as np
    import torch

    from bbx_torch.device import float32_exact
    from bbx_torch.engine.parity import ParityEngine
    from bbx_torch.engine.state import make_generator, reset
    from bbx_torch.engine.step import observe
    from bbx_torch.models import network_from_config

    # float32 forward at run9 widths, card vs CPU, with TF32 off.
    cfg = dict(RUN9_NETWORK, compute_dtype="float32")
    net = network_from_config(cfg, generator=torch.Generator().manual_seed(SEED))
    state = reset(8, make_generator(SEED, "cpu"), "cpu")
    obs = observe(state)
    with float32_exact(), torch.inference_mode():
        l_cpu, v_cpu = net(obs["board"], obs["pieces"], obs["action_mask"])
        net_gpu = net.to(device)
        l_gpu, v_gpu = net_gpu(*(obs[k].to(device) for k in
                                 ("board", "pieces", "action_mask")))
    l_gpu, v_gpu = l_gpu.cpu(), v_gpu.cpu()
    mask = obs["action_mask"]
    fwd_err = max(max_abs_err(l_gpu[mask], l_cpu[mask]), max_abs_err(v_gpu, v_cpu))
    fwd_ok = (fwd_err <= 1e-4 and torch.equal(l_gpu[~mask], l_cpu[~mask])
              and torch.isfinite(l_gpu).all().item())

    # Three seeded games, card vs CPU, move for move (exact).
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
    report["reference"] = {"forward_f32_max_abs_err": fwd_err,
                           "forward_ok": fwd_ok, "game_moves": n_moves,
                           "game_ok": game_ok}
    log(f"  forward f32 card vs cpu: max abs err {fwd_err:.3e} (limit 1e-4), "
        f"ok={fwd_ok}; 3 seeded games card vs cpu: {n_moves} moves, equal={game_ok}")
    if not (fwd_ok and game_ok):
        raise AssertionError("card disagrees with the CPU reference")


def device_ms_by_kernel(prof):
    """{kernel name: (device ms, calls)} of a `torch.profiler` run."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def profile_phase(device, report):
    """Phase 6: where the time of an eval step goes.  The first 16 steps of
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
    report["profile"] = prof_out
    log(f"  per step (host clock, synchronised): forward {prof_out['host_ms_per_step_forward']:.3f} ms, "
        f"step {prof_out['host_ms_per_step_step']:.3f} ms; profiled: wall "
        f"{prof_out['profiled_wall_ms_per_step']:.3f} ms, device {prof_out['device_ms_per_step']}"
        f" ms, busy share {prof_out['device_busy_share']}")
    for row in prof_out["top_device_kernels"]:
        log(f"    {row['ms_per_step']:.4f} ms/step  x{row['calls_per_step']:.2f}  {row['name']}")


def train_phase(device, report):
    """Phase 7: the train path through the train entry point, at run9's
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

    counters = kernel_counters()
    k4 = counters["afterstate_buffer"]
    iters, stats = [], {}
    rollout0, update0, train0 = P.rollout, P.update, cli_train.train

    def timed_rollout(*args, **kwargs):
        before = k4.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout0(*args, **kwargs)
        torch.cuda.synchronize()
        iters.append({"rollout_s": time.perf_counter() - t0,
                      "afterstate_launches_rollout": k4.launches - before})
        return out

    def timed_update(*args, **kwargs):
        before = k4.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = update0(*args, **kwargs)
        torch.cuda.synchronize()
        iters[-1].update(update_s=time.perf_counter() - t0,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                         afterstate_launches_update=k4.launches - before,
                         metrics={k: float(v) for k, v in metrics.items()})
        return metrics

    def captured_train(*args, **kwargs):
        out = train0(*args, **kwargs)
        stats.update({k: v for k, v in out.items() if k != "trainer"})
        return out

    P.rollout, P.update, cli_train.train = timed_rollout, timed_update, captured_train
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

    for i, r in enumerate(iters):
        log(f"  iteration {i + 1}: rollout {r['rollout_s']:.3f} s, update "
            f"{r['update_s']:.3f} s, update peak memory {r['peak_memory_gb']:.3f} GB, "
            f"K4 launches {r['afterstate_launches_rollout']} (rollout) + "
            f"{r['afterstate_launches_update']} (update); "
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
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    if launches["compute_gae"] != 3 or not all(
            r["afterstate_launches_rollout"] > 0 and r["afterstate_launches_update"] > 0
            for r in iters):
        raise AssertionError("GAE or the afterstate kernel missed an iteration")
    if resumed_from != TRAIN_TIMESTEPS:
        raise AssertionError(f"latest holds step {resumed_from}")


def train_profile_phase(device, report):
    """Phase 9: where the time of a training iteration goes.  Under
    `torch.profiler`, after a warm-up of each: a rollout of 16 steps at
    512 lanes and an update of one epoch of 4 minibatches of 2048, both at
    run9 widths (bf16) from a seeded network.  Reports each window's host
    wall time, device time, busy share and top kernels; a profiler that
    records no device time is reported as "not measured"."""
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profiled(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return result, wall, device_ms_by_kernel(prof)

    (traj, last_value), wall_r, kernels_r = profiled(rollout)
    _, wall_u, kernels_u = profiled(lambda: update(traj, last_value))
    out = {}
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


def update_reference_phase(device, report):
    """Phase 8: one float32 PPO update at run9 widths (TF32 off) on a fixed
    batch of T = 4 x N = 64 transitions, one epoch of one minibatch, from
    the same params on the card and on the CPU.  The stored log-probs are
    drawn from [-6, -2] so that ratios spread and clipping is exercised.
    Continuous metrics must agree within 1e-4 relative, the clip fraction
    within one sample (1/256), the post-Adam params within 1e-6 + 1e-3 x
    lr (Adam's step is about lr per element; the grads differ only by
    summation order)."""
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
    res = {}
    for dev in ("cpu", device):
        net_d = copy.deepcopy(net).to(dev)
        ts = P.TrainState(net_d, P.make_optimizer(cfg, net_d))
        with float32_exact():
            metrics = P.update(cfg, ts, {k: v.to(dev) for k, v in traj.items()},
                               adv.to(dev), ret.to(dev),
                               torch.Generator(device=dev).manual_seed(SEED))
        res[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: p.detach().cpu() for k, p in net_d.named_parameters()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = res["cpu"], res[str(device)]
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
           for k in m_cpu if k not in ("clip_fraction", "bc_loss")}
    clip_diff = abs(m_gpu["clip_fraction"] - m_cpu["clip_fraction"])
    param_err = max(max_abs_err(p_gpu[k], p_cpu[k]) for k in p_cpu)
    moved = max(max_abs_err(p_cpu[k], v) for k, v in net.named_parameters())
    atol = 1e-6 + 1e-3 * cfg.learning_rate
    ok = (max(rel.values()) <= 1e-4 and clip_diff <= 1 / (t_len * n)
          and param_err <= atol)
    report["update_reference"] = {"metrics_cpu": m_cpu, "metrics_card": m_gpu,
                                  "rel_err": rel, "clip_fraction_diff": clip_diff,
                                  "param_max_abs_err": param_err,
                                  "param_atol": atol, "param_max_move": moved,
                                  "ok": ok}
    log(f"  update f32 card vs cpu: metrics max rel err {max(rel.values()):.3e} "
        f"(limit 1e-4), clip_fraction {m_cpu['clip_fraction']:.4f} vs "
        f"{m_gpu['clip_fraction']:.4f}, params max abs err {param_err:.3e} "
        f"(limit {atol:.3e}; the update moved them by up to {moved:.3e}), ok={ok}")
    if not ok:
        raise AssertionError("the card's update disagrees with the CPU's")


def main() -> int:
    import torch

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
        phase("4. eval path: greedy eval", lambda: eval_phase(device, report))
        phase("5. reference checks", lambda: reference_phase(device, report))
        phase("6. profile of an eval step", lambda: profile_phase(device, report))
        phase("7. train path: PPO at run9 width",
              lambda: train_phase(device, report))
        phase("8. update card vs CPU", lambda: update_reference_phase(device, report))
        phase("9. profile of a training iteration",
              lambda: train_profile_phase(device, report))

    # `launches` sums both paths' runs; `launches_by_path` splits them.
    kernels = []
    by_path = {p: report.get(p, {}).get("launches", {}) for p in ("eval", "train")}
    for r in report.get("kernels", []):
        split = {p: c.get(r["name"], 0) for p, c in by_path.items()}
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": sum(split.values()), "launches_by_path": split} | {
                k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "shape")} | {
                k: r[k] for k in ("at_update_shape", "ms_at_fleet") if k in r})
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_report.json"), "w") as f:
        json.dump(report | {"failed": failed}, f, indent=2)
    if failed or len(kernels) != 6:
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
