"""The port's data parallelism (`bbx_torch.parallel`) on the CPU, over gloo.

Counterpart of `tests/test_multiprocess.py` and `tests/test_preemption.py`
for `bbx_torch`: 2 processes (`tests/_torch_parallel_worker.py`) form a
gloo group on 127.0.0.1 and train bbx's own multi-process recipe
(`tests/mp_config.py`: the flat CNN with BatchNorm, residual and dropout
at 256 envs).  Held here:

  * the 2-rank series equals a 1-rank run of the same config and seed
    under `tests/test_multiprocess.py`'s rule (game outcomes within 1e-4,
    losses at rtol 2e-3, atol 2e-4: the ranks' float sums split
    differently), with the parameters and buffers bit for bit equal on
    both ranks after every update;
  * (K iterations, collective save, fresh trainers seeded wrongly, load,
    K iterations) equals the uninterrupted continuation at rel 1e-6, abs
    1e-7, and the 2-rank checkpoint resumes on 1 rank (same rule as 2
    against 1);
  * a rank that holds no row of a minibatch (4 lanes, minibatches of 2)
    still joins every draw and reduction, for a network whose forward
    couples rows (BatchNorm), one that only draws (dropout), one that
    does neither, and one trained with the search and the ``adv_pos`` BC
    term (its weights' global sum);
  * search distillation (config/run8.yaml's knobs on the tiny flat CNN,
    float32): 2 ranks against 1 under the same rule, the first rollout's
    search fields (the search's actions, which lanes took them, the
    candidates and their Q) equal to 1 rank's, the save/resume exact and
    the 2-rank checkpoint resumed on 1 rank;
  * a SIGTERM to rank 1 alone stops both ranks at one boundary, each with
    rc 0, and `final` and `latest` are written; in one process an
    interrupt saves `final` and returns;
  * two ranks on one host's CPU count one device (the `mfu` row's
    divisor);
  * `host_env_slice` / `global_env_count` against bbx's, and the
    cross-rank BatchNorm against bbx's single-device train-mode network on
    the whole batch (`tests/test_torch_network.py`'s train-mode
    tolerances);
  * the refusals: a fleet the world size does not divide, ``num_model``
    2, ``num_data`` other than the world size, and ``nccl`` with two ranks
    on one device.
Every wait on a worker has its own timeout.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from bbx.models import network as JN
from bbx.parallel import distributed as JD
from bbx_torch.agent import ppo as TP
from bbx_torch.agent import trainer as TT
from bbx_torch.agent.trainer import PPOTrainer
from bbx_torch.models.convert import block_blast_state_dict_from_flax
from bbx_torch.parallel import distributed as TD
from bbx_torch.parallel import initialize_multihost
from bbx_torch.utils.checkpoints import checkpoint_exists
from mp_config import K_ITERS, MP_CFG

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_parallel_worker.py")
WAIT_S = 240
# tests/test_multiprocess.py's keys and rule.
EXACT = ("episodes", "mean_score", "max_score", "mean_length")
CLOSE = ("policy_loss", "value_loss", "entropy", "total_loss", "approx_kl",
         "clip_fraction", "mean_return", "invalid_frac")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(mode, out, world=2):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE",
                                                             "MASTER_ADDR", "MASTER_PORT")}
    return [subprocess.Popen([sys.executable, "-u", WORKER, mode, str(r), str(world),
                              str(port), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env)
            for r in range(world)]


def _finish(procs, timeout=WAIT_S):
    """Each worker's output (every worker killed if any outlives the
    timeout), asserting rc 0; rank 0's RESULT if it printed one."""
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} (rc {p.returncode}):\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    return json.loads(lines[0][len("RESULT "):]) if lines else None


def _flax_bn_net():
    """bbx's train-mode BlockBlastNetwork at the BatchNorm case's widths
    (dropout off, float32) and its variables, the norms' scales, biases
    and statistics redrawn so that no layer is the identity."""
    net = JN.BlockBlastNetwork(**W.BN_WIDTHS, norm="batch", dropout_rate=0.0,
                               dtype=jnp.float32)
    v = net.init({"params": jax.random.key(0), "dropout": jax.random.key(0)},
                 jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8)), train=False)
    rng = np.random.default_rng(0)

    def redraw(tree, draws):
        return {k: redraw(x, draws) if isinstance(x, dict) else
                (rng.uniform(*draws[k], np.shape(x)).astype(np.float32) if k in draws
                 else np.asarray(x)) for k, x in tree.items()}

    params = redraw(v["params"], {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)})
    stats = redraw(v["batch_stats"], {"mean": (-0.3, 0.3), "var": (0.5, 2.0)})
    return net, params, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train, zero-row, search and BatchNorm groups, run side by side."""
    out = {m: tmp_path_factory.mktemp(m) for m in ("train", "zero_rows", "search", "bn")}
    net, params, stats = _flax_bn_net()
    torch.save(block_blast_state_dict_from_flax(params, stats),
               str(out["bn"] / "bn_state.pt"))
    procs = {m: _start(m, out[m]) for m in out}
    try:
        return {m: _finish(procs[m]) for m in out} | {"bn_dir": out["bn"],
                                                      "bn_flax": (net, params, stats)}
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()


def _series(cfg, seed, n, load=None):
    trainer = PPOTrainer(cfg, seed=seed, device="cpu")
    if load:
        trainer.load(load)
    return [{k: float(v) for k, v in trainer.iterate().items()} for _ in range(n)]


def _assert_matches_one_rank(got, want, where, close=CLOSE):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), where
        for k in EXACT:
            assert g[k] == pytest.approx(w[k], abs=1e-4), f"{where} iter{i}.{k}"
        for k in close:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-4,
                                       err_msg=f"{where} iter{i}.{k}")


def test_two_ranks_match_one_rank(runs):
    r = runs["train"]
    assert r["lanes"] == [0, MP_CFG["training"]["num_envs"] // 2]
    assert all(r["same"]), r["same"]
    _assert_matches_one_rank(r["head"] + r["cont"], _series(MP_CFG, 3, 2 * K_ITERS),
                             "2 ranks vs 1")


def test_two_rank_save_resume_exact(runs):
    r = runs["train"]
    assert r["loaded_step"] == K_ITERS * MP_CFG["training"]["num_envs"] * \
        MP_CFG["training"]["rollout_steps"]
    for i, (cont, res) in enumerate(zip(r["cont"], r["res"])):
        assert set(cont) == set(res)
        for k in cont:
            assert res[k] == pytest.approx(cont[k], rel=1e-6, abs=1e-7), \
                f"iter{i}.{k}: {res[k]} vs {cont[k]}"


def test_two_rank_checkpoint_resumes_on_one_rank(runs):
    r = runs["train"]
    _assert_matches_one_rank(_series(MP_CFG, 999, K_ITERS, load=r["path"]), r["cont"],
                             "1 rank from a 2-rank checkpoint")


def test_two_ranks_match_one_rank_with_search(runs, monkeypatch):
    """Search distillation on 2 ranks: the first rollout's search fields
    equal 1 rank's lane for lane, and the series (with `bc_loss`, the
    search fraction and the BC coefficient) matches 1 rank's."""
    r = runs["search"]
    assert r["lanes"] == [0, W.SEARCH_CFG["training"]["num_envs"] // 2]
    assert all(r["same"]), r["same"]
    rollout0, first = TP.rollout, []

    def rollout(*args, **kwargs):
        out = rollout0(*args, **kwargs)
        if not first:
            first.append({k: out[1][k].transpose(0, 1).float().tolist()
                          for k in W.SEARCH_FIELDS})
        return out

    monkeypatch.setattr(TP, "rollout", rollout)
    want = _series(W.SEARCH_CFG, 3, 2 * K_ITERS)
    for k in W.SEARCH_FIELDS:
        assert r["first_rollout"][k] == first[0][k], k
    assert all(0.8 < g["search_frac"] < 0.86 and g["bc_loss"] > 0
               for g in r["head"] + r["cont"])
    _assert_matches_one_rank(r["head"] + r["cont"], want, "search, 2 ranks vs 1",
                             close=CLOSE + ("bc_loss", "search_frac", "bc_coef"))


def test_two_rank_search_save_resume_exact(runs):
    """A collective save in the middle of a search run carries the search
    generator and the annealed schedules: the resumed run is the
    uninterrupted one."""
    r = runs["search"]
    tr = W.SEARCH_CFG["training"]
    assert r["loaded_step"] == K_ITERS * tr["num_envs"] * tr["rollout_steps"]
    for i, (cont, res) in enumerate(zip(r["cont"], r["res"])):
        assert set(cont) == set(res)
        for k in cont:
            assert res[k] == pytest.approx(cont[k], rel=1e-6, abs=1e-7), \
                f"iter{i}.{k}: {res[k]} vs {cont[k]}"


def test_two_rank_search_checkpoint_resumes_on_one_rank(runs):
    r = runs["search"]
    _assert_matches_one_rank(_series(W.SEARCH_CFG, 999, K_ITERS, load=r["path"]),
                             r["cont"], "search, 1 rank from a 2-rank checkpoint",
                             close=CLOSE + ("bc_loss", "search_frac", "bc_coef"))


def _zero_row_minibatches(cfg, seed, iterations) -> int:
    """Minibatches of the run whose entries all lie on one rank's lanes,
    from the shuffle generator's permutations (seeded seed + 2)."""
    tr = cfg["training"]
    n, total, mb = tr["num_envs"], tr["num_envs"] * tr["rollout_steps"], tr["batch_size"]
    g = torch.Generator().manual_seed(seed + 2)
    count = 0
    for _ in range(iterations * cfg["ppo"]["num_epochs"]):
        perm = torch.randperm(total, generator=g)
        for i in range(total // mb):
            ranks = set(((perm[i * mb:(i + 1) * mb] % n) // (n // 2)).tolist())
            count += len(ranks) == 1
    return count


@pytest.mark.parametrize("kind", sorted(W.ZERO_ROW_CFGS))
def test_rank_with_no_rows_of_a_minibatch(runs, kind):
    cfg = W.ZERO_ROW_CFGS[kind]
    r = runs["zero_rows"][kind]
    assert _zero_row_minibatches(cfg, W.ZERO_ROW_SEED, 2) > 0
    assert all(r["same"]), r["same"]
    _assert_matches_one_rank(r["series"], _series(cfg, W.ZERO_ROW_SEED, 2), kind)


def test_cross_rank_batchnorm_matches_bbx(runs):
    """Output, running statistics and input gradient of the cross-rank
    BatchNorm network over 2 ranks, rows concatenated, against bbx's
    single-device train-mode network on the whole batch."""
    net, params, stats = runs["bn_flax"]
    got = np.load(runs["bn_dir"] / "bn_out.npz")
    assert bool(got["same"])
    board, pieces, w_logits, w_value = W.bn_inputs()

    def loss(b, p):
        (logits, value), mut = net.apply({"params": params, "batch_stats": stats}, b, p,
                                         None, train=True, mutable=["batch_stats"])
        return (jnp.sum(logits * w_logits) + jnp.sum(value * w_value),
                (logits, value, mut["batch_stats"]))

    (_, (logits, value, new_stats)), (db, dp) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(board, pieces)
    np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["value"], np.asarray(value), rtol=0, atol=5e-5)
    want = block_blast_state_dict_from_flax(params, jax.tree.map(np.asarray, new_stats))
    names = [k for k in got.files if k.startswith("stat:")]
    assert names
    for name in names:
        np.testing.assert_allclose(got[name], want[name[5:]].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for g, w in ((got["dboard"], db), (got["dpieces"], dp)):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-3  # the loss reaches the inputs
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-5 * max(1.0, np.abs(w).max()))


def test_sigterm_to_one_rank_stops_both(tmp_path):
    procs = _start("sigterm", tmp_path)
    try:
        seen, lines, deadline = 0, [], time.time() + WAIT_S
        while seen < 3 and time.time() < deadline:
            line = procs[0].stdout.readline()
            if not line:
                break
            lines.append(line)
            seen += line.startswith("step=")
        assert seen >= 3, "no progress from rank 0:\n" + "".join(lines)[-4000:]
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    outs[0] = "".join(lines) + outs[0]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} (rc {p.returncode}):\n{out[-4000:]}"
        assert "CLEAN_EXIT" in out, out[-4000:]
    assert "SIGTERM received" in outs[1] and "another rank stopped" in outs[0]
    steps = {int(ln.split()[1]) for out in outs for ln in out.splitlines()
             if ln.startswith("FINAL_STEP ")}
    assert len(steps) == 1 and steps.pop() > 0
    for name in ("final", "latest"):
        assert checkpoint_exists(str(tmp_path / "ckpt" / name)), name


@pytest.mark.parametrize("world", [1, 2, 4])
def test_env_slices_match_bbx(world, monkeypatch):
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        monkeypatch.setattr(TD, "world_size", lambda: world)
        monkeypatch.setattr(TD, "rank", lambda: r)
        for n in (256, 512, 4096):
            assert TD.host_env_slice(n) == JD.host_env_slice(n)
            assert TD.global_env_count(n // world) == JD.global_env_count(n // world)
        assert TD.is_primary() == JD.is_primary()


def test_single_process_forms_no_group(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert (TD.world_size(), TD.rank(), TD.is_primary()) == (1, 0, True)


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    """Before any group forms: more ranks on the node than cards, a rank
    on another card than its local rank's, or a CPU device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this node and 1 card"):
        initialize_multihost("127.0.0.1:1", 2, 1, backend="nccl", device="cuda:0",
                             local_rank=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="local rank 1 asked for cuda:0"):
        initialize_multihost("127.0.0.1:1", 2, 1, backend="nccl", device="cuda:0",
                             local_rank=1)
    with pytest.raises(ValueError, match="runs on CUDA devices"):
        initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")


def test_the_refusals_in_a_group(runs):
    refusals = runs["train"]["refusals"]
    assert "not divisible by the world size 2" in refusals["num_envs"]
    assert "model axis must be 1" in refusals["num_model"]
    assert "has 2 rank(s)" in refusals["num_data"]


def test_ranks_on_one_cpu_count_one_device(runs):
    """The mfu row's divisor: two ranks on the one CPU share its peak."""
    assert runs["train"]["num_devices"] == 1


def test_interrupt_in_one_process_saves_final(tmp_path, monkeypatch):
    """At world size 1 an interrupt stops the loop, `final` is saved and
    `train` returns (in a group it is raised without a collective save)."""
    iterate0, calls = PPOTrainer.iterate, []

    def iterate(self):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return iterate0(self)

    monkeypatch.setattr(PPOTrainer, "iterate", iterate)
    cfg = dict(W.SIGTERM_CFG, paths={"checkpoint_dir": str(tmp_path / "ckpt"),
                                     "log_dir": str(tmp_path / "logs")})
    stats = TT.train(cfg, seed=3, device="cpu")
    tr = cfg["training"]
    assert len(calls) == 2 and stats["global_step"] == tr["num_envs"] * tr["rollout_steps"]
    assert checkpoint_exists(str(tmp_path / "ckpt" / "final"))
