"""The port's search distillation (`bbx_torch.agent.ppo` with the search /
behaviour-cloning knobs) held against `bbx.agent.ppo`, on the CPU.

  * One `update` (one epoch of one minibatch, the tiny AfterstateNetwork
    in float32) of a trajectory with search fields, for BC ``argmax`` /
    ``all``, ``argmax`` / ``adv_pos`` and ``q_soft``: the loss metrics and
    ``bc_loss`` within 1e-5 relative and the post-Adam parameters within
    `test_torch_ppo._assert_update_equal`'s tolerance of bbx's (one jitted
    update a configuration).  One epoch, because a second step from the
    float32-different parameters of the first can flip an evaluator ReLU:
    with two, ``adv_pos`` left nine elements of ``ctx.weight`` up to 0.11
    lr apart, where one epoch agrees within 3e-8 (`test_torch_ppo`'s
    update test covers the carried Adam moments);
  * the search-fraction and BC schedules equal bbx's (both in float32);
  * port-only: the extreme-ratio update stays finite (`tests/
    test_distill.py:252`); a rollout whose search fraction is 0 but whose
    BC is on plays what the search-free rollout plays; one past the anneal
    stores bbx's dummies; exact resume with config/run8.yaml's knobs.
"""
import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.agent import ppo as JPPO
from bbx_torch.agent import ppo as TP
from bbx_torch.agent.trainer import PPOTrainer, train
from bbx_torch.engine import state as TState
from bbx_torch.engine.step import RewardConfig
from bbx_torch.engine.tables import NUM_ACTIONS
from bbx_torch.utils.checkpoints import load_checkpoint
from test_torch_ppo import (  # noqa: F401  (fixture)
    _J_NET,
    SHAPE,
    _assert_update_equal,
    _flax_params,
    _torch_net,
    trajectory,
)
from test_torch_trainer import _assert_same_run, _floats

torch.set_num_threads(1)

TOPK = 8
BC = {
    "argmax_all": dict(bc_coef=0.7, final_bc_coef=0.1, rollout_search_frac=0.5),
    "argmax_adv_pos": dict(bc_coef=0.7, bc_filter="adv_pos"),
    "q_soft": dict(bc_coef=1.2, bc_target="q_soft", bc_q_temp=0.25, search_topk=TOPK),
}


@pytest.fixture(scope="module")
def search_trajectory(trajectory):
    """`test_torch_ppo`'s trajectory with search fields: the search's
    action (valid) and whether the env took it, and TOPK candidates with
    bf16 Q values, -inf on the invalid ones."""
    traj, adv, ret = trajectory
    rng = np.random.default_rng(41)
    t_len, n = traj["action"].shape
    mask = traj["mask"]
    traj = dict(traj)
    traj["search_a"] = np.array([[rng.choice(np.flatnonzero(mask[t, i]))
                                  for i in range(n)] for t in range(t_len)], np.uint8)
    traj["search_used"] = rng.random((t_len, n)) < 0.5
    # The search's action first (valid: each row keeps a finite Q), then
    # other actions, valid or not.
    cand = np.stack([np.concatenate([[a], rng.permutation(np.setdiff1d(
        np.arange(NUM_ACTIONS), [a]))[:TOPK - 1]]) for a in traj["search_a"].reshape(-1)])
    cand = cand.reshape(t_len, n, TOPK)
    q = rng.normal(size=cand.shape).astype(np.float32)
    q = np.where(np.take_along_axis(mask, cand, axis=-1), q, -np.inf)
    traj["search_cand"] = cand.astype(np.uint8)
    traj["search_q"] = np.asarray(jnp.asarray(q, jnp.bfloat16))
    return traj, adv, ret


@pytest.mark.parametrize("name", list(BC))
def test_update_with_bc_matches_bbx(name, search_trajectory):
    traj, adv, ret = search_trajectory
    knobs = dict(SHAPE, num_epochs=1, **BC[name])
    jcfg, tcfg = JPPO.PPOConfig(**knobs), TP.PPOConfig(**knobs)
    assert jcfg.uses_search and tcfg.uses_search
    if tcfg.bc_target != "q_soft":
        traj = {k: v for k, v in traj.items() if k not in ("search_cand", "search_q")}
    tx = JPPO.make_optimizer(jcfg)
    params = _flax_params(43)
    jts0 = JPPO.TrainState(params=jax.tree.map(jnp.asarray, params), batch_stats={},
                           opt_state=tx.init(params), update_step=jnp.int32(1))
    jts1, jm = jax.jit(partial(JPPO.update, _J_NET, jcfg, tx))(
        jts0, {k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(adv),
        jnp.asarray(ret), jax.random.key(1))

    net = _torch_net(params)
    ts = TP.TrainState(net, TP.make_optimizer(tcfg, net), update_step=1)
    m = TP.update(tcfg, ts, {k: torch.from_numpy(np.asarray(v)) if v.dtype != jnp.bfloat16
                             else torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                             for k, v in traj.items()},
                  torch.tensor(adv), torch.tensor(ret), torch.Generator().manual_seed(0))
    m = _floats(m)
    _assert_update_equal(ts, m, jts1, jm)
    assert np.isfinite(m["bc_loss"]) and m["bc_loss"] > 0.0
    assert all(torch.isfinite(p).all() for p in net.parameters())
    np.testing.assert_allclose(m["bc_loss"], float(jm["bc_loss"]), rtol=1e-5)


def test_update_finite_under_extreme_ratio(search_trajectory):
    """Stored logps at the -15 floor and negative advantages: ratios reach
    e^15, and the dual clip keeps the loss, metrics and parameters finite
    (bbx's regression case, with advantages that stay negative after
    normalisation as well as its all-equal ones)."""
    traj, _, ret = search_trajectory
    cfg = TP.PPOConfig(**dict(SHAPE, rollout_search_frac=0.5))
    traj = {k: torch.from_numpy(np.asarray(v)) for k, v in traj.items()
            if k not in ("search_cand", "search_q")}
    traj["logp"] = torch.full_like(traj["logp"], -15.0)
    rng = np.random.default_rng(3)
    for adv in (np.full(ret.shape, -4.0, np.float32),
                (-np.abs(rng.normal(size=ret.shape)) - 1.0).astype(np.float32)):
        net = _torch_net(_flax_params(44))
        ts = TP.TrainState(net, TP.make_optimizer(cfg, net))
        m = TP.update(cfg, ts, traj, torch.from_numpy(adv), torch.tensor(ret),
                      torch.Generator().manual_seed(0))
        assert all(np.isfinite(v) for v in _floats(m).values())
        assert all(torch.isfinite(p).all() for p in net.parameters())


@pytest.mark.parametrize("update_step", [0, 3, 5, 6, 20])
def test_search_schedules_match_bbx(update_step):
    for knobs in (dict(rollout_search_frac=0.85, final_rollout_search_frac=0.0,
                       bc_coef=1.2, final_bc_coef=0.0, search_anneal_frac=0.55),
                  dict(rollout_search_frac=0.3, bc_coef=0.5, final_bc_coef=0.1)):
        jc = JPPO.PPOConfig(schedule_updates=11, **knobs)
        tc = TP.PPOConfig(schedule_updates=11, **knobs)
        us = jnp.int32(update_step)
        assert TP.search_frac_at(tc, update_step) == float(JPPO.search_frac_at(jc, us))
        assert TP.bc_coef_at(tc, update_step) == float(JPPO.bc_coef_at(jc, us))
        assert tc.uses_search == jc.uses_search
    assert not TP.PPOConfig().uses_search


TINY_CNN = {"type": "cnn", "conv_channels": [4, 8], "fc_hidden": [16],
            "compute_dtype": "float32"}
# config/run8.yaml's search and BC knobs.
RUN8_SEARCH = {"rollout_search_frac": 0.85, "final_rollout_search_frac": 0.0,
               "bc_coef": 1.2, "final_bc_coef": 0.0, "bc_target": "q_soft",
               "bc_q_temp": 0.25, "search_topk": 16, "search_anneal_frac": 0.55}


def _rollout(cfg, update_step):
    net = _torch_net(_flax_params(45))
    state = TState.reset(cfg.num_envs, TState.make_generator(8, "cpu"), "cpu")
    return TP.rollout(net, cfg, RewardConfig(), state, torch.Generator().manual_seed(9),
                      update_step=update_step,
                      search_rng=TState.make_generator(10, "cpu"))[1]


def test_rollout_without_search_actions_plays_the_plain_rollout():
    """Search fraction 0 with BC on: the search runs and records, but the
    boards, actions and rewards are the search-free rollout's (its draws
    never touch the fleet's or the action generator); the stored logps
    are the plain ones floored at -15.  One iteration past the anneal the
    search is skipped and its fields hold bbx's dummies (Q 0, not -inf)."""
    shape = dict(rollout_steps=6, num_envs=8)
    plain = _rollout(TP.PPOConfig(**shape), 0)
    cfg = TP.PPOConfig(**shape, bc_coef=0.5, final_bc_coef=0.0, bc_target="q_soft",
                       search_topk=TOPK, schedule_updates=4)
    traj = _rollout(cfg, 0)
    for k in ("board", "piece_ids", "used", "action", "reward", "done"):
        assert torch.equal(traj[k], plain[k]), k
    assert torch.equal(traj["logp"], plain["logp"].clamp(min=-15.0))
    assert not traj["search_used"].any()
    sa = traj["search_a"].long()
    assert torch.gather(traj["mask"], 2, sa[..., None]).all()
    assert traj["search_q"].dtype == torch.bfloat16 and traj["search_cand"].shape[-1] == TOPK
    assert torch.isfinite(traj["search_q"].float()).any(dim=-1).all()
    done = _rollout(cfg, 4)
    for k in ("search_a", "search_cand", "search_q"):
        assert not done[k].float().any(), k
    assert torch.equal(done["action"], plain["action"])


def test_exact_resume_with_run8_knobs(tmp_path):
    """(train k, save, train k) == (train 2k) with config/run8.yaml's
    search and BC knobs: the search generator is
    saved and restored with the others.  A checkpoint saved before the
    search generator existed still loads."""
    cfg = {"training": {"num_envs": 8, "rollout_steps": 8, "batch_size": 32,
                        "total_timesteps": 8 * 8 * 20},
           "ppo": dict(RUN8_SEARCH, num_epochs=2),
           "network": TINY_CNN}
    a = PPOTrainer(cfg, seed=13, device="cpu")
    for _ in range(2):
        a.iterate()
    path = a.save(str(tmp_path), "mid")
    cont = [_floats(a.iterate()) for _ in range(2)]
    assert all(r["bc_loss"] > 0 and 0 < r["search_frac"] < 0.85 for r in cont)
    b = PPOTrainer(cfg, seed=13, device="cpu")
    b.load(path)
    assert [_floats(b.iterate()) for _ in range(2)] == cont
    _assert_same_run(a, b)

    payload = load_checkpoint(path)
    del payload["rng_states"]["search"]
    old = str(tmp_path / "old")
    torch.save(payload, old)
    c = PPOTrainer(cfg, seed=13, device="cpu")
    c.load(old)
    assert c.global_step == 2 * 64 and "search" in c.rngs


def test_train_logs_search_and_evaluates_with_lookahead(tmp_path, monkeypatch):
    """The train loop logs the iteration's search fraction and BC
    coefficient beside `bc_loss`; the trainer's eval plays the search at
    the run's top-k."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = {"training": {"num_envs": 8, "rollout_steps": 8, "batch_size": 32,
                        "total_timesteps": 128},
           "ppo": dict(RUN8_SEARCH, num_epochs=1), "network": TINY_CNN,
           "paths": {"checkpoint_dir": str(tmp_path / "ckpt"),
                     "log_dir": str(tmp_path / "logs")},
           "logging": {"log_interval": 1, "save_interval": 0, "eval_interval": 0}}
    out = train(cfg, seed=2, device="cpu")
    rows = [json.loads(line) for name in os.listdir(tmp_path / "logs")
            if name.endswith(".jsonl") for line in open(tmp_path / "logs" / name)]
    assert [r["search_frac"] for r in rows] == [pytest.approx(0.85), 0.0]
    assert rows[0]["bc_coef"] == pytest.approx(1.2) and rows[0]["bc_loss"] > 0
    ev = out["trainer"].evaluate(num_episodes=2, lookahead=True)
    assert ev["eval_completed"] == 2.0 and ev["eval_score_mean"] > 0


def test_ppo_config_refuses_unknown_bc_and_mu_values():
    for knob in ({"bc_filter": "best"}, {"bc_target": "soft"},
                 {"adam_mu_dtype": "float16"}):
        with pytest.raises(ValueError, match=next(iter(knob))):
            TP.PPOConfig(**knob)


@pytest.mark.parametrize("name", list(BC))
def test_bc_loss_over_row_parts_sums_to_the_batch(name, search_trajectory):
    """`bc_loss_of` over two parts of a minibatch's rows, each as a rank's
    rows of a global minibatch (`total`, and for ``adv_pos`` the global sum
    of `bc_weights`), sums to the whole batch's loss, within float32
    rounding; the parts' filter weights differ, so a rank's own count would
    not do."""
    traj, adv, _ = search_trajectory
    cfg = TP.PPOConfig(**dict(SHAPE, **BC[name]))
    rows = adv.size
    batch = {k: (torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
                 if v.dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(v)))
             for k, v in traj.items()}
    batch = {k: v.reshape(rows, *v.shape[2:]) for k, v in batch.items()}
    batch["adv"] = torch.tensor(adv.reshape(rows))
    rng = np.random.default_rng(47)
    logits = torch.from_numpy(np.where(batch["mask"].numpy(),
                                       rng.normal(size=(rows, NUM_ACTIONS)),
                                       -1e9).astype(np.float32))
    whole = TP.bc_loss_of(cfg, logits, batch)
    parts = [slice(0, rows // 3), slice(rows // 3, rows)]
    weights = [TP.bc_weights({k: v[p] for k, v in batch.items()}).sum() for p in parts]
    assert weights[0] * 2 != weights[1] and sum(weights) > 0
    got = sum(TP.bc_loss_of(cfg, logits[p], {k: v[p] for k, v in batch.items()},
                            total=rows, weight_sum=sum(weights)) for p in parts)
    assert float(whole) > 0
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)
