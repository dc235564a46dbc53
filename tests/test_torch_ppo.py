"""The port's PPO (`bbx_torch.agent.ppo`) held against `bbx.agent.ppo`.

The same inputs, made from numpy seeds (or by the port's engine under
numpy-chosen moves), go through the JAX function (jitted once per module,
on the CPU) and its PyTorch counterpart (device "cpu", so GAE takes its
plain version).  Networks are the AfterstateNetwork at tiny widths
(evaluator (4, 4), hidden 8, value (4, 4), hidden 16) in float32, with
Flax parameters made with numpy and converted.  Tolerances:

  * GAE within 1e-6 of bbx (XLA may fuse the float32 scan differently);
    the plain version equal bit for bit to a numpy float32 loop in bbx's
    operation order (what the CUDA kernel K5 reproduces);
  * the schedules equal (both computed in float32);
  * one `update` (2 epochs of one minibatch): the loss metrics within
    1e-5 relative, the post-Adam parameters within 1e-6 + 1e-3 x lr
    (Adam's step is about lr per element; the grads differ only by the
    order of float32 sums in two convolution libraries), except the one
    parameter whose gradient is zero in exact arithmetic (see
    `_assert_update_equal`).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bbx.agent import ppo as JPPO
from bbx.engine.state import from_components as j_from_components
from bbx.engine.step import RewardConfig as JRewardConfig
from bbx.engine.step import step as j_step
from bbx.models import network as JN
from bbx.models.afterstate import AfterstateNetwork as JNet
from bbx_torch.agent import ppo as TP
from bbx_torch.engine import state as TState
from bbx_torch.engine.step import RewardConfig, observe, step
from bbx_torch.models import AfterstateNetwork as TNet
from bbx_torch.models import afterstate as TA
from bbx_torch.models import distributions as TD
from bbx_torch.models import network as TN
from bbx_torch.models.convert import (
    adam_state_from_optax,
    afterstate_state_dict_from_flax,
    block_blast_state_dict_from_flax,
    load_adam_state,
)

torch.set_num_threads(1)

TINY = dict(eval_channels=(4, 4), eval_hidden=8, ctx_dim=6,
            value_channels=(4, 4), value_hidden=16)
T_LEN, N_ENVS = 4, 8
# One minibatch per epoch, so the shuffle only reorders a mean.
SHAPE = dict(num_epochs=2, minibatch_size=T_LEN * N_ENVS, rollout_steps=T_LEN,
             num_envs=N_ENVS, learning_rate=3e-4, final_learning_rate=1e-4,
             final_entropy_coef=0.002, schedule_updates=3)
J_CFG = JPPO.PPOConfig(**SHAPE)
T_CFG = TP.PPOConfig(**SHAPE)
_J_NET = JNet(**TINY, dtype=jnp.float32)
_J_TX = JPPO.make_optimizer(J_CFG)
_j_update = jax.jit(partial(JPPO.update, _J_NET, J_CFG, _J_TX))
_j_gae = jax.jit(partial(JPPO.compute_gae, J_CFG))
_j_step = jax.jit(lambda s, a: j_step(s, a, JRewardConfig(), auto_reset=False))


def _flax_params(seed):
    """A Flax AfterstateNetwork param tree of numpy arrays (tiny widths),
    random kernels and non-zero biases."""
    rng = np.random.default_rng(seed)

    def layer(*shape):
        bound = np.sqrt(6.0 / int(np.prod(shape[:-1])))
        return {"kernel": rng.uniform(-bound, bound, shape).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, shape[-1]).astype(np.float32)}

    return {
        "Checkpoint_Evaluator_0": {
            "Conv_0": layer(3, 3, 2, 4), "Conv_1": layer(3, 3, 4, 4),
            "Dense_0": layer(64 * 4 + 3 + 6, 8), "Dense_1": layer(8, 1),
        },
        "Conv_0": layer(3, 3, 4, 4), "Conv_1": layer(3, 3, 4, 4),
        "Dense_0": layer(64, 6), "Dense_1": layer(64 * 4, 16),
        "Dense_2": layer(16, 1),
    }


def _torch_net(params):
    net = TNet(**TINY, compute_dtype=torch.float32)
    net.load_state_dict(afterstate_state_dict_from_flax(params))
    return net


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trajectory():
    """A fixed T x N trajectory from the port's engine under numpy-chosen
    valid moves, with stored log-probs drawn from [-5, -2] (so the ratios
    spread and clipping is exercised) and random values; GAE by bbx."""
    rng = np.random.default_rng(21)
    state = TState.reset(N_ENVS, TState.make_generator(21, "cpu"), "cpu")
    obs = observe(state)
    cols = {k: [] for k in ("board", "piece_ids", "used", "mask", "action",
                            "reward", "done")}
    for _ in range(T_LEN + 6):
        act = torch.tensor([rng.choice(np.flatnonzero(m))
                            for m in obs["action_mask"].numpy()], dtype=torch.int32)
        out = step(state, act, auto_reset=True)
        for k, v in (("board", state.board), ("piece_ids", state.piece_ids),
                     ("used", state.used), ("mask", obs["action_mask"]),
                     ("action", act), ("reward", out.reward), ("done", out.done)):
            cols[k].append(v.numpy())
        state, obs = out.state, out.obs
    # The last T steps: mid-game boards, some slots used.
    traj = {k: np.stack(v[-T_LEN:]) for k, v in cols.items()}
    traj["piece_ids"] = traj["piece_ids"].astype(np.int8)
    traj["done"][1, 2] = True
    traj["logp"] = rng.uniform(-5, -2, (T_LEN, N_ENVS)).astype(np.float32)
    traj["value"] = rng.normal(size=(T_LEN, N_ENVS)).astype(np.float32)
    last_value = rng.normal(size=N_ENVS).astype(np.float32)
    adv, ret = (np.asarray(x) for x in _j_gae(
        traj["reward"], traj["done"], traj["value"], last_value))
    return traj, adv, ret


# ---------------------------------------------------------------------------
# GAE.
# ---------------------------------------------------------------------------

def _gae_inputs(seed=0, t_len=8, n=6):
    rng = np.random.default_rng(seed)
    dones = rng.random((t_len, n)) < 0.2
    dones[3, 1] = True
    dones[-1, ::2] = True
    return (rng.normal(size=(t_len, n)).astype(np.float32), dones,
            rng.normal(size=(t_len, n)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def test_compute_gae_matches_bbx():
    args = _gae_inputs()
    want = _j_gae(*args)
    got = TP.compute_gae(T_CFG, *(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_compute_gae_plain_is_bbx_order_in_float32():
    """Bit for bit equal to a numpy float32 loop with one rounding per
    operation, in bbx's order: the contract K5 reproduces on the card."""
    rewards, dones, values, last = _gae_inputs(seed=1, t_len=16, n=9)
    f = np.float32
    gamma, gl = f(T_CFG.gamma), f(T_CFG.gamma * T_CFG.gae_lambda)
    adv = np.zeros_like(values)
    a_next, v_next = np.zeros_like(last), last
    for t in reversed(range(rewards.shape[0])):
        nonterm = f(1.0) - dones[t].astype(f)
        delta = (rewards[t] + (gamma * v_next) * nonterm) - values[t]
        a_next = delta + (gl * nonterm) * a_next
        adv[t], v_next = a_next, values[t]
    got_adv, got_ret = TP.compute_gae_plain(
        T_CFG, *(torch.from_numpy(a) for a in (rewards, dones, values, last)))
    np.testing.assert_array_equal(got_adv.numpy(), adv)
    np.testing.assert_array_equal(got_ret.numpy(), adv + values)


# ---------------------------------------------------------------------------
# Schedules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("update_step", [0, 1, 37, 100, 150])
def test_schedules_match_bbx(update_step):
    """The entropy coefficient reads the PPO iteration; the lr counts
    optimizer steps over schedule_updates x epochs x minibatches, the first
    step at the initial lr (the schedule of `bbx/agent/ppo.py:142-146`)."""
    shape = dict(learning_rate=3e-4, final_learning_rate=2e-5,
                 entropy_coef=0.01, final_entropy_coef=5e-4,
                 schedule_updates=100, num_epochs=2, minibatch_size=2048,
                 rollout_steps=128, num_envs=512)
    jc, tc = JPPO.PPOConfig(**shape), TP.PPOConfig(**shape)
    assert TP.entropy_coef_at(tc, update_step) == float(
        JPPO.entropy_coef_at(jc, jnp.int32(update_step)))
    horizon = 100 * 2 * 32
    sched = optax.linear_schedule(3e-4, 2e-5, horizon)
    for count in (update_step * 64, update_step * 64 + 1):
        assert TP.learning_rate_at(tc, count) == float(sched(count)), count
    assert TP.learning_rate_at(tc, 0) == float(np.float32(3e-4))
    assert TP.learning_rate_at(tc, horizon) == float(np.float32(2e-5))
    flat = TP.PPOConfig(**dict(shape, final_learning_rate=None,
                               final_entropy_coef=None))
    assert TP.learning_rate_at(flat, 999) == 3e-4
    assert TP.entropy_coef_at(flat, 999) == float(np.float32(0.01))


# ---------------------------------------------------------------------------
# The update.
# ---------------------------------------------------------------------------

_METRICS = ("policy_loss", "value_loss", "entropy", "total_loss", "approx_kl",
            "clip_fraction")


def _torch_update(net, adam, update_step, traj, adv, ret):
    ts = TP.TrainState(net, TP.make_optimizer(T_CFG, net), update_step=update_step)
    if adam is not None:
        load_adam_state(ts.optimizer, net, adam)
    metrics = TP.update(T_CFG, ts, {k: torch.from_numpy(v) for k, v in traj.items()},
                        torch.tensor(adv), torch.tensor(ret),
                        torch.Generator().manual_seed(0))
    return ts, {k: float(v) for k, v in metrics.items()}


def _assert_update_equal(ts, metrics, jts, jmetrics,
                         convert=afterstate_state_dict_from_flax,
                         zero_grad=("evaluator.dense1.bias",)):
    for k in _METRICS:
        np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert set(metrics) == set(jmetrics)
    want = convert(_np_tree(jts.params))
    atol = 1e-6 + 1e-3 * T_CFG.learning_rate
    for name, p in ts.network.named_parameters():
        # A parameter in `zero_grad` has a gradient that is zero in exact
        # arithmetic: the evaluator's last bias shifts all 192 logits of a
        # state alike, and the masked softmax, log-prob and entropy are
        # shift-invariant.  Both frameworks step it by Adam's normalisation
        # of float32 noise (up to lr a step), so it is held to that bound.
        tol = (2 * T_CFG.num_epochs * T_CFG.learning_rate
               if name in zero_grad else atol)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=tol, err_msg=name)
    assert TP.optimizer_steps(ts.optimizer) == int(jts.opt_state[1][0].count)
    assert ts.update_step == int(jts.update_step)


def test_update_matches_bbx_fresh_and_carried(trajectory):
    """One update from a fresh optimizer, then one more from the optax
    state bbx carried out of the first (`adam_state_from_optax`)."""
    traj, adv, ret = trajectory
    params = _flax_params(5)
    jts0 = JPPO.TrainState(params=jax.tree.map(jnp.asarray, params),
                           batch_stats={}, opt_state=_J_TX.init(params),
                           update_step=jnp.int32(0))
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    jts1, jm1 = _j_update(jts0, jtraj, jnp.asarray(adv), jnp.asarray(ret),
                          jax.random.key(1))
    ts1, m1 = _torch_update(_torch_net(params), None, 0, traj, adv, ret)
    _assert_update_equal(ts1, m1, jts1, jm1)
    assert 0.0 < m1["clip_fraction"] < 1.0

    jts2, jm2 = _j_update(jts1, jtraj, jnp.asarray(adv), jnp.asarray(ret),
                          jax.random.key(2))
    p1 = _np_tree(jts1.params)
    adam = adam_state_from_optax(_np_tree(jts1.opt_state), p1)
    assert adam["step"] == 2
    # The evaluator runs channels-last and flattens as Flax does, so its
    # first Dense and that Dense's moments keep Flax's row order; the value
    # head's Dense after the NCHW flatten has its rows permuted.
    mu = _adam_mu(_np_tree(jts1.opt_state))
    np.testing.assert_array_equal(
        adam["exp_avg"]["evaluator.dense0.weight"].numpy(),
        mu["Checkpoint_Evaluator_0"]["Dense_0"]["kernel"].T)
    v_mu = mu["Dense_1"]["kernel"]
    c = v_mu.shape[0] // 64
    np.testing.assert_array_equal(
        adam["exp_avg"]["value_dense0.weight"].numpy(),
        v_mu.reshape(8, 8, c, -1).transpose(2, 0, 1, 3).reshape(64 * c, -1).T)
    ts2, m2 = _torch_update(_torch_net(p1), adam, 1, traj, adv, ret)
    _assert_update_equal(ts2, m2, jts2, jm2)
    # The carried moments moved the second step: a fresh Adam from the
    # same params lands elsewhere.
    ts_fresh, _ = _torch_update(_torch_net(p1), None, 1, traj, adv, ret)
    diff = max((a - b).abs().max().item() for a, b in zip(
        ts_fresh.network.parameters(), ts2.network.parameters()))
    assert diff > 1e-3 * T_CFG.learning_rate


def _adam_mu(opt_state):
    """The ``mu`` tree of the ScaleByAdamState inside bbx's optax chain."""
    for sub in opt_state:
        if hasattr(sub, "mu"):
            return sub.mu
        if isinstance(sub, tuple):
            found = _adam_mu(sub)
            if found is not None:
                return found
    return None


def test_advantage_normalisation_uses_population_std():
    """`jnp.std` is ddof 0; torch's default (ddof 1) would move the
    normalised advantages past the update test's 1e-5 tolerance."""
    adv = np.random.default_rng(3).normal(size=T_LEN * N_ENVS).astype(np.float32)
    want = (adv - adv.mean()) / (adv.std() + 1e-8)
    got = TP.normalize_advantages(torch.from_numpy(adv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    t = torch.from_numpy(adv)
    ddof1 = ((t - t.mean()) / (t.std() + 1e-8)).numpy()
    assert not np.allclose(ddof1, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The rollout and the network's backward.
# ---------------------------------------------------------------------------

def test_rollout_buffer_matches_network_and_bbx_step(monkeypatch):
    """On CPU at N = 8, T = 16 (long enough for games to end): the stored logp/value are the network's on
    the stored observations; each transition's done/reward equals bbx's
    step on the same (state, action) for lanes that did not regen; and
    `ep_stats` counts the dones."""
    n, t_len = 8, 16
    net = _torch_net(_flax_params(6))
    cfg = TP.PPOConfig(rollout_steps=t_len, num_envs=n)
    seen = []

    def recording_step(state, action, rc, auto_reset):
        out = step(state, action, rc, auto_reset=auto_reset)
        seen.append((state, action, out))
        return out

    monkeypatch.setattr(TP, "step", recording_step)
    state0 = TState.reset(n, TState.make_generator(4, "cpu"), "cpu")
    _, traj, last_value, ep = TP.rollout(net, cfg, RewardConfig(), state0,
                                         torch.Generator().manual_seed(5))
    assert len(seen) == t_len and last_value.shape == (n,)

    flat = {k: v.reshape(t_len * n, *v.shape[2:]) for k, v in traj.items()}
    obs = TP._minibatch_obs(flat)
    with torch.no_grad():
        logits, value = net(obs["board"], obs["pieces"], obs["action_mask"])
    np.testing.assert_allclose(TD.log_prob(logits, flat["action"]).numpy(),
                               flat["logp"].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), flat["value"].numpy(), rtol=0, atol=1e-5)

    compared = 0
    for t, (s, a, out) in enumerate(seen):
        js = j_from_components(
            board=s.board.numpy(), piece_ids=s.piece_ids.numpy(),
            used=s.used.numpy(), score=s.score.numpy(), streak=s.streak.numpy(),
            moves=s.moves.numpy(), lines_total=s.lines_total.numpy(),
            max_streak=s.max_streak.numpy(), blocks_total=s.blocks_total.numpy(),
            done=s.done.numpy(), prev_holes=s.prev_holes.numpy(),
            prev_center=s.prev_center.numpy(),
            rng=jax.random.split(jax.random.key(t), n))
        jout = _j_step(js, jnp.asarray(a.numpy()))
        valid = ~out.info["invalid_action"].numpy()
        used = s.used.numpy().copy()
        used[np.arange(n)[valid], a.numpy()[valid] // 64] = True
        keep = ~(valid & used.all(axis=1))
        np.testing.assert_array_equal(traj["done"][t].numpy()[keep],
                                      np.asarray(jout.done)[keep])
        np.testing.assert_allclose(traj["reward"][t].numpy()[keep],
                                   np.asarray(jout.reward)[keep], rtol=0, atol=1e-6)
        compared += keep.sum()
    assert compared >= t_len * n // 2
    dones = traj["done"].numpy()
    assert float(ep["episodes"]) == dones.sum() > 0
    scores = np.stack([o.info["final_score"].numpy() for _, _, o in seen])
    np.testing.assert_allclose(float(ep["mean_score"]), scores[dones].mean(), rtol=1e-6)
    assert float(ep["invalid_frac"]) == 0.0


def test_checkpointed_evaluator_gradients_equal_unwrapped(monkeypatch):
    """With grad on, the evaluator runs under `torch.utils.checkpoint`
    (bbx's nn.remat); the gradients equal those of the plain forward
    exactly, are finite, and reach every parameter."""
    rng = np.random.default_rng(7)
    state = TState.reset(4, TState.make_generator(7, "cpu"), "cpu")
    obs = observe(state)
    for _ in range(6):
        act = torch.tensor([rng.choice(np.flatnonzero(m))
                            for m in obs["action_mask"].numpy()])
        out = step(state, act, auto_reset=True)
        state, obs = out.state, out.obs
    mask = obs["action_mask"]

    def grads():
        net = _torch_net(_flax_params(8))
        logits, value = net(obs["board"], obs["pieces"], mask)
        (torch.where(mask, logits, 0.0).square().sum() + value.sum()).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    calls = []
    real = TA.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(TA, "checkpoint", spy)
    with_ckpt = grads()
    assert calls == [{"use_reentrant": False}]
    monkeypatch.setattr(TA, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain = grads()
    for k, g in with_ckpt.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, k
        assert torch.equal(g, plain[k]), k



# ---------------------------------------------------------------------------
# The flat CNN: BatchNorm carried through the rollout and the update.
# ---------------------------------------------------------------------------

CNN = dict(conv_channels=(4, 8, 8), fc_hidden=(16, 8))
_J_CNN = JN.BlockBlastNetwork(**CNN, dropout_rate=0.0, dtype=jnp.float32)
_j_cnn_update = jax.jit(partial(JPPO.update, _J_CNN, J_CFG, _J_TX))
_j_cnn_apply = jax.jit(partial(JPPO._apply, _J_CNN), static_argnames=("train", "mutable"))


def _cnn_variables(seed):
    """Flax variables of the small CNN with every bias, norm scale and
    running statistic redrawn with numpy (no layer is the identity)."""
    v = _J_CNN.init({"params": jax.random.key(seed), "dropout": jax.random.key(seed)},
                    jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8)), train=False)
    rng = np.random.default_rng(seed)

    def redraw(tree, draws):
        return {k: redraw(v, draws) if isinstance(v, dict) else (
            rng.uniform(*draws[k], np.shape(v)).astype(np.float32) if k in draws
            else np.asarray(v)) for k, v in tree.items()}

    return (redraw(v["params"], {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)}),
            redraw(v["batch_stats"], {"mean": (-0.3, 0.3), "var": (0.5, 2.0)}))


def _torch_cnn(params, stats):
    net = TN.BlockBlastNetwork(**CNN, dropout_rate=0.0, compute_dtype=torch.float32)
    net.load_state_dict(block_blast_state_dict_from_flax(params, stats))
    return net


def _assert_stats_equal(net, params, stats, atol):
    want = block_blast_state_dict_from_flax(_np_tree(params), _np_tree(stats))
    for name, buf in net.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("train_mode", [True, False])
def test_flat_cnn_rollout_carries_batch_stats(train_mode):
    """With rollout_train_mode the rollout runs the CNN in train mode, its
    running statistics moving step to step as bbx's mutable apply moves
    them over the same observations (within 1e-6), and the stored values
    are the train-mode ones (within 5e-5, see test_torch_network.py); the
    bootstrap value is eval mode on the running statistics the rollout
    leaves (within 1e-5).  Without it nothing moves."""
    params, stats = _cnn_variables(1)
    net = _torch_cnn(params, stats)
    t_len, n = 4, 8
    cfg = TP.PPOConfig(rollout_steps=t_len, num_envs=n, rollout_train_mode=train_mode)
    state0 = TState.reset(n, TState.make_generator(2, "cpu"), "cpu")
    env, traj, last_value, _ = TP.rollout(net, cfg, RewardConfig(), state0,
                                          torch.Generator().manual_seed(3))
    bs = stats
    for t in range(t_len):
        obs = {k: jnp.asarray(v.numpy()) for k, v in TP._minibatch_obs(
            {k: traj[k][t] for k in ("board", "piece_ids", "used", "mask")}).items()}
        _, value, bs = _j_cnn_apply(params, bs, obs, train=train_mode,
                                    mutable=train_mode)
        np.testing.assert_allclose(traj["value"][t].numpy(), np.asarray(value),
                                   rtol=0, atol=5e-5)
    _assert_stats_equal(net, params, bs, atol=1e-6)
    if not train_mode:
        _assert_stats_equal(net, params, stats, atol=0)
    obs = {k: jnp.asarray(v.numpy()) for k, v in observe(env).items()}
    _, want_last, _ = _j_cnn_apply(params, bs, obs, train=False, mutable=False)
    np.testing.assert_allclose(last_value.numpy(), np.asarray(want_last),
                               rtol=0, atol=1e-5)


def test_flat_cnn_update_matches_bbx(trajectory):
    """One update of the small CNN (dropout off) from a fresh optax state:
    the same metrics, post-Adam parameters and running statistics (carried
    from minibatch to minibatch, within 1e-6) as bbx.  The conv biases
    feed a batch-statistics BatchNorm, which subtracts their shift again,
    so their gradient is zero in exact arithmetic and they are held to
    Adam's step bound, like the evaluator's last bias."""
    traj, adv, ret = trajectory
    params, stats = _cnn_variables(4)
    jts0 = JPPO.TrainState(params=jax.tree.map(jnp.asarray, params),
                           batch_stats=jax.tree.map(jnp.asarray, stats),
                           opt_state=_J_TX.init(params), update_step=jnp.int32(0))
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    jts1, jm1 = _j_cnn_update(jts0, jtraj, jnp.asarray(adv), jnp.asarray(ret),
                              jax.random.key(1))
    net = _torch_cnn(params, stats)
    ts1, m1 = _torch_update(net, None, 0, traj, adv, ret)
    conv_biases = tuple(k for k, _ in net.named_parameters()
                        if k.endswith("bias") and ("convs" in k or ".conv" in k))
    _assert_update_equal(ts1, m1, jts1, jm1, convert=block_blast_state_dict_from_flax,
                         zero_grad=conv_biases)
    _assert_stats_equal(ts1.network, jts1.params, jts1.batch_stats, atol=1e-6)
