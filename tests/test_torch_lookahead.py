"""The port's one-ply lookahead (`bbx_torch.agent.lookahead`) held against
`bbx.agent.lookahead`, on the CPU in float32.

Mid-game boards made by the port's engine under numpy-chosen moves (lane
3 done) go through bbx's `lookahead_actions` (the tiny AfterstateNetwork
and flat CNN) and the port's, both given the same masked policy logits,
with ties in them: 4 lanes at top-k 0 and 96 at top-k 8, so that both
simulate a fleet of 768 lanes.  bbx's function runs eagerly around its
`step`, `observe` and network jitted, so that the engine traces and
compiles once for both networks, both top-k and the reward check, and
each network once (on a CPU, one jitted lookahead a configuration took
17-19 s to trace and compile, most of it the engine's step).  The simulated regen
draws come from different generators, so:

  * the candidates equal bbx's exactly (ties in the lower action first);
  * each candidate's done equals bbx's step exactly, and its reward within
    1e-6 (XLA on the CPU contracts the reward's products and sums into
    fused multiply-adds: 5 blocks and a new hole give 0.003 there and
    0.00299999 in the port's unfused order, which K6 keeps on the card),
    where the candidate's step does not regen;
  * q within 1e-5 of r + gamma * V(s') * (1 - done), with V(s') bbx's
    network on the port's own simulated states (recorded by patching
    `step`), and of bbx's own q where the step does not regen;
  * the action equal wherever the top two q are farther apart than 1e-5;
    0 on a lane with no valid candidate.
"""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.agent import lookahead as JL
from bbx.engine.state import from_components as j_from_components
from bbx.engine.step import RewardConfig as JRewardConfig
from bbx.engine.step import step as j_step
from bbx_torch.agent import lookahead as TL
from bbx_torch.engine import state as TState
from bbx_torch.engine.step import RewardConfig, observe, step
from bbx_torch.engine.tables import NUM_ACTIONS
from test_torch_ppo import (
    _J_CNN,
    _J_NET,
    _cnn_variables,
    _flax_params,
    _torch_cnn,
    _torch_net,
)

torch.set_num_threads(1)

TOPK, GAMMA, TOL = 8, 0.99, 1e-5
# Lanes at each top-k: both simulate 768 lanes.
LANES = {0: 4, TOPK: 96}
_J_NETS = {"afterstate": _J_NET, "cnn": _J_CNN}


@functools.cache
def _variables(kind):
    init = jax.jit(_J_CNN.init, static_argnames=("train",))
    return ({"params": _flax_params(11)} if kind == "afterstate" else
            dict(zip(("params", "batch_stats"), _cnn_variables(12, init))))


def _nets(kind):
    """(bbx variables, the port's network) with the same weights."""
    variables = _variables(kind)
    if kind == "afterstate":
        return variables, _torch_net(variables["params"])
    return variables, _torch_cnn(variables["params"], variables["batch_stats"])


def _j_state(s, key):
    return j_from_components(
        board=s.board.numpy(), piece_ids=s.piece_ids.numpy(), used=s.used.numpy(),
        score=s.score.numpy(), streak=s.streak.numpy(), moves=s.moves.numpy(),
        lines_total=s.lines_total.numpy(), max_streak=s.max_streak.numpy(),
        blocks_total=s.blocks_total.numpy(), done=s.done.numpy(),
        prev_holes=s.prev_holes.numpy(), prev_center=s.prev_center.numpy(),
        rng=jax.random.split(jax.random.key(key), s.num_envs))


class _JittedApply:
    """A Flax module's stand-in for bbx's lookahead: `apply` jitted."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("train",))


@pytest.fixture(scope="module")
def oracles():
    """bbx's lookahead for each (network, top-k), its step, observe and
    network jitted; the same jitted step on a tiled fleet (auto-reset off)
    and the same jitted networks."""
    jstep = jax.jit(j_step, static_argnums=(2,), static_argnames=("auto_reset",))
    nets = {kind: _JittedApply(net) for kind, net in _J_NETS.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "step", jstep)
        mp.setattr(JL, "observe", jax.jit(JL.observe))
        look = {(kind, k): partial(JL.lookahead_actions, net, reward_config=JRewardConfig(),
                                   gamma=GAMMA, topk=k, return_q=True)
                for kind, net in nets.items() for k in (0, TOPK)}
        yield look, (lambda s, a: jstep(s, a, JRewardConfig(), auto_reset=False)), nets


@pytest.fixture(scope="module")
def lanes():
    """96 mid-game lanes (some slots used, lane 3 done), and masked logits
    with ties: lane 0's valid logits all equal, lane 1's rounded to a few
    values, the done lane's all -1e9."""
    n = LANES[TOPK]
    rng = np.random.default_rng(31)
    state = TState.reset(n, TState.make_generator(31, "cpu"), "cpu")
    obs = observe(state)
    for _ in range(7):
        act = torch.tensor([rng.choice(np.flatnonzero(m)) for m in
                            obs["action_mask"].numpy()], dtype=torch.int32)
        out = step(state, act, auto_reset=True)
        state, obs = out.state, out.obs
    done = torch.zeros(n, dtype=torch.bool)
    done[3] = True
    state = state.replace(done=done)
    mask = observe(state)["action_mask"].numpy()
    assert mask.any(axis=1).sum() == n - 1 and not mask[3].any()
    logits = rng.normal(size=(n, NUM_ACTIONS)).astype(np.float32)
    logits[0] = 0.5
    logits[1] = np.round(logits[1] * 2) / 2
    logits = np.where(mask, logits, np.float32(-1e9)).astype(np.float32)
    return state, logits


def _port_lookahead(net, state, logits, topk, monkeypatch):
    """The port's lookahead with its simulated step recorded."""
    seen = []

    def recording_step(s, a, rc, auto_reset):
        out = step(s, a, rc, auto_reset=auto_reset)
        seen.append((s, a, out))
        return out

    monkeypatch.setattr(TL, "step", recording_step)
    gen = TState.make_generator(5, "cpu")
    out = TL.lookahead_actions(net, state, gen, RewardConfig(), gamma=GAMMA, topk=topk,
                               policy_logits=torch.from_numpy(logits), return_q=True)
    assert len(seen) == 1
    return out, seen[0]


@pytest.mark.parametrize("topk", [0, TOPK])
@pytest.mark.parametrize("kind", ["afterstate", "cnn"])
def test_lookahead_matches_bbx(kind, topk, oracles, lanes, monkeypatch):
    look, stepper, nets = oracles
    variables, net = _nets(kind)
    n, width = LANES[topk], topk or NUM_ACTIONS
    state, logits = lanes
    state = state.replace(**{f.name: getattr(state, f.name)[:n]
                             for f in dataclasses.fields(state) if f.name != "rng"})
    logits = logits[:n]
    (action, cand, q), (tiled, acts, out) = _port_lookahead(net, state, logits, topk,
                                                            monkeypatch)
    action, cand, q = action.numpy(), cand.numpy(), q.numpy()
    j_action, j_cand, j_q = (np.asarray(x) for x in look[(kind, topk)](
        variables, _j_state(state, 3), jax.random.key(4),
        policy_logits=jnp.asarray(logits)))

    # Candidates: exactly bbx's, ties in the lower action first.
    np.testing.assert_array_equal(cand, j_cand)
    assert cand.shape == (n, width) and cand.dtype == np.int32
    np.testing.assert_array_equal(acts.numpy(), cand.reshape(-1))
    if topk:
        valid0 = np.flatnonzero(logits[0] > -1e9)
        np.testing.assert_array_equal(cand[0], valid0[:topk])  # all tied
        np.testing.assert_array_equal(cand[3], np.arange(topk))  # all -1e9

    # Reward and done: bbx's step on the tiled fleet, where no regen.
    jt = _j_state(tiled, 6)
    jout = stepper(jt, jnp.asarray(acts.numpy()))
    no_regen = (out.regen_attempts == 0).numpy()
    assert no_regen.sum() >= n * width // 2
    r, d = out.reward.numpy(), out.done.numpy()
    np.testing.assert_allclose(r[no_regen], np.asarray(jout.reward)[no_regen],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(d[no_regen], np.asarray(jout.done)[no_regen])

    # q: bbx's value on the port's simulated states.
    _, v2 = nets[kind].apply(variables, *(jnp.asarray(out.obs[k].numpy()) for k in (
        "board", "pieces", "action_mask")), train=False)
    q_ref = jnp.asarray(r) + GAMMA * v2 * (1.0 - jnp.asarray(d).astype(jnp.float32))
    cand_mask = np.take_along_axis(observe(state)["action_mask"].numpy(), cand, axis=1)
    q_ref = np.where(cand_mask, np.asarray(q_ref).reshape(n, width), -np.inf)
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=TOL)
    same_draw = no_regen.reshape(n, width) & cand_mask
    np.testing.assert_allclose(q[same_draw], j_q[same_draw], rtol=0, atol=TOL)
    assert np.isneginf(j_q[~cand_mask]).all()

    # The action: the first maximum of q; action 0 (top-k: the first
    # candidate, here 0) where no candidate is valid.
    assert action[3] == 0 and j_action[3] == 0
    for i in np.flatnonzero(cand_mask.any(axis=1)):
        top2 = np.sort(q_ref[i])[-2:]
        if top2[1] - top2[0] > TOL:
            assert action[i] == cand[i, np.argmax(q_ref[i])], i
            if same_draw[i][cand_mask[i]].all():
                assert action[i] == j_action[i], i


def test_lookahead_computes_its_own_logits_and_keeps_the_real_draws(lanes):
    """Without `policy_logits` the top-k comes from the network's own
    masked logits, and the caller's `obs` stands for ``observe(state)``;
    the search draws from its generator only (the fleet's is untouched)
    and restores the network's mode."""
    state, _ = lanes
    _, net = _nets("cnn")
    net.train()
    fleet = TState.make_generator(9, "cpu")
    state = state.replace(rng=fleet)
    before = fleet.get_state()
    obs = observe(state)
    with torch.no_grad():
        net.eval()
        logits, _ = net(obs["board"], obs["pieces"], obs["action_mask"])
        net.train()
    got = TL.lookahead_actions(net, state, TState.make_generator(5, "cpu"), topk=TOPK,
                               return_q=True)
    want = TL.lookahead_actions(net, state, TState.make_generator(5, "cpu"), topk=TOPK,
                                policy_logits=logits, return_q=True)
    given = TL.lookahead_actions(net, state, TState.make_generator(5, "cpu"), topk=TOPK,
                                 return_q=True, obs=obs)
    for g, w, o in zip(got, want, given):
        assert torch.equal(g, w) and torch.equal(o, w)
    assert net.training and torch.equal(fleet.get_state(), before)


@pytest.mark.parametrize("kind", ["afterstate", "cnn"])
def test_value_is_the_forward_value(kind, lanes):
    """`value` is `forward`'s value bit for bit (eval and train mode; the
    flat CNN's dropout off)."""
    state, _ = lanes
    _, net = _nets(kind)
    obs = observe(state)
    for train in (False, True):
        net.train(train)
        with torch.no_grad():
            _, v = net(obs["board"], obs["pieces"], obs["action_mask"])
            assert torch.equal(net.value(obs["board"], obs["pieces"]), v)


def test_tiled_state_repeats_each_lane(lanes):
    state, _ = lanes
    gen = TState.make_generator(1, "cpu")
    tiled = TL.tile_state(state, 3, gen)
    assert tiled.rng is gen and tiled.num_envs == 3 * state.num_envs
    for f in dataclasses.fields(state):
        if f.name != "rng":
            x = getattr(state, f.name)
            assert torch.equal(getattr(tiled, f.name)[3 * 2 + 1], x[2]), f.name


def _fleet_of(state, n):
    """The first `n` lanes of `state` as a fleet of their own."""
    return state.replace(**{f.name: getattr(state, f.name)[:n]
                            for f in dataclasses.fields(state) if f.name != "rng"}
                         ).sharded(0, n)


def _halves(state, rng_seed):
    """`state` as two shards of its fleet, each with its own generator
    seeded `rng_seed` (ranks seed theirs alike)."""
    n = state.num_envs
    return [state.replace(**{f.name: getattr(state, f.name)[base:base + n // 2]
                             for f in dataclasses.fields(state) if f.name != "rng"},
                          rng=TState.make_generator(rng_seed, "cpu")).sharded(base, n)
            for base in (0, n // 2)]


# Lanes at each top-k for the sharded search: both simulate 1,536 lanes.
SHARD_LANES = {0: 8, 16: 96}


@pytest.fixture(scope="module")
def shard_lanes():
    """96 mid-game lanes after 8 moves (two slots of the triple used, so a
    simulated move that places the third draws new pieces), and masked
    logits."""
    n = SHARD_LANES[16]
    rng = np.random.default_rng(33)
    state = TState.reset(n, TState.make_generator(33, "cpu"), "cpu")
    obs = observe(state)
    for _ in range(8):
        act = torch.tensor([rng.choice(np.flatnonzero(m)) if m.any() else 0
                            for m in obs["action_mask"].numpy()], dtype=torch.int32)
        out = step(state, act, auto_reset=True)
        state, obs = out.state, out.obs
    logits = rng.normal(size=(n, NUM_ACTIONS)).astype(np.float32)
    return state, np.where(obs["action_mask"].numpy(), logits, np.float32(-1e9))


@pytest.mark.parametrize("topk", sorted(SHARD_LANES))
def test_sharded_lookahead_equals_the_fleets_rows(topk, shard_lanes, monkeypatch):
    """Each half of a fleet, as a shard (`EnvState.sharded`), searched with
    its own generator seeded alike: its actions, candidates and Q are the
    whole fleet's rows, bit for bit, and its tiled fleet is that shard of
    the whole fleet's tiling (global lane (lane_base + i) * width + j)."""
    _, net = _nets("cnn")
    state, logits = shard_lanes
    n, width = SHARD_LANES[topk], topk or NUM_ACTIONS
    state = _fleet_of(state, n)
    logits = torch.from_numpy(logits[:n])
    whole = TL.lookahead_actions(net, state, TState.make_generator(5, "cpu"), topk=topk,
                                 policy_logits=logits, return_q=True)
    tiled = []

    def recording_step(s, a, rc, auto_reset):
        out = step(s, a, rc, auto_reset=auto_reset)
        # Some simulated lanes draw new pieces: their draws hash the lane.
        assert out.regen_attempts.any()
        tiled.append((s.lane_base, s.global_lanes, s.num_envs))
        return out

    monkeypatch.setattr(TL, "step", recording_step)
    for half in _halves(state, 5):
        rows = slice(half.lane_base, half.lane_base + half.num_envs)
        got = TL.lookahead_actions(net, half, half.rng, topk=topk,
                                   policy_logits=logits[rows], return_q=True)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[rows])
    assert tiled == [(base * width, n * width, n // 2 * width) for base in (0, n // 2)]


def test_sharded_search_rollout_keeps_the_fleets_rows(shard_lanes, monkeypatch):
    """A search rollout of each half of a fleet, as a rank of a 2-rank
    mesh runs it, stores the whole fleet's rows of every field: the
    search's actions, which lanes took them, the candidates and their Q
    (the search/policy mix drawn at the fleet's shape).  The cross-rank
    sums are the identity here: the episode statistics are not compared,
    and the AfterstateNetwork has no batch statistics."""
    from bbx_torch.agent import ppo as TP
    from bbx_torch.parallel.mesh import Mesh

    _, net = _nets("afterstate")
    state, _ = shard_lanes
    n = 8
    state = _fleet_of(state, n)
    cfg = TP.PPOConfig(rollout_steps=3, num_envs=n, rollout_search_frac=0.5, bc_coef=1.0,
                       bc_target="q_soft", search_topk=TOPK)

    def run(s, mesh=None):
        return TP.rollout(net, cfg, RewardConfig(), s, TState.make_generator(2, "cpu"),
                          search_rng=TState.make_generator(3, "cpu"), mesh=mesh)[1]

    whole = run(state.replace(rng=TState.make_generator(4, "cpu")))
    assert whole["search_used"].any() and not whole["search_used"].all()
    monkeypatch.setattr(TP, "all_reduce_sum", lambda x: x)
    monkeypatch.setattr(TP, "all_reduce_max", lambda x: x)
    for r, half in enumerate(_halves(state, 4)):
        got = run(half, Mesh(2, r, torch.device("cpu")))
        rows = slice(half.lane_base, half.lane_base + half.num_envs)
        for k, v in got.items():
            assert torch.equal(v, whole[k][:, rows]), k
