"""The port's AfterstateNetwork (`bbx_torch.models`) held against `bbx.models`.

Inputs come from numpy seeds (or the port's engine under numpy-chosen
moves) and go to both packages; the Flax parameters are made with numpy at
tiny widths (evaluator (4, 4), hidden 8, value (4, 4), hidden 16) and
converted with `afterstate_state_dict_from_flax`.  Tolerances are stated in
each test; the expansion is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.engine.parity import ParityEngine as JParityEngine
from bbx.models import distributions as JD
from bbx.models.afterstate import AfterstateNetwork as JNet
from bbx.models.afterstate import afterstate_planes as j_afterstate_planes
from bbx_torch.engine import pieces as TP
from bbx_torch.engine import state as TState
from bbx_torch.engine.parity import ParityEngine as TParityEngine
from bbx_torch.engine.step import observe as t_observe
from bbx_torch.engine.step import step as t_step
from bbx_torch.models import AfterstateNetwork as TNet
from bbx_torch.models import afterstate as TA
from bbx_torch.models import distributions as TD
from bbx_torch.models import network_from_config
from bbx_torch.models.convert import afterstate_state_dict_from_flax

torch.set_num_threads(1)

TINY = dict(eval_channels=(4, 4), eval_hidden=8, ctx_dim=6,
            value_channels=(4, 4), value_hidden=16)
_j_planes = jax.jit(j_afterstate_planes)
_J_NETS = {dt: JNet(**TINY, dtype=dt) for dt in (jnp.float32, jnp.bfloat16)}
_j_apply = {dt: jax.jit(net.apply) for dt, net in _J_NETS.items()}


def _flax_params(seed, eval_channels=(4, 4), eval_hidden=8, ctx_dim=6,
                 value_channels=(4, 4), value_hidden=16):
    """A Flax AfterstateNetwork param tree of numpy arrays, with random
    kernels and random (non-zero) biases so the bias layout is exercised."""
    rng = np.random.default_rng(seed)

    def layer(*shape):
        fan_in = int(np.prod(shape[:-1]))
        bound = np.sqrt(6.0 / fan_in)
        return {"kernel": rng.uniform(-bound, bound, shape).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, shape[-1]).astype(np.float32)}

    e0, e1 = eval_channels
    v0, v1 = value_channels
    return {
        "Checkpoint_Evaluator_0": {
            "Conv_0": layer(3, 3, 2, e0), "Conv_1": layer(3, 3, e0, e1),
            "Dense_0": layer(64 * e1 + 3 + ctx_dim, eval_hidden),
            "Dense_1": layer(eval_hidden, 1),
        },
        "Conv_0": layer(3, 3, 4, v0), "Conv_1": layer(3, 3, v0, v1),
        "Dense_0": layer(64, ctx_dim), "Dense_1": layer(64 * v1, value_hidden),
        "Dense_2": layer(value_hidden, 1),
    }


def _torch_net(params, dtype):
    net = TNet(**TINY, compute_dtype=dtype)
    net.load_state_dict(afterstate_state_dict_from_flax(params))
    return net.eval()


@pytest.fixture(scope="module")
def reachable_obs():
    """Observations of 8 reachable mid-game states (the port's engine under
    numpy-chosen random valid moves)."""
    rng = np.random.default_rng(3)
    state = TState.reset(8, TState.make_generator(3, "cpu"), "cpu")
    obs = t_observe(state)
    for _ in range(10):
        mask = obs["action_mask"].numpy()
        acts = torch.tensor([rng.choice(np.flatnonzero(m)) for m in mask])
        out = t_step(state, acts, auto_reset=True)
        state, obs = out.state, out.obs
    return {k: v.numpy() for k, v in obs.items()}


def test_afterstate_planes_plain_equal(reachable_obs):
    """The plain expansion == bbx's `afterstate_planes` (exact), on
    reachable boards and on boards with near-full lines."""
    board, pieces = reachable_obs["board"], reachable_obs["pieces"]
    extra = np.zeros((2, 8, 8), np.float32)
    extra[0, 3, :7] = 1.0
    extra[0, :7, 2] = 1.0
    extra[1, :, :] = 1.0
    extra[1, 0, :] = 0.0
    extra[1, 5, 5] = 0.0
    board = np.concatenate([board, extra])
    pieces = np.concatenate([pieces, pieces[:2]])
    want = _j_planes(jnp.asarray(board), jnp.asarray(pieces))
    got = TA.afterstate_planes(torch.from_numpy(board), torch.from_numpy(pieces))
    for name, g, w in zip(("after", "placed", "lines", "overlap"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.asarray(want[2]).max() >= 2  # some move clears two lines


def test_forward_float32_matches(reachable_obs):
    """Converted params, float32: logits and value within atol 1e-4 of JAX
    (float32 convolutions summed in another order); masked logits equal."""
    params = _flax_params(0)
    b, p, m = (reachable_obs[k] for k in ("board", "pieces", "action_mask"))
    jl, jv = _j_apply[jnp.float32]({"params": params}, b, p, m)
    with torch.no_grad():
        tl, tv = _torch_net(params, torch.float32)(
            torch.from_numpy(b), torch.from_numpy(p), torch.from_numpy(m))
    jl, jv = np.asarray(jl), np.asarray(jv)
    np.testing.assert_allclose(tl.numpy()[m], jl[m], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tl.numpy()[~m], jl[~m])
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-4)
    assert np.abs(jl[m]).max() > 0.1  # the comparison is not of zeros


def test_forward_bfloat16_matches(reachable_obs):
    """Converted params, bf16 compute: logits and value within rtol 2e-2 (a
    few bf16 ulps, which are 2**-8 relative) plus atol of 2e-2 x the largest
    magnitude (bf16 rounds sums of terms of that size); masked logits equal."""
    params = _flax_params(1)
    b, p, m = (reachable_obs[k] for k in ("board", "pieces", "action_mask"))
    jl, jv = _j_apply[jnp.bfloat16]({"params": params}, b, p, m)
    with torch.no_grad():
        tl, tv = _torch_net(params, torch.bfloat16)(
            torch.from_numpy(b), torch.from_numpy(p), torch.from_numpy(m))
    jl, jv = np.asarray(jl), np.asarray(jv)
    assert tl.dtype == torch.float32 and tv.dtype == torch.float32
    scale = np.abs(jl[m]).max()
    np.testing.assert_allclose(tl.numpy()[m], jl[m], rtol=2e-2, atol=2e-2 * scale)
    np.testing.assert_array_equal(tl.numpy()[~m], jl[~m])
    np.testing.assert_allclose(tv.numpy(), jv, rtol=2e-2,
                               atol=2e-2 * np.abs(jv).max())


def test_greedy_games_float32_same_actions():
    """Greedy float32 games (seeds 1 and 2) through both packages'
    ParityEngine pick the same action move for move.  Where JAX's top two
    logits lie within 1e-4 a game's comparison stops (float32 sums may order
    a tie either way); at least 20 moves are compared in all."""
    compared = 0
    for seed in (1, 2):
        params = _flax_params(10 + seed)
        net = _torch_net(params, torch.float32)
        je, te = JParityEngine(seed), TParityEngine(seed, device="cpu")
        while not je.game_over:
            mask = je.get_action_mask().reshape(1, 192).copy()
            board = je.board[None].astype(np.float32)
            pieces = (TP.PIECE_MASKS[je.piece_ids]
                      * ~je.used[:, None, None])[None].astype(np.float32)
            jl = np.asarray(_j_apply[jnp.float32](
                {"params": params}, board, pieces, mask)[0])[0]
            with torch.no_grad():
                tl = net(torch.from_numpy(board), torch.from_numpy(pieces),
                         torch.from_numpy(mask))[0][0].numpy()
            top2 = np.sort(jl)[-2:]
            if top2[1] - top2[0] < 1e-4:
                break
            a = int(np.argmax(jl))
            assert int(np.argmax(tl)) == a, f"seed {seed}, move {je.moves_made}"
            slot, cell = divmod(a, 64)
            assert je.make_move(slot, *divmod(cell, 8))
            assert te.make_move(slot, *divmod(cell, 8))
            np.testing.assert_array_equal(te.board, je.board)
            np.testing.assert_array_equal(te.piece_ids, je.piece_ids)
            assert (te.score, te.game_over) == (je.score, je.game_over)
            compared += 1
    assert compared >= 20, compared


def test_converter_loads_run9_widths_strictly():
    """A Flax param tree at run9 widths loads into `network_from_config`
    with every key and shape matched."""
    params = _flax_params(2, eval_channels=(24, 24), eval_hidden=96, ctx_dim=32,
                          value_channels=(48, 64), value_hidden=256)
    assert params["Checkpoint_Evaluator_0"]["Dense_0"]["kernel"].shape == (1571, 96)
    assert params["Dense_1"]["kernel"].shape == (4096, 256)
    net = network_from_config({"type": "afterstate", "compute_dtype": "bfloat16"})
    sd = afterstate_state_dict_from_flax(params)
    net.load_state_dict(sd, strict=True)
    assert net.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in net.state_dict().values())


def test_init_is_kaiming_uniform_with_zero_bias():
    """Weights lie in U(-sqrt(6/fan_in), sqrt(6/fan_in)) with the matching
    variance; biases are zero; one generator seed gives one network."""
    g = torch.Generator().manual_seed(5)
    net = TNet(**TINY, compute_dtype=torch.float32, generator=g)
    for name, t in net.state_dict().items():
        if name.endswith("bias"):
            assert not t.any(), name
            continue
        bound = np.sqrt(6.0 / t[0].numel())
        assert t.abs().max() <= bound, name
    w = net.value_dense0.weight
    assert abs(w.var().item() / (2.0 / w.shape[1]) - 1) < 0.1
    again = TNet(**TINY, compute_dtype=torch.float32,
                 generator=torch.Generator().manual_seed(5))
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_network_from_config_rejects_flat_cnn():
    """The flat CNN is ported now: ``type: cnn`` (the default type) builds a
    `BlockBlastNetwork` with the section's widths and norm, and only an
    unknown compute dtype is rejected."""
    from bbx_torch.models import BlockBlastNetwork

    net = network_from_config({"type": "cnn", "conv_channels": [4, 8],
                               "fc_hidden": [16], "use_batch_norm": False,
                               "compute_dtype": "float32"})
    assert isinstance(net, BlockBlastNetwork)
    assert [c.out_channels for c in net.convs] == [4, 8]
    assert [f.out_features for f in net.fc] == [16]
    assert all(n.kind == "none" for n in net.norms)
    assert isinstance(network_from_config({}), BlockBlastNetwork)
    with pytest.raises(KeyError):
        network_from_config({"type": "cnn", "compute_dtype": "float16"})


# ---------------------------------------------------------------------------
# Distributions.
# ---------------------------------------------------------------------------

def test_distributions_match():
    """mask_logits, mode, log_prob and masked_entropy == bbx (float32, atol
    1e-6); mode takes the first maximal index, as jnp.argmax does."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 192)).astype(np.float32)
    logits[0, [5, 9]] = 7.0  # a tie: the first index wins
    mask = rng.random((6, 192)) < 0.3
    mask[0, [5, 9]] = True
    jm = JD.mask_logits(jnp.asarray(logits), jnp.asarray(mask))
    tm = TD.mask_logits(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(TD.mode(tm).numpy(), np.asarray(JD.mode(jm)))
    assert int(TD.mode(tm)[0]) == 5
    act = np.array(JD.mode(jm))
    np.testing.assert_allclose(TD.log_prob(tm, torch.from_numpy(act)).numpy(),
                               np.asarray(JD.log_prob(jm, jnp.asarray(act))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        TD.masked_entropy(tm, torch.from_numpy(mask)).numpy(),
        np.asarray(JD.masked_entropy(jm, jnp.asarray(mask))), rtol=0, atol=1e-6)


def test_sample_follows_masked_softmax():
    """Draws never hit a masked action, and their frequencies match the
    softmax: chi-square over 4 actions below chi2(3)'s 0.1% value 16.27."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 0.5, 3.0]]).repeat(20000, 1)
    mask = torch.tensor([[True, True, True, True, False]]).repeat(20000, 1)
    draws = TD.sample(torch.Generator().manual_seed(0), TD.mask_logits(logits, mask))
    assert draws.dtype == torch.int32 and not (draws == 4).any()
    p = torch.softmax(logits[0, :4], 0).numpy()
    counts = np.bincount(draws.numpy(), minlength=4)[:4]
    exp = p * len(draws)
    assert ((counts - exp) ** 2 / exp).sum() < 16.27
