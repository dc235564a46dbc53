"""The port's flat networks (`bbx_torch.models.network`) held against
`bbx.models.network`.

Flax variables (params, and BatchNorm's batch_stats) are made by the Flax
init, then every norm scale, bias and running statistic is redrawn with
numpy so that no layer is the identity; they are converted with
`bbx_torch.models.convert` and both networks run the same numpy inputs in
float32 on the CPU.  Tolerances: logits and values within 1e-5 in eval
mode (float32, the same operations summed in other orders by two
convolution libraries) and within 5e-5 in train mode, where every layer
normalises by float32 batch statistics: there bbx's own float32 logits lie
about 2e-5 from a float64 evaluation of the same network, so the port is
held within 1e-5 of that float64 evaluation and within 5e-5 of bbx.
BatchNorm running statistics after a train-mode forward within 1e-6 (a
mean over a few thousand float32 values, moved by 0.1 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.models import network as JN
from bbx_torch.models import network as TN
from bbx_torch.models.convert import (
    actor_critic_state_dict_from_flax,
    block_blast_state_dict_from_flax,
)
from bbx_torch.models.utils import (
    EarlyStopping,
    clip_by_global_norm_,
    get_model_summary,
    global_grad_norm,
    gradient_clipper,
)

torch.set_num_threads(1)

SMALL = dict(conv_channels=(4, 8, 8), fc_hidden=(16, 8))


def _inputs(seed, b=16):
    rng = np.random.default_rng(seed)
    board = (rng.random((b, 8, 8)) < 0.4).astype(np.float32)
    pieces = (rng.random((b, 3, 8, 8)) < 0.2).astype(np.float32)
    mask = rng.random((b, 192)) < 0.3
    mask[:, 0] = True
    return board, pieces, mask


def _redraw(tree, rng, draws):
    """A Flax collection with the leaves named in `draws` redrawn from
    U(lo, hi) with numpy, the others as numpy arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng, draws)
        elif k in draws:
            out[k] = rng.uniform(*draws[k], np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _flax_net(norm="batch", seed=0):
    """bbx's BlockBlastNetwork (dropout off, float32) and its variables:
    every bias and norm scale, and the running statistics, redrawn."""
    net = JN.BlockBlastNetwork(**SMALL, norm=norm, dropout_rate=0.0,
                               dtype=jnp.float32)
    v = net.init({"params": jax.random.key(seed), "dropout": jax.random.key(seed)},
                 jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8)), train=False)
    rng = np.random.default_rng(seed)
    params = _redraw(v["params"], rng, {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)})
    stats = _redraw(v.get("batch_stats", {}), rng,
                    {"mean": (-0.3, 0.3), "var": (0.5, 2.0)})
    return net, params, stats


def _torch_net(params, stats, norm="batch"):
    net = TN.BlockBlastNetwork(**SMALL, norm=norm, dropout_rate=0.0,
                               compute_dtype=torch.float32)
    net.load_state_dict(block_blast_state_dict_from_flax(
        params, stats if norm == "batch" else None))
    return net


def _torch_stats(net):
    return {name: buf.detach().numpy().copy() for name, buf in net.named_buffers()}


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_forward_eval_mode_matches_bbx(norm):
    jnet, params, stats = _flax_net(norm)
    tnet = _torch_net(params, stats, norm).eval()
    board, pieces, mask = _inputs(1)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    jl, jv = jnet.apply(variables, board, pieces, mask, train=False)
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(board), torch.from_numpy(pieces),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert np.asarray(jl)[mask].std() > 1e-3  # the inputs reach the logits


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_forward_train_mode_and_running_stats_match_bbx(norm):
    """Train mode with dropout off: batch statistics in the forward, and the
    running statistics moved as Flax moves them (momentum 0.9, the biased
    batch variance); GroupNorm has none and is the same in both modes."""
    jnet, params, stats = _flax_net(norm)
    tnet = _torch_net(params, stats, norm).train()
    board, pieces, mask = _inputs(2, b=24)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    (jl, jv), mut = jnet.apply(variables, board, pieces, mask, train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(0)})
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(board), torch.from_numpy(pieces),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=5e-5)
    net64 = _torch_net(params, stats, norm).double().train()
    net64.compute_dtype = torch.float64
    with torch.no_grad():
        l64, v64 = net64(*(torch.from_numpy(a).double() for a in (board, pieces)),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), l64.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), v64.numpy(), rtol=0, atol=1e-5)
    if norm == "batch":
        want = block_blast_state_dict_from_flax(params, jax.tree.map(
            np.asarray, mut["batch_stats"]))
        got = _torch_stats(tnet)
        assert set(got) == {k for k in want if "running" in k}
        for name, value in got.items():
            np.testing.assert_allclose(value, want[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
            assert not np.allclose(value, block_blast_state_dict_from_flax(
                params, stats)[name].numpy())  # the statistics moved


def test_parameter_count_equals_flax_at_default_widths():
    for jnet, tnet in ((JN.BlockBlastNetwork(), TN.BlockBlastNetwork()),
                       (JN.ActorCritic(), TN.ActorCritic())):
        v = jax.eval_shape(lambda: jnet.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(0)},
            jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8))))
        want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v["params"]))
        assert TN.count_parameters(tnet) == want
    assert 4_000_000 < TN.count_parameters(TN.BlockBlastNetwork()) < 6_500_000


def test_actor_critic_matches_bbx():
    jnet = JN.ActorCritic(conv_channels=(4, 8, 8), fc_hidden=16, dtype=jnp.float32)
    v = jnet.init(jax.random.key(3), jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8)))
    params = jax.tree.map(np.asarray, v["params"])
    tnet = TN.ActorCritic(conv_channels=(4, 8, 8), fc_hidden=16,
                          compute_dtype=torch.float32)
    tnet.load_state_dict(actor_critic_state_dict_from_flax(params))
    board, pieces, mask = _inputs(3)
    jl, jv = jnet.apply({"params": params}, board, pieces, mask)
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(board), torch.from_numpy(pieces),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_dropout_draws_from_the_generator():
    """Train mode with dropout 0.1: the mask comes from the generator given
    to forward (same state, same output), about 10% of the fc activations
    are dropped and the rest scaled by 1 / 0.9; eval mode drops nothing;
    train mode without a generator raises."""
    net = TN.BlockBlastNetwork(**SMALL, compute_dtype=torch.float32,
                               generator=torch.Generator().manual_seed(1)).train()
    board, pieces, mask = (torch.from_numpy(a) for a in _inputs(4))
    outs = [net(board, pieces, mask, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    other = net(board, pieces, mask, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(outs[0][0], other[0])
    with pytest.raises(ValueError, match="Generator"):
        net(board, pieces, mask)
    x = torch.ones(100_000)
    y = TN._dropout(x, 0.1, torch.Generator().manual_seed(0))
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.1) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    net.eval()
    assert torch.equal(net(board, pieces, mask)[0], net(board, pieces, mask)[0])


def test_model_utils():
    net = TN.BlockBlastNetwork(**SMALL, compute_dtype=torch.float32)
    text = get_model_summary(net, "cnn")
    assert f"total parameters: {TN.count_parameters(net):,}" in text
    assert "norms.0.weight" in text and "running_mean" not in text
    stop = EarlyStopping(patience=2, mode="max")
    assert [stop(v) for v in (1.0, 2.0, 1.5, 1.9, 3.0)] == [False, False, False, True, True]
    grads = [torch.full((3,), 3.0), torch.full((4,), 4.0)]
    norm = float(global_grad_norm(grads))
    assert norm == pytest.approx(np.sqrt(27 + 64))
    gradient_clipper(0.5)(grads)
    assert float(global_grad_norm(grads)) == pytest.approx(0.5, rel=1e-6)
    small = [torch.full((2,), 0.1)]
    clip_by_global_norm_(small, 0.5)
    assert torch.equal(small[0], torch.full((2,), 0.1))
