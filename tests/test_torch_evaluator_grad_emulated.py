"""K8's backward (`bbx_torch/csrc/evaluator_backward.cu`) run on the CPU
through the CUDA emulator, against the plain evaluator's autograd.

The kernels are compiled as in `tests/test_torch_kernels_emulated.py`
(whose fixtures this file uses): C++20 against
`tests/cuda_emulation/cuda_runtime.h`, the tensor-core product emulated
from the same bf16 operands in float32.  A tile's backward takes many
block barriers, about 130 us each on the emulator, so the cases stay at 1-3
lanes, and at the update's 32 lanes once, at tiny widths.  Tolerances, each
gradient tensor g against the plain version's g_plain:
  float32: |g - g_plain| <= 1e-5 |g_plain| + 1e-5 max |g_plain| (sums in
    another order);
  bf16: |g - g_plain| <= 2e-2 |g_plain| + 2e-2 max |g_plain| (K8's forward
    tolerance: K8 rounds each layer once after its bias where the plain
    convolution rounds before it too, so a ReLU mask may flip at a
    pre-activation within rounding of 0).
K8w alone is held to dz0^T x0 in float64 within K8W_REL of its largest
element (float32 sums of exact products).  Without a C++ compiler these
tests skip.
"""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbx.agent import ppo as JPPO
from bbx_torch.models import afterstate as A
from bbx_torch.ops import build
from test_torch_kernels_emulated import (  # noqa: F401  (fixtures)
    EMULATION,
    EVAL_WIDTHS,
    _evaluator_inputs,
    _evaluator_net,
    emulated,
    kernels,
)
from test_torch_ppo import (  # noqa: F401  (fixture)
    _J_TX,
    _assert_update_equal,
    _flax_params,
    _j_update,
    _torch_net,
    _torch_update,
    trajectory,
)

torch.set_num_threads(1)

K8W_REL = 1e-5
PARAM_NAMES = ("convs.0.weight", "convs.0.bias", "convs.1.weight", "convs.1.bias",
               "dense0.weight", "dense0.bias", "dense1.weight", "dense1.bias")
GRAD_COUNTERS = (A._evaluator_grad_tiles, A._evaluator_grad_dense0, A._evaluator_grad_reduce)


def _plain_grads(net, planes, feats, ctx, ds, dtype):
    """The plain evaluator's gradients of <scores, ds>: ctx's and the eight
    parameters' (the checkpointed path computes the same)."""
    ev = net.evaluator
    ev.zero_grad()
    leaf = ctx.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = A.evaluator_scores_plain(ev, planes, feats, leaf, dtype)
        scores.backward(ds)
    params = dict(ev.named_parameters())
    return leaf.grad, [params[k].grad.clone() for k in PARAM_NAMES]


def _assert_grad_close(got, want, rel, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    g, w = got.double(), want.double()
    bound = rel * w.abs() + rel * w.abs().max()
    worst = ((g - w).abs() - bound).max().item()
    assert worst <= 0, (name, worst, (g - w).abs().max().item(), w.abs().max().item())


@pytest.mark.parametrize("widths,lanes,dtype", [
    ("tiny", 1, torch.float32), ("tiny", 1, torch.bfloat16),
    ("tiny", 3, torch.float32), ("tiny", 3, torch.bfloat16),
    ("ragged", 3, torch.float32), ("ragged", 3, torch.bfloat16),
    ("run9", 1, torch.bfloat16)])
def test_emulated_evaluator_grads_match_plain_autograd(kernels, widths, lanes, dtype):
    """K8b, K8w and the reduction (emulated) against the plain evaluator's
    autograd and against their plain version (`evaluator_grads_plain`) on
    the same inputs and the same upstream gradient (numpy, seeded): the
    context's gradient and all eight parameters', within the module
    docstring's tolerances; one launch of each; a second run gives the
    same bits.  Tiny and ragged widths (partial k and n tiles) on 1
    and 3 lanes in both dtypes, and run9's widths on one lane in bf16 (the
    update's)."""
    net = _evaluator_net(EVAL_WIDTHS[widths], dtype, seed=lanes + 20)
    planes, feats, ctx = _evaluator_inputs(net, lanes, seed=8 + lanes)
    rng = np.random.default_rng(lanes)
    ds = torch.from_numpy(rng.normal(size=lanes * 192).astype(np.float32)).to(dtype)
    want_ctx, want = _plain_grads(net, planes, feats, ctx, ds, dtype)
    before = [c.launches for c in GRAD_COUNTERS]
    with torch.no_grad():
        got_ctx, got = A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds, dtype)
    assert [c.launches - b for c, b in zip(GRAD_COUNTERS, before)] == [1, 1, 1]
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    _assert_grad_close(got_ctx, want_ctx, rel, "ctx")
    for name, g, w in zip(PARAM_NAMES, got, want):
        assert g.dtype == torch.float32
        _assert_grad_close(g, w, rel, name)
        assert w.abs().max() > 0, name  # the comparison is not of zeros
    again_ctx, again = A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds, dtype)
    assert torch.equal(again_ctx, got_ctx)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    # And against its plain version (K8's rounding points, tensor ops), on
    # its own ReLU decisions and on K8b's (`relu_masks`), which agree.
    with torch.no_grad():
        work = A._GradWork(net.evaluator, planes, feats, ctx, ds, dtype)
        A._evaluator_grad_tiles(work)
        masks = work.relu_masks()
    plain_ctx, plain, pre = A.evaluator_grads_plain(net.evaluator, planes, feats, ctx, ds, dtype)
    for layer, z in pre.items():
        assert masks[layer].shape == z.shape and torch.equal(masks[layer], z > 0), layer
    _assert_grad_close(got_ctx, plain_ctx, rel, "ctx (plain version)")
    for name, g, w in zip(PARAM_NAMES, got, plain):
        _assert_grad_close(g, w, rel, name + " (plain version)")


@pytest.mark.parametrize("widths,lanes,dtype,resident", [
    ("tiny", 1, torch.bfloat16, 1), ("tiny", 3, torch.bfloat16, 8),
    ("ragged", 3, torch.bfloat16, 8), ("run9", 1, torch.bfloat16, 8),
    ("tiny", 3, torch.float32, 8), ("ragged", 1, torch.float32, 8),
    ("ragged", 3, torch.float32, 1)])
def test_emulated_k8w_matches_float64(emulated, kernels, widths, lanes, dtype, resident):
    """K8w alone (emulated: the producer warp's bulk copies into the ring
    of stages, its barriers, the consumer warps' products) on seeded x0 and
    dz0 written in K8b's tile layout (bf16 chunks permuted): the splits'
    partials summed against dz0^T x0 in float64 within K8W_REL of its
    largest element; one launch; a second run gives the same bits.  1 and
    3 lanes (6 and 18 tiles of 32 afterstates in bf16, 12 and 36 of 16 in
    float32, against a ring of 5 stages), at widths whose x0 columns fill
    no whole 128-column tile (tiny: 528, ragged: 1,040, run9: 1,576), and
    with 1 or 8 resident blocks an emulated SM, so that the tiles split 1
    to 4 ways."""
    net = _evaluator_net(EVAL_WIDTHS[widths], dtype, seed=lanes)
    planes, feats, ctx = _evaluator_inputs(net, lanes, seed=lanes)
    ds = torch.zeros(lanes * 192, dtype=dtype)
    set_resident = emulated["set_resident:evaluator_backward"]
    set_resident(resident)
    try:
        w = A._GradWork(net.evaluator, planes, feats, ctx, ds, dtype)
        m, (c1, c2), h = lanes * 192, EVAL_WIDTHS[widths][0], EVAL_WIDTHS[widths][1]
        hp, kx = (h + 7) // 8 * 8, w.x0.numel() // m
        hk = w.dz0.numel() // m
        t = 32 if dtype == torch.bfloat16 else 16
        cols = -(-kx // 128)
        splits = min(max(3 * resident // cols, 1), m // t)
        assert w.plan["k8w_stages"] == 5 and w.plan["k8w_splits"] == splits
        assert w.partw.numel() == splits * hp * kx
        rng = np.random.default_rng(lanes + 40)
        x0 = torch.from_numpy(rng.normal(size=(m, kx)).astype(np.float32)).to(dtype)
        dz0 = torch.zeros((m, hk), dtype=dtype)
        dz0[:, :h] = torch.from_numpy(rng.normal(size=(m, h)).astype(np.float32)).to(dtype)
        w.x0.copy_(A.grad_tile_layout(x0))
        w.dz0.copy_(A.grad_tile_layout(dz0))
        assert torch.equal(w.x0_matrix(), x0) and torch.equal(w.dz0_matrix(), dz0)
        before = A._evaluator_grad_dense0.launches
        A._evaluator_grad_dense0(w)
        assert A._evaluator_grad_dense0.launches == before + 1
        got = w.partw.clone()
        A._evaluator_grad_dense0(w)
    finally:
        set_resident(1)
    assert torch.equal(w.partw, got)
    exact = dz0[:, :hp].double().t() @ x0.double()
    total = got.view(splits, hp, kx).double().sum(0)
    assert torch.isfinite(total).all()
    assert (total - exact).abs().max() <= K8W_REL * exact.abs().max()


@pytest.mark.parametrize("widths,lanes,dtype", [("tiny", 3, torch.bfloat16),
                                                 ("ragged", 3, torch.float32)])
def test_emulated_reduction_matches_float64(emulated, kernels, widths, lanes, dtype):
    """The reduction alone (emulated) on the records, K8w's partials and the
    tiles' dz0 sums that K8b and K8w wrote, with 8 resident blocks an
    emulated SM, so that K8b writes one record a tile (18 records in bf16,
    24 of 36 tiles in float32): the eight gradients and dctx against the
    same sums taken in float64 (`_GradWork.reduce_plain`), rounded to the
    compute dtype, within the module docstring's tolerances; one launch; a
    second run gives the same bits."""
    net = _evaluator_net(EVAL_WIDTHS[widths], dtype, seed=lanes + 50)
    planes, feats, ctx = _evaluator_inputs(net, lanes, seed=lanes + 3)
    ds = torch.from_numpy(np.random.default_rng(lanes + 7).normal(size=lanes * 192)
                          .astype(np.float32)).to(dtype)
    set_resident = emulated["set_resident:evaluator_backward"]
    set_resident(8)
    try:
        with torch.no_grad():
            w = A._GradWork(net.evaluator, planes, feats, ctx, ds, dtype)
            A._evaluator_grad_tiles(w)
            A._evaluator_grad_dense0(w)
            before = A._evaluator_grad_reduce.launches
            A._evaluator_grad_reduce(w)
            assert A._evaluator_grad_reduce.launches == before + 1
            got_ctx, got = w.dctx.clone(), w.flat.clone()
            A._evaluator_grad_reduce(w)
    finally:
        set_resident(1)
    assert w.plan["k8b_blocks"] == min(3 * 8, lanes * 192 // (32 if dtype == torch.bfloat16
                                                                 else 16))
    assert torch.equal(w.dctx, got_ctx) and torch.equal(w.flat, got)
    want_ctx, want = w.reduce_plain(torch.float64)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    _assert_grad_close(got_ctx, want_ctx, rel, "ctx")
    assert want_ctx.abs().max() > 0
    sizes = [p.numel() for p in net.evaluator.parameters()]
    for name, g, w_ in zip(PARAM_NAMES, got.split(sizes), want.split(sizes)):
        _assert_grad_close(g, w_, rel, name)
        assert w_.abs().max() > 0 or name == "dense1.bias", name


def _backward_with_smem_limit(tmp_path, limit):
    """`evaluator_backward.cu` built for the emulator with a shared-memory
    limit of `limit` bytes, bound like the real one."""
    cxx = shutil.which("g++") or shutil.which("c++")
    lib = str(tmp_path / f"libevaluator_backward_{limit}.so")
    subprocess.run([cxx, "-std=c++20", "-O1", "-DBBX_EMULATE", f"-DEVB_SMEM_LIMIT={limit}",
                    "-Wno-unknown-pragmas", "-x", "c++", "-shared", "-fPIC", "-I", EMULATION,
                    "-I", build.CSRC, "-o", lib,
                    os.path.join(build.CSRC, "evaluator_backward.cu"), "-lpthread"],
                   check=True, capture_output=True)
    handle, fns = ctypes.CDLL(lib), {}
    for name, (library, symbol, argtypes) in build.SIGNATURES.items():
        if library == "evaluator_backward":
            fns[name] = getattr(handle, symbol)
            fns[name].argtypes, fns[name].restype = argtypes, ctypes.c_int
    return fns


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulated_evaluator_grads_with_da1_over_da2t(emulated, kernels, monkeypatch, tmp_path,
                                                     dtype):
    """K8b's layout for widths whose shared memory is short (at the width
    limits), reached at tiny widths by building the library with less
    shared memory: da1's row over da2t's, where the data group waits for
    dW2's reads before it writes da1, and for dW1's before the next da2.
    The same bits as the full layout's (the same sums in the same order),
    the context's and all eight parameters' gradients, one lane."""
    net = _evaluator_net(EVAL_WIDTHS["tiny"], dtype, seed=31)
    planes, feats, ctx = _evaluator_inputs(net, 1, seed=9)
    ds = torch.from_numpy(np.random.default_rng(5).normal(size=192).astype(np.float32)).to(dtype)
    assert A._GradWork(net.evaluator, planes, feats, ctx, ds, dtype).plan["k8b_da1_apart"] == 1
    want_ctx, want = A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds, dtype)
    fns = _backward_with_smem_limit(tmp_path, 1)
    monkeypatch.setattr(build, "function", lambda name: fns.get(name) or emulated[name])
    assert A._GradWork(net.evaluator, planes, feats, ctx, ds, dtype).plan["k8b_da1_apart"] == 0
    got_ctx, got = A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds, dtype)
    assert torch.equal(got_ctx, want_ctx)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_emulated_evaluator_grads_take_an_empty_batch(kernels):
    net = _evaluator_net(EVAL_WIDTHS["tiny"], torch.bfloat16, seed=0)
    planes, feats, ctx = net.afterstates(torch.zeros((0, 8, 8)), torch.zeros((0, 3, 8, 8)))
    ds = torch.zeros(0, dtype=torch.bfloat16)
    dctx, grads = A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds, torch.bfloat16)
    assert dctx.shape == (0, 3, 6) and dctx.dtype == torch.bfloat16
    for g, p in zip(grads, net.evaluator.parameters()):
        assert g.shape == p.shape and g.dtype == torch.float32 and not g.any()


def test_emulated_update_through_evaluator_kernels_matches_bbx(kernels, monkeypatch,
                                                               trajectory):
    """One PPO update (2 epochs of one 32-lane minibatch, float32, tiny
    widths) whose evaluator runs `EvaluatorFunction` -- K8 forward and K8's
    backward, emulated -- on the CPU tensors, against bbx's jitted update
    on the same Flax parameters: `_assert_update_equal`'s tolerances
    (metrics rtol 1e-5, parameters atol 1e-6 + 1e-3 lr, dense1's bias
    within Adam's step bound)."""
    traj, adv, ret = trajectory
    params = _flax_params(5)
    calls = []

    def via_kernels(evaluator, planes, feats, ctx, dtype):
        calls.append(torch.is_grad_enabled())
        ps = [p for _, p in evaluator.named_parameters()]
        return A.EvaluatorFunction.apply(evaluator, planes, feats, ctx, dtype, *ps)

    monkeypatch.setattr(A, "evaluator_scores_autograd", via_kernels)
    before = [c.launches for c in (A.evaluator_scores, *GRAD_COUNTERS)]
    ts, metrics = _torch_update(_torch_net(params), None, 0, traj, adv, ret)
    launched = [c.launches - b for c, b in zip((A.evaluator_scores, *GRAD_COUNTERS), before)]
    assert launched == [2, 2, 2, 2] and all(calls)
    jts0 = JPPO.TrainState(params=jax.tree.map(jnp.asarray, params), batch_stats={},
                           opt_state=_J_TX.init(params), update_step=jnp.int32(0))
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    jts1, jm1 = _j_update(jts0, jtraj, jnp.asarray(adv), jnp.asarray(ret),
                          jax.random.key(1))
    _assert_update_equal(ts, metrics, jts1, jm1)


def test_evaluator_dispatch_on_cpu_takes_the_checkpointed_plain_path(monkeypatch):
    """On CPU tensors `evaluator_scores_autograd` runs the plain evaluator
    under `torch.utils.checkpoint` when gradients are on (no kernel and no
    `EvaluatorFunction`), the plain evaluator alone when they are off; planes
    or features that require a gradient raise, as `EvaluatorFunction` does."""
    net = _evaluator_net(EVAL_WIDTHS["tiny"], torch.float32, seed=3)
    planes, feats, ctx = _evaluator_inputs(net, 2, seed=4)
    calls = []
    real = A.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(A, "checkpoint", spy)
    monkeypatch.setattr(A.EvaluatorFunction, "apply", None)
    counters = [c.launches for c in (A.evaluator_scores, *GRAD_COUNTERS)]
    leaf = ctx.detach().requires_grad_(True)
    scores = A.evaluator_scores_autograd(net.evaluator, planes, feats, leaf, torch.float32)
    assert calls == [{"use_reentrant": False}] and scores.requires_grad
    scores.square().sum().backward()
    assert leaf.grad.abs().max() > 0 and net.evaluator.dense0.weight.grad.abs().max() > 0
    with torch.no_grad():
        plain = A.evaluator_scores_autograd(net.evaluator, planes, feats, ctx, torch.float32)
    assert len(calls) == 1 and torch.equal(plain, scores.detach())
    assert [c.launches for c in (A.evaluator_scores, *GRAD_COUNTERS)] == counters
    for bad in (planes.clone().requires_grad_(True), feats.clone().requires_grad_(True)):
        args = (bad, feats) if bad.dim() == 5 else (planes, bad)
        with pytest.raises(ValueError, match="carry no gradient"):
            A.evaluator_scores_autograd(net.evaluator, *args, ctx, torch.float32)


def test_evaluator_function_refuses_input_gradients(kernels):
    """`EvaluatorFunction` raises for planes or features that require a
    gradient: K4 writes them, and they carry none."""
    net = _evaluator_net(EVAL_WIDTHS["tiny"], torch.float32, seed=3)
    planes, feats, ctx = _evaluator_inputs(net, 1, seed=4)
    ps = list(net.evaluator.parameters())
    for bad in ("planes", "feats"):
        args = {"planes": planes, "feats": feats}
        args[bad] = args[bad].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="carry no gradient"):
            A.EvaluatorFunction.apply(net.evaluator, args["planes"], args["feats"], ctx,
                                      torch.float32, *ps)
