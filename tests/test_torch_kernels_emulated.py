"""The CUDA kernels' own source, run on the CPU, against the plain versions.

`bbx_torch/csrc/*.cu` is compiled as C++20 with ``-DBBX_EMULATE`` against
`tests/cuda_emulation/cuda_runtime.h`, which emulates the few CUDA features
the kernels use (one std::thread per CUDA thread, a std::barrier for
__syncthreads).  The port's launch helpers (`_*_cuda`) then call those
libraries with CPU tensors, and the outputs must equal the plain PyTorch
versions exactly.  This checks the kernels' logic here, before the card
compiles them; `tests/test_torch_kernels.py` checks the real build on the
card.  Without a C++ compiler these tests skip.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bbx_torch.agent import ppo as P
from bbx_torch.engine import solvability as S
from bbx_torch.engine import state as TState
from bbx_torch.engine import step as TStep
from bbx_torch.engine.step import observe, step
from bbx_torch.models import afterstate as A
from bbx_torch.ops import build

torch.set_num_threads(1)

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emulation")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Each kernel library built for the CPU emulator, bound like the real
    one (same symbols and argtypes)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler to emulate the CUDA kernels")
    out = tmp_path_factory.mktemp("cuda_emulation")
    procs = {}
    for name, src in build.SOURCES.items():
        lib = str(out / f"lib{name}.so")
        cmd = [cxx, "-std=c++20", "-O1", "-DBBX_EMULATE", "-Wno-unknown-pragmas",
               "-x", "c++", "-shared", "-fPIC", "-I", EMULATION, "-I", build.CSRC,
               "-o", lib, os.path.join(build.CSRC, src), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} does not compile:\n{log}"
        symbol, argtypes = build.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The launch helpers routed to the emulated libraries, with the
    wrappers' dtype, shape and contiguity checks kept."""
    def require(name, t, dtype, shape):
        assert t.dtype == dtype, (name, t.dtype)
        assert tuple(t.shape) == tuple(shape), (name, tuple(t.shape))
        assert t.is_contiguous(), name

    monkeypatch.setattr(build, "function", emulated.__getitem__)
    monkeypatch.setattr(build, "require", require)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)


def _reachable(n=96, moves=14, seed=5):
    """n reachable states (the port's engine under numpy-chosen random
    valid moves) and a random triple for each."""
    rng = np.random.default_rng(seed)
    state = TState.reset(n, TState.make_generator(seed, "cpu"), "cpu")
    obs = observe(state)
    for _ in range(moves):
        mask = obs["action_mask"].numpy()
        acts = torch.tensor([rng.choice(np.flatnonzero(m)) for m in mask])
        out = step(state, acts, auto_reset=True)
        state, obs = out.state, out.obs
    ids = torch.from_numpy(rng.integers(0, 37, (n, 3)).astype(np.int32))
    return state, obs, ids


def _random(n=96, seed=1):
    rng = np.random.default_rng(seed)
    fills = rng.uniform(0.1, 0.9, n)
    board = (rng.random((n, 8, 8)) < fills[:, None, None]).astype(np.uint8)
    ids = rng.integers(0, 37, (n, 3)).astype(np.int32)
    return torch.from_numpy(board), torch.from_numpy(ids)


@pytest.mark.parametrize("which", ["random", "reachable"])
def test_emulated_verdict_kernels_match_plain(kernels, which):
    if which == "random":
        board, ids = _random()
    else:
        state, _, ids = _reachable()
        board = state.board
    bits = S.board_bits(board)
    before = (S.valid3_bits.launches, S.solvable_disjoint_bits.launches,
              S.solvable_exact_bits.launches)
    v3 = S._valid3_bits_cuda(bits, ids)
    assert torch.equal(v3, S.valid3_bits_plain(bits, ids))
    fast = S._solvable_disjoint_bits_cuda(bits, ids, v3)
    assert torch.equal(fast, S.solvable_disjoint_bits_plain(bits, ids, v3))
    exact = S._solvable_exact_bits_cuda(bits, ids, v3)
    assert torch.equal(exact, S.solvable_exact_bits_plain(bits, ids, v3))
    assert fast.any() and (~fast).any() and exact.any() and (~exact).any()
    after = (S.valid3_bits.launches, S.solvable_disjoint_bits.launches,
             S.solvable_exact_bits.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_emulated_afterstate_kernel_matches_plain(kernels):
    _, obs, _ = _reachable(n=24)
    board, pieces = obs["board"], obs["pieces"]
    extra = torch.zeros((2, 8, 8))
    extra[0, 3, :7] = 1.0
    extra[0, :7, 2] = 1.0
    extra[1] = 1.0
    extra[1, 0, :] = 0.0
    extra[1, 5, 5] = 0.0
    board = torch.cat([board, extra])
    pieces = torch.cat([pieces, pieces[:2]])
    got = A._afterstate_buffer_cuda(board, pieces)
    want = A.afterstate_buffer_plain(board, pieces)
    for name, g, w in zip(("planes", "lines", "overlap"), got, want):
        assert torch.equal(g, w), name
    assert want[1].max() >= 2


def test_emulated_kernels_take_empty_batches(kernels):
    bits = torch.zeros((0, 2), dtype=torch.int64)
    ids = torch.zeros((0, 3), dtype=torch.int32)
    v3 = S._valid3_bits_cuda(bits, ids)
    assert v3.shape == (0, 3, 64)
    assert S._solvable_exact_bits_cuda(bits, ids, v3).shape == (0,)
    planes, lines, overlap = A._afterstate_buffer_cuda(torch.zeros((0, 8, 8)),
                                                       torch.zeros((0, 3, 8, 8)))
    assert planes.shape == (0, 192, 2, 8, 8) and lines.shape == (0, 192)
    empty = TState.reset(0, TState.make_generator(0, "cpu"), "cpu")
    out = TStep._move_core_cuda(empty, torch.zeros(0, dtype=torch.int32))
    assert out[3].shape == (0, 8, 8) and out[11].shape == (0, 3)
    adv, ret = P._compute_gae_cuda(P.PPOConfig(), torch.zeros((4, 0)),
                                   torch.zeros((4, 0), dtype=torch.bool),
                                   torch.zeros((4, 0)), torch.zeros(0))
    assert adv.shape == ret.shape == (4, 0)


def test_emulated_move_kernel_matches_plain(kernels):
    """K6 on reachable boards with used slots, finished lanes, streaks, and
    actions that are valid, invalid, or on a used slot: every output equal,
    dtypes included."""
    state, _, _ = _reachable(n=96, moves=18, seed=6)
    rng = np.random.default_rng(11)
    n = state.num_envs
    state = state.replace(
        used=torch.from_numpy(rng.random((n, 3)) < 0.3),
        done=torch.from_numpy(rng.random(n) < 0.1),
        streak=torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)))
    mask = observe(state.replace(done=torch.zeros(n, dtype=torch.bool)))
    mask = mask["action_mask"].numpy()
    acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() and i % 4 else
                     rng.integers(192) for i, m in enumerate(mask)], np.int32)
    before = TStep._move_core.launches
    got = TStep._move_core_cuda(state, torch.from_numpy(acts))
    want = TStep._move_core_plain(state, torch.from_numpy(acts))
    assert TStep._move_core.launches == before + 1
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, i
        assert torch.equal(g, w), i
    valid, lines = want[0], want[4]
    assert valid.any() and (~valid).any() and (lines > 0).any()


def test_emulated_gae_kernel_matches_plain(kernels):
    """K5 equals the plain version bit for bit (both round every float
    operation on its own, in bbx's order)."""
    rng = np.random.default_rng(12)
    t_len, n = 16, 40
    dones = rng.random((t_len, n)) < 0.1
    dones[-1, ::3] = True
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(t_len, n)).astype(np.float32), dones,
        rng.normal(size=(t_len, n)).astype(np.float32),
        rng.normal(size=n).astype(np.float32))]
    cfg = P.PPOConfig(gamma=0.99, gae_lambda=0.95)
    before = P.compute_gae.launches
    got = P._compute_gae_cuda(cfg, *args)
    want = P.compute_gae_plain(cfg, *args)
    assert P.compute_gae.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
