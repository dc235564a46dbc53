"""The CUDA kernels' own source, run on the CPU, against the plain versions.

`bbx_torch/csrc/*.cu` is compiled as C++20 with ``-DBBX_EMULATE`` against
`tests/cuda_emulation/cuda_runtime.h`, which emulates the few CUDA features
the kernels use (one std::thread per CUDA thread, a std::barrier for
__syncthreads and one per warp for the warp votes; the blocks of a grid
run one after another).  The port's launch helpers (`_*_cuda`) then call those
libraries with CPU tensors, and the outputs must equal the plain PyTorch
versions exactly -- except K8's float scores, which sum in another order
(each test states its tolerance).  K8's tensor-core product is emulated
from the same bf16 operands in float32 (`cuda_emulation/mma_emulation.h`),
which checks its operand addressing but not mma's register fragments.
This checks the kernels' logic here, before the card compiles them;
`tests/test_torch_kernels.py` checks the real build on the card.  Without
a C++ compiler these tests skip.
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

from bbx.engine import solvability as JS
from bbx.models.afterstate import AfterstateNetwork as JNet
from bbx_torch.agent import ppo as P
from bbx_torch.engine import solvability as S
from bbx_torch.engine import state as TState
from bbx_torch.engine import step as TStep
from bbx_torch.engine.step import observe, step
from bbx_torch.engine.tables import tables as TTables
from bbx_torch.models import afterstate as A
from bbx_torch.models.convert import afterstate_state_dict_from_flax
from bbx_torch.ops import build

torch.set_num_threads(1)

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emulation")

# bbx's K1 and K2, jitted once for the module.
_j_valid3 = jax.jit(JS.valid3_bits)
_j_disjoint = jax.jit(JS.solvable_disjoint_bits)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Each kernel library built for the CPU emulator, bound like the real
    one (same symbols and argtypes); under "set_resident:<library>", the
    emulator's `bbx_emulate_set_resident` of that library (the blocks an
    emulated SM holds, 1 unless a test sets more)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler to emulate the CUDA kernels")
    out = tmp_path_factory.mktemp("cuda_emulation")
    procs = {}
    for name, src in build.SOURCES.items():
        lib = str(out / f"lib{name}.so")
        cmd = [cxx, "-std=c++20", "-O2", "-DBBX_EMULATE", "-Wno-unknown-pragmas",
               "-x", "c++", "-shared", "-fPIC", "-I", EMULATION, "-I", build.CSRC,
               "-o", lib, os.path.join(build.CSRC, src), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} does not compile:\n{log}"
        libs[name] = ctypes.CDLL(lib)
    fns = {}
    for name, (lib, symbol, argtypes) in build.SIGNATURES.items():
        fn = getattr(libs[lib], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    for name, lib in libs.items():
        fns[f"set_resident:{name}"] = lib.bbx_emulate_set_resident
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


def _k1_k2_case(which, k):
    """(bits, ids) of k lanes: random boards (10-90% full), reachable ones,
    or edge boards in turn -- empty, full, rows 0-3 full (every valid
    anchor at 32 or above), and rows 0-3 full with the rest half full --
    with random ids in [0, 37)."""
    rng = np.random.default_rng(100 + k)
    if which == "random":
        board, ids = _random(n=k, seed=k)
    elif which == "reachable":
        state, _, ids = _reachable(n=k, moves=8, seed=k)
        board = state.board
    else:
        edges = np.zeros((4, 8, 8), np.uint8)
        edges[1] = 1
        edges[2:, :4] = 1
        edges[3, 4:] = rng.random((4, 8)) < 0.5
        board = torch.from_numpy(edges[np.arange(k) % 4])
        ids = torch.from_numpy(rng.integers(0, 37, (k, 3)).astype(np.int32))
    return S.board_bits(board), ids


def _single_cell_piece():
    return int(np.flatnonzero(TTables("cpu").PIECE_NBLOCKS.numpy() == 1)[0])


def _high_anchor_draw(k):
    """k lanes of three one-cell pieces whose masks allow one
    pairwise-disjoint triple, (40, 41, 5): first anchor 5 is valid too, but
    every triple from it repeats an anchor."""
    ids = torch.full((k, 3), _single_cell_piece(), dtype=torch.int32)
    v3 = torch.zeros((k, 3, 64), dtype=torch.bool)
    v3[:, 0, [5, 40]] = True
    v3[:, 1, [5, 41]] = True
    v3[:, 2, 5] = True
    return torch.zeros((k, 2), dtype=torch.int64), ids, v3


@pytest.mark.parametrize("which", ["random", "reachable", "edges"])
@pytest.mark.parametrize("k", [1, 7, 33])
def test_emulated_k1_k2_match_plain(kernels, which, k):
    """K1 and K2 (emulated) equal their plain versions on k lanes (not
    whole warps or blocks): random, reachable and edge boards (empty, full,
    every valid anchor at 32 or above); K2 also on an all-false valid3 and
    on a draw whose only disjoint triple has its first anchor at 40 (the
    warp's second half).  One launch a call."""
    bits, ids = _k1_k2_case(which, k)
    before = (S.valid3_bits.launches, S.solvable_disjoint_bits.launches)
    v3 = S._valid3_bits_cuda(bits, ids)
    assert torch.equal(v3, S.valid3_bits_plain(bits, ids))
    fast = S._solvable_disjoint_bits_cuda(bits, ids, v3)
    assert torch.equal(fast, S.solvable_disjoint_bits_plain(bits, ids, v3))
    none = torch.zeros_like(v3)
    assert not S._solvable_disjoint_bits_cuda(bits, ids, none).any()
    assert not S.solvable_disjoint_bits_plain(bits, ids, none).any()
    hb, hi, hv = _high_anchor_draw(k)
    assert S._solvable_disjoint_bits_cuda(hb, hi, hv).all()
    assert S.solvable_disjoint_bits_plain(hb, hi, hv).all()
    hv[:, 0, 40] = False
    assert not S._solvable_disjoint_bits_cuda(hb, hi, hv).any()
    after = (S.valid3_bits.launches, S.solvable_disjoint_bits.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 4]
    if which == "edges":
        assert fast[0] and v3[0].any(dim=1).all()
        if k > 2:
            assert not v3[1::4].any() and not fast[1::4].any()
            assert not v3[2::4, :, :32].any() and v3[2::4, :, 32:].any()


@pytest.mark.parametrize("k", [1, 7, 33])
def test_emulated_k1_k2_take_ids_outside_the_table(kernels, k):
    """An id outside [0, 37) gives K1 an all-false row and K2 false (even
    on an all-true valid3, so the table is never read at it); the lanes'
    other rows equal the plain version's."""
    bits, ids = _k1_k2_case("random", k)
    bad = ids.clone()
    rows = torch.arange(k)
    bad[rows, rows % 3] = torch.tensor([37, -1, 1000, -(2 ** 31)], dtype=torch.int32)[rows % 4]
    v3 = S._valid3_bits_cuda(bits, bad)
    want = S.valid3_bits_plain(bits, ids)
    hit = torch.zeros((k, 3), dtype=torch.bool)
    hit[rows, rows % 3] = True
    assert not v3[hit].any() and torch.equal(v3[~hit], want[~hit])
    assert not S._solvable_disjoint_bits_cuda(bits, bad, v3).any()
    assert not S._solvable_disjoint_bits_cuda(bits, bad, torch.ones_like(v3)).any()


def test_emulated_k1_k2_match_bbx(kernels):
    """K1 and K2 (emulated) against bbx's `valid3_bits` and
    `solvable_disjoint_bits` on 33 random and 33 edge lanes and on the
    high-anchor draw: the same masks and the same verdicts."""
    for which in ("random", "edges"):
        bits, ids = _k1_k2_case(which, 33)
        jb, ji = bits.numpy().astype(np.uint32), ids.numpy()
        v3 = S._valid3_bits_cuda(bits, ids)
        jv3 = _j_valid3(jb, ji)
        np.testing.assert_array_equal(v3.numpy(), np.asarray(jv3))
        fast = S._solvable_disjoint_bits_cuda(bits, ids, v3)
        np.testing.assert_array_equal(fast.numpy(), np.asarray(_j_disjoint(jb, ji, jv3)))
        assert fast.any() and (~fast).any()
    hb, hi, hv = _high_anchor_draw(2)
    want = np.asarray(_j_disjoint(hb.numpy().astype(np.uint32), hi.numpy(), hv.numpy()))
    np.testing.assert_array_equal(S._solvable_disjoint_bits_cuda(hb, hi, hv).numpy(), want)
    assert want.all()


def test_emulated_disjoint_wrapper_refuses_misaligned_valid3(kernels):
    """K2 reads valid3 in 16-byte loads: its wrapper refuses a view that
    does not start on 16 bytes, without copying or falling back, and takes
    one that does."""
    bits, ids = _k1_k2_case("random", 7)
    v3 = S.valid3_bits_plain(bits, ids)
    store = torch.zeros(7 * 192 + 32, dtype=torch.bool)
    for offset in (4, 8, 1):
        view = store[offset:offset + 7 * 192].view(7, 3, 64)
        view.copy_(v3)
        with pytest.raises(ValueError, match="16-byte aligned"):
            S._solvable_disjoint_bits_cuda(bits, ids, view)
    view = store[16:16 + 7 * 192].view(7, 3, 64)
    view.copy_(v3)
    assert torch.equal(S._solvable_disjoint_bits_cuda(bits, ids, view),
                       S.solvable_disjoint_bits_plain(bits, ids, v3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_afterstate_kernel_matches_plain(kernels, dtype):
    """K4 at both output dtypes: planes, features and overlap equal to the
    plain version (dtypes and bits too), on reachable boards and boards
    with near-full lines; 26 lanes on the emulator's 3 resident blocks, so
    each block walks several lanes through both buffers."""
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
    before = A.afterstate_buffer.launches
    got = A._afterstate_buffer_cuda(board, pieces, dtype)
    assert A.afterstate_buffer.launches == before + 1
    want = A.afterstate_buffer_plain(board, pieces, dtype)
    for name, g, w in zip(("planes", "feats", "overlap"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    assert want[1][..., 0].max() >= 0.5  # some move clears two lines
    assert (want[1][..., 2] * 5).round().unique().numel() >= 4


def test_emulated_kernels_take_empty_batches(kernels):
    bits = torch.zeros((0, 2), dtype=torch.int64)
    ids = torch.zeros((0, 3), dtype=torch.int32)
    v3 = S._valid3_bits_cuda(bits, ids)
    assert v3.shape == (0, 3, 64)
    assert S._solvable_disjoint_bits_cuda(bits, ids, v3).shape == (0,)
    assert S._solvable_exact_bits_cuda(bits, ids, v3).shape == (0,)
    for dtype in (torch.float32, torch.bfloat16):
        planes, feats, overlap = A._afterstate_buffer_cuda(
            torch.zeros((0, 8, 8)), torch.zeros((0, 3, 8, 8)), dtype)
        assert planes.shape == (0, 192, 8, 8, 2) and planes.dtype == dtype
        assert feats.shape == (0, 192, 3) and feats.dtype == dtype
        assert overlap.shape == (0, 192) and overlap.dtype == torch.bool
    net = _evaluator_net(EVAL_WIDTHS["tiny"], torch.bfloat16, seed=0)
    planes, feats, ctx = net.afterstates(torch.zeros((0, 8, 8)), torch.zeros((0, 3, 8, 8)))
    scores = A._evaluator_scores_cuda(net.evaluator, planes, feats, ctx, torch.bfloat16)
    assert scores.shape == (0,) and scores.dtype == torch.bfloat16
    empty = TState.reset(0, TState.make_generator(0, "cpu"), "cpu")
    blocks = TStep._launch_move(empty, torch.zeros(0, dtype=torch.int32), 0, TTables("cpu"))
    out = blocks.moved()
    assert out[3].shape == (0, 8, 8) and out[11].shape == (0, 3)
    assert out.bits.shape == (0, 2) and out.need.shape == (0,)
    got_ids, got_att = TState._regen_pieces_cuda(
        out.bits, empty.piece_ids, torch.tensor(1, dtype=torch.int64), out.need)
    assert got_ids.shape == (0, 3) and got_att.shape == (0,)
    fin = TStep._step_finish_cuda(empty, blocks, got_ids, got_ids, TStep.RewardConfig(),
                                  True, 0, TTables("cpu"))
    assert fin[0].board.shape == (0, 8, 8) and fin[1]["pieces"].shape == (0, 3, 8, 8)
    adv, ret = P._compute_gae_cuda(P.PPOConfig(), torch.zeros((4, 0)),
                                   torch.zeros((4, 0), dtype=torch.bool),
                                   torch.zeros((4, 0)), torch.zeros(0))
    assert adv.shape == ret.shape == (4, 0)


def test_emulated_move_kernel_matches_plain(kernels):
    """K6's `bbx_move` on reachable boards with used slots, finished lanes,
    streaks, and actions that are valid, invalid, or on a used slot: every
    output equal, dtypes included (the new board's bits and regen's need
    flag too)."""
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
    assert len(got) == len(want) == 17
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, i
        assert torch.equal(g, w), i
    valid, lines = want[0], want[4]
    assert valid.any() and (~valid).any() and (lines > 0).any()
    assert want.need.any() and (~want.need).any()


@pytest.mark.parametrize("n", [1, 33, 96])
def test_emulated_move_blocks_views_match_pointers(kernels, n):
    """`bbx_move`'s blocks: each output's view starts at the pointer the
    kernels are given for it, the views tile both blocks with no gap or
    overlap, and they equal `_move_core_plain`'s outputs (a lone lane and a
    ragged 33 included)."""
    state, obs, _ = _reachable(n=n, moves=6, seed=22)
    rng = np.random.default_rng(22)
    acts = torch.tensor([rng.choice(np.flatnonzero(m))
                         for m in obs["action_mask"].numpy()], dtype=torch.int32)
    blocks = TStep._launch_move(state, acts, 0, TTables("cpu"))
    want = TStep._move_core_plain(state, acts)
    spans = {id(blocks.words): [], id(blocks.raw): []}
    for field, w in zip(want._fields, want):
        v = blocks.view(field)
        assert v.data_ptr() == blocks.ptrs[field], field
        assert v.dtype == w.dtype and v.shape == w.shape and torch.equal(v, w), field
        block = blocks.words if field in TStep._MV_WORD_AT else blocks.raw
        spans[id(block)].append((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size()))
    for block in (blocks.words, blocks.raw):
        edges = sorted(spans[id(block)])
        assert edges[0][0] == block.data_ptr()
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        assert edges[-1][1] == block.data_ptr() + block.numel() * block.element_size()


def _gae_inputs(t_len, n, seed):
    """Seeded rewards, dones (10%, and on every third env at t = T - 1 and
    every second at t = 0), values and last_value."""
    rng = np.random.default_rng(seed)
    dones = rng.random((t_len, n)) < 0.1
    dones[-1, ::3] = True
    dones[0, ::2] = True
    return [torch.from_numpy(a) for a in (
        rng.normal(size=(t_len, n)).astype(np.float32), dones,
        rng.normal(size=(t_len, n)).astype(np.float32),
        rng.normal(size=n).astype(np.float32))]


def _assert_gae_equal(args, cfg=P.PPOConfig(gamma=0.99, gae_lambda=0.95)):
    before = P.compute_gae.launches
    got = P._compute_gae_cuda(cfg, *args)
    want = P.compute_gae_plain(cfg, *args)
    assert P.compute_gae.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_emulated_gae_kernel_matches_plain(kernels):
    """K5 equals the plain version bit for bit (both round every float
    operation on its own, in bbx's order)."""
    _assert_gae_equal(_gae_inputs(16, 40, seed=12))


@pytest.mark.parametrize("t_len", [1, 16, 300])
@pytest.mark.parametrize("n", [1, 40, 45])
def test_emulated_gae_kernel_matches_plain_at_ragged_shapes(kernels, t_len, n):
    """K5 bit for bit at one step, at 16, and at 300 (three of the
    kernel's 128-step chunks, the first partial, A carried across them),
    on one env, 40 (five blocks of 8 envs) and 45 (a last block of 5);
    dones at t = 0 and t = T - 1 in each."""
    _assert_gae_equal(_gae_inputs(t_len, n, seed=t_len * 100 + n))


@pytest.mark.parametrize("which", ["realistic", "all", "full"])
def test_emulated_regen_kernel_matches_plain(kernels, which):
    """K7 equals `regen_pieces_plain` in ids and attempts, bit for bit: on
    reachable boards after a move with the lanes that used their triple in
    need, with every lane in need, and on a full board (no piece fits), where
    every lane spends all 100 attempts and keeps its 100th draw."""
    state, obs, _ = _reachable(n=64, moves=10, seed=7)
    n = state.num_envs
    if which == "full":
        # Few lanes: each of them runs all 100 attempts through both tiers.
        board = torch.ones((4, 8, 8), dtype=torch.uint8)
        need = torch.tensor([True, False, True, True])
        ids = state.piece_ids[:4]
    else:
        rng = np.random.default_rng(13)
        acts = torch.tensor([rng.choice(np.flatnonzero(m))
                             for m in obs["action_mask"].numpy()], dtype=torch.int32)
        moved = TStep._move_core_plain(state, acts)
        board, used_after, valid = moved[3], moved[11], moved[0]
        need = (used_after.all(dim=1) & valid if which == "realistic"
                else torch.ones(n, dtype=torch.bool))
        ids = state.piece_ids
    bits = S.board_bits(board)
    seed = torch.tensor(987654321, dtype=torch.int64)
    before = TState.regen_pieces.launches
    got_ids, got_att = TState._regen_pieces_cuda(bits, ids, seed, need)
    want_ids, want_att = TState.regen_pieces_plain(bits, ids, seed, need)
    assert TState.regen_pieces.launches == before + 1
    assert torch.equal(got_ids, want_ids) and torch.equal(got_att, want_att)
    assert torch.equal(got_ids[~need], ids[~need]) and (got_att[~need] == 0).all()
    if which == "full":
        assert (want_att[need] == TState.MAX_REGEN_ATTEMPTS).all()
    else:
        assert need.any() and (want_att[need] >= 1).all()
    if which == "all":
        assert (want_att > 1).any()  # some lane needed a second draw


def _regen_case(which):
    """(bits, ids, need) of a K7 edge case: no lane in need; N = 77 (not a
    multiple of 32) with some in need; 20 lanes (one partial chunk); a lone
    lane; 160 crowded random boards (half to three quarters full), all in
    need, where the exact tier decides many draws (seed 4's make a round's
    last exact-tier item decisive for one draw)."""
    if which.startswith("crowded"):
        rng = np.random.default_rng(int(which.split("_")[1]))
        fills = rng.uniform(0.5, 0.75, 160)[:, None, None]
        board = torch.from_numpy((rng.random((160, 8, 8)) < fills).astype(np.uint8))
        ids = torch.from_numpy(rng.integers(0, 37, (160, 3)).astype(np.int32))
        return S.board_bits(board), ids, torch.ones(160, dtype=torch.bool)
    n = {"none": 64, "ragged": 77, "partial_chunk": 20, "one_lane": 1}[which]
    state, obs, _ = _reachable(n=n, moves=10, seed=8)
    rng = np.random.default_rng(14)
    acts = torch.tensor([rng.choice(np.flatnonzero(m))
                         for m in obs["action_mask"].numpy()], dtype=torch.int32)
    moved = TStep._move_core_plain(state, acts)
    need = {"none": torch.zeros(n, dtype=torch.bool),
            "ragged": torch.from_numpy(rng.random(n) < 0.4),
            "partial_chunk": torch.from_numpy(rng.random(n) < 0.5),
            "one_lane": torch.ones(n, dtype=torch.bool)}[which]
    need[-1] = which != "none"  # the ragged chunk's last lane
    return moved.bits, state.piece_ids, need


@pytest.mark.parametrize("which", ["none", "ragged", "partial_chunk", "one_lane",
                                   "crowded_4", "crowded_17"])
def test_emulated_regen_kernel_edge_cases(kernels, which):
    """K7 equals `regen_pieces_plain` with no lane in need, with N not a
    multiple of its 32-lane chunks, with fewer lanes than one chunk, and on
    crowded boards where the exact tier decides."""
    bits, ids, need = _regen_case(which)
    seed = torch.tensor(424242, dtype=torch.int64)
    want = TState.regen_pieces_plain(bits, ids, seed, need)
    got = TState._regen_pieces_cuda(bits, ids, seed, need)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(want[0][~need], ids[~need]) and (want[1][~need] == 0).all()
    assert (want[1][need] >= 1).all()


def _finish_inputs(seed=16):
    """`bbx_step_finish`'s inputs on reachable boards with finished lanes,
    used slots, streaks, valid and random (often invalid) actions, and 12
    lanes on a crowded board (empty cells only where (r + c) % 4 == 0: two
    in every row and column, no two side by side) that place their last
    unused piece, a single cell, and get a regen triple of pieces with two
    cells side by side, none of which fits: they end their game."""
    state, _, _ = _reachable(n=96, moves=18, seed=seed)
    rng = np.random.default_rng(seed)
    n = state.num_envs
    single = int(np.flatnonzero(TTables("cpu").PIECE_NBLOCKS.numpy() == 1)[0])
    board = state.board.clone()
    ids = state.piece_ids.clone()
    used = torch.from_numpy(rng.random((n, 3)) < 0.3)
    crowded = np.add.outer(np.arange(8), np.arange(8)) % 4 != 0
    board[:12] = torch.from_numpy(crowded.astype(np.uint8))
    ids[:12, 0] = single
    used[:12] = torch.tensor([False, True, True])
    state = state.replace(
        board=board, piece_ids=ids, used=used,
        done=torch.from_numpy((rng.random(n) < 0.1) & (np.arange(n) >= 12)),
        streak=torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)),
        prev_holes=torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)),
        prev_center=torch.from_numpy(rng.choice([0.75, 0.875, 1.0], n).astype(np.float32)),
        ep_return=torch.from_numpy(rng.normal(size=n).astype(np.float32)),
        ep_len=torch.from_numpy(rng.integers(0, 50, n).astype(np.int32)))
    mask = observe(state.replace(done=torch.zeros(n, dtype=torch.bool)))
    mask = mask["action_mask"].numpy()
    acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() and i % 4 else
                     rng.integers(192) for i, m in enumerate(mask)], np.int32)
    acts[:12] = 0  # slot 0 at cell (0, 0), which is empty
    acts = torch.from_numpy(acts)
    moved = TStep._move_core_plain(state, acts)
    masks = TTables("cpu").PIECE_MASKS.numpy() > 0
    side_by_side = np.flatnonzero((masks[:, :, 1:] & masks[:, :, :-1]).any((1, 2))
                                  | (masks[:, 1:] & masks[:, :-1]).any((1, 2)))
    regen = torch.from_numpy(rng.integers(0, 37, (n, 3)).astype(np.int32))
    regen[:12] = torch.from_numpy(rng.choice(side_by_side, (12, 3)).astype(np.int32))
    ids_after = torch.where(moved.need[:, None], regen, state.piece_ids)
    fresh = torch.from_numpy(rng.integers(0, 37, (n, 3)).astype(np.int32))
    return state, acts, moved, ids_after, fresh


def _assert_step_outputs_equal(got, want):
    """(state, obs, reward, done, info[, regen_attempts]) equal, bit for
    bit and dtype for dtype."""
    g_state, w_state = got[0], want[0]
    for f in ("board", "piece_ids", "used", "score", "streak", "moves",
              "lines_total", "max_streak", "blocks_total", "done", "prev_holes",
              "prev_center", "ep_return", "ep_len"):
        g, w = getattr(g_state, f), getattr(w_state, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype and torch.equal(got[1][k], want[1][k]), k
    assert set(got[4]) == set(want[4])
    for k in want[4]:
        assert got[4][k].dtype == want[4][k].dtype and torch.equal(got[4][k], want[4][k]), k
    for g, w in zip(got[2:4], want[2:4]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(got[5:], want[5:]):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("auto_reset", [True, False])
def test_emulated_step_finish_kernel_matches_plain(kernels, auto_reset):
    """K6's `bbx_step_finish`, on `bbx_move`'s blocks as the step passes
    them, equals `_step_finish_plain` bit for bit (the reward and episode
    return too) on lanes with invalid actions, finished lanes, lanes in need
    of regen and lanes whose game ends, with auto-reset on (the default
    rewards) and off (other coefficients, which round differently to
    float32)."""
    state, acts, moved, ids_after, fresh = _finish_inputs()
    rc = TStep.RewardConfig() if auto_reset else TStep.RewardConfig(
        line_clear_base=1.3, block_placed=0.017, game_over_penalty=-2.1,
        hole_penalty=-0.07, center_bonus=0.03, combo_multiplier_bonus=0.45,
        survival_bonus=0.0013)
    tb = TTables("cpu")
    blocks = TStep._launch_move(state, acts, 0, tb)
    before = TStep._step_finish_cuda.launches
    got = TStep._step_finish_cuda(state, blocks, ids_after, fresh, rc, auto_reset, 0, tb)
    want = TStep._step_finish_plain(state, moved, ids_after, fresh, rc, auto_reset)
    assert TStep._step_finish_cuda.launches == before + 1
    _assert_step_outputs_equal(got, want)
    done = want[3]
    assert done[:12].all() and (~moved.valid).any() and state.done.any()
    assert (moved.need & ~done).any() and (moved.lines > 0).any()
    if auto_reset:
        assert (want[0].board[:12] == 0).all() and torch.equal(want[0].piece_ids[:12], fresh[:12])
    else:
        assert want[0].done[:12].all()


def test_emulated_step_matches_plain_step(kernels):
    """The whole step through the emulated K6 (both entry points) and K7
    against the plain step: two fleets of 64 lanes from one seed, 40 steps
    of numpy-chosen actions (valid, and every fifth lane's random), with
    auto-reset for 30 steps and without for 10; every state field, the obs,
    reward, done, info and regen's attempts equal at every step, the
    generator's draws alike, and each kernel launched once a step."""
    n, steps = 64, 40
    plain = TState.reset(n, TState.make_generator(21, "cpu"), "cpu")
    emul = TState.reset(n, TState.make_generator(21, "cpu"), "cpu")
    obs = observe(plain)
    rng = np.random.default_rng(21)
    counters = (TStep._move_core, TStep._step_finish_cuda, TState.regen_pieces)
    before = [c.launches for c in counters]
    ended = regen = 0
    for i in range(steps):
        mask = obs["action_mask"].numpy()
        acts = torch.tensor([rng.choice(np.flatnonzero(m)) if m.any() and (i + k) % 5
                             else rng.integers(192) for k, m in enumerate(mask)],
                            dtype=torch.int32)
        want = TStep._step_plain(plain, acts, TStep.RewardConfig(), i < 30)
        got = TStep._step_cuda(emul, acts, TStep.RewardConfig(), i < 30)
        _assert_step_outputs_equal(got, want)
        assert torch.equal(plain.rng.get_state(), emul.rng.get_state())
        ended += int(want.done.sum())
        regen += int((want.regen_attempts > 0).sum())
        plain, emul, obs = want.state, got.state, want.obs
    assert [c.launches - b for c, b in zip(counters, before)] == [steps] * 3
    assert ended > 0 and regen > 0 and plain.done.any()


# ---------------------------------------------------------------------------
# K8: the evaluator's forward.
# ---------------------------------------------------------------------------

# (eval_channels, eval_hidden, ctx_dim): the tests' tiny widths, run9's, and
# widths that fill no padded tile (channels, hidden and ctx not multiples
# of 8).
EVAL_WIDTHS = {"tiny": ((4, 4), 8, 6), "run9": ((24, 24), 96, 32),
               "ragged": ((5, 12), 20, 7), "limits": ((32, 32), 128, 256)}


def _evaluator_net(widths, dtype, seed):
    """An AfterstateNetwork at `widths` with Kaiming weights and non-zero
    biases (so the biases' layout is exercised), from a numpy seed."""
    (c1, c2), hidden, ctx = widths
    net = A.AfterstateNetwork(eval_channels=(c1, c2), eval_hidden=hidden, ctx_dim=ctx,
                              value_channels=(4, 4), value_hidden=8, compute_dtype=dtype,
                              generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32)))
    return net


def _evaluator_inputs(net, lanes, seed):
    """K8's inputs for `lanes` reachable states (a slot used in some), as
    the network builds them: K4's planes and features and the context."""
    state, obs, _ = _reachable(n=max(lanes, 2), moves=5, seed=seed)
    board, pieces = obs["board"][:lanes], obs["pieces"][:lanes].clone()
    if lanes > 1:
        pieces[1, 0] = 0.0  # a used slot: its context and planes change
    return net.afterstates(board.float().contiguous(), pieces.contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths,lanes", [("tiny", 1), ("tiny", 3), ("run9", 1),
                                          ("run9", 3), ("ragged", 3), ("limits", 1)])
def test_emulated_evaluator_kernel_matches_plain(kernels, widths, lanes, dtype):
    """K8 (emulated) against `evaluator_scores_plain` on the same inputs:
    one lane (3 tiles of 64 afterstates in bf16, 12 of 16 in float32, in 3
    slots) and three (each lane's three context rows), at the tiny, run9
    and ragged widths and at the width limits (whose float32 shared memory
    fits the card's only in tiles of 16; the emulator refuses what the
    card refuses) (the tiles divide a lane's 192 afterstates, so no row
    tile is partial; the ragged widths leave the k and n tiles partial).
    float32: within 1e-5 (sums in another order).  bf16: within rtol 2e-2
    plus atol 2e-2 x the largest score (the bf16 tolerance of the forward
    tests: K8 rounds each layer once after its bias where the CPU's
    convolution rounds before the bias is added, and sums in another
    order, a bf16 ulp or two a layer)."""
    net = _evaluator_net(EVAL_WIDTHS[widths], dtype, seed=lanes)
    planes, feats, ctx = _evaluator_inputs(net, lanes, seed=8 + lanes)
    before = A.evaluator_scores.launches
    with torch.no_grad():
        got = A._evaluator_scores_cuda(net.evaluator, planes, feats, ctx, dtype)
        want = A.evaluator_scores_plain(net.evaluator, planes, feats, ctx, dtype)
    assert A.evaluator_scores.launches == before + 1
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (lanes * 192,)
    assert torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    assert scale > 0.1  # the comparison is not of zeros
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_evaluator_kernel_with_a_tile_a_block(emulated, kernels, dtype):
    """K8 (emulated) on two lanes with 8 resident blocks an emulated SM: its
    persistent grid then has a block for each tile (6 of 64 afterstates in
    bf16, 24 of 16 in float32, against 24 blocks), where with one resident
    block each of the 3 blocks walks 2 or 8 tiles, its next tile's planes
    and features landing while the current one computes; the same bits
    both ways (every sum in the same order), run9 widths."""
    net = _evaluator_net(EVAL_WIDTHS["run9"], dtype, seed=4)
    planes, feats, ctx = _evaluator_inputs(net, 2, seed=12)
    with torch.no_grad():
        walked = A._evaluator_scores_cuda(net.evaluator, planes, feats, ctx, dtype)
        set_resident = emulated["set_resident:evaluator"]
        set_resident(8)
        try:
            one_each = A._evaluator_scores_cuda(net.evaluator, planes, feats, ctx, dtype)
        finally:
            set_resident(1)
        want = A.evaluator_scores_plain(net.evaluator, planes, feats, ctx, dtype)
    assert torch.equal(one_each, walked)
    scale = want.float().abs().max().item()
    assert scale > 0.1
    if dtype == torch.float32:
        torch.testing.assert_close(walked, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(walked.float(), want.float(), rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_network_with_evaluator_kernel_matches_bbx(kernels, monkeypatch, dtype):
    """The port's whole no-grad forward with K8 (emulated) and K4
    (emulated) in place of their plain versions, against bbx's
    AfterstateNetwork on the same Flax parameters (bbx's init, biases made
    non-zero) and the same three reachable states: the tolerances of
    `tests/test_torch_afterstate.py`'s forward tests (float32: atol 1e-4;
    bf16: rtol 2e-2 plus atol 2e-2 x the largest magnitude); masked logits
    equal."""
    tiny = dict(eval_channels=(4, 4), eval_hidden=8, ctx_dim=6, value_channels=(4, 4),
                value_hidden=16)
    _, obs, _ = _reachable(n=3, moves=6, seed=31)
    b, p, m = (obs[k].numpy() for k in ("board", "pieces", "action_mask"))
    b = b.astype(np.float32)
    jnet = JNet(**tiny, dtype=getattr(jnp, dtype))
    params = jax.device_get(jnet.init(jax.random.PRNGKey(3), b, p, m)["params"])
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(x), params)
    jl, jv = (np.asarray(x) for x in jnet.apply({"params": params}, b, p, m))
    net = A.AfterstateNetwork(**tiny, compute_dtype=getattr(torch, dtype))
    net.load_state_dict(afterstate_state_dict_from_flax(params))
    routed = {}
    for name, cuda in (("afterstate_buffer", A._afterstate_buffer_cuda),
                       ("evaluator_scores", A._evaluator_scores_cuda)):
        def via_kernel(*args, _cuda=cuda):
            return _cuda(*args)
        via_kernel.launches = 0
        routed[name] = via_kernel
        monkeypatch.setattr(A, name, via_kernel)
    with torch.no_grad():
        tl, tv = net(*(torch.from_numpy(x) for x in (b, p, m)))
    assert routed["afterstate_buffer"].launches == routed["evaluator_scores"].launches == 1
    tl, tv = tl.numpy(), tv.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl[m], jl[m], rtol=0, atol=1e-4)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(tl[m], jl[m], rtol=2e-2, atol=2e-2 * np.abs(jl[m]).max())
        np.testing.assert_allclose(tv, jv, rtol=2e-2, atol=2e-2 * np.abs(jv).max())
    np.testing.assert_array_equal(tl[~m], jl[~m])
    assert np.abs(jl[m]).max() > 0.1


def test_emulated_evaluator_kernel_states_its_limits(kernels):
    """K8 takes two convolutions of at most 32 channels, a hidden width of
    at most 128 and a context of at most 256; the wrapper raises a
    ValueError beyond them (on the card it never falls back)."""
    size = build.function("evaluator_layout_size")
    assert size(32, 32, 128, 256) > 0 and size(1, 1, 1, 1) > 0
    for widths in ((33, 8, 8, 8), (8, 33, 8, 8), (8, 8, 129, 8), (8, 8, 8, 257),
                   (0, 8, 8, 8)):
        assert size(*widths) == 0, widths
    for widths in (((33, 4), 8, 6), ((4, 4), 129, 6), ((4, 4, 4), 8, 6)):
        (chans, hidden, ctx) = widths
        net = A.AfterstateNetwork(eval_channels=chans, eval_hidden=hidden, ctx_dim=ctx,
                                  value_channels=(4, 4), value_hidden=8,
                                  compute_dtype=torch.bfloat16)
        planes, feats, ctx_t = _evaluator_inputs(net, 1, seed=2)
        with pytest.raises(ValueError, match="K8 takes"):
            A._evaluator_scores_cuda(net.evaluator, planes, feats, ctx_t, torch.bfloat16)
