"""The CUDA kernels' own source, run on the CPU, against the plain versions.

`bbx_torch/csrc/*.cu` is compiled as C++20 with ``-DBBX_EMULATE`` against
`tests/cuda_emulation/cuda_runtime.h`, which emulates the few CUDA features
the kernels use (one std::thread per CUDA thread, a std::barrier for
__syncthreads and one per warp for the warp votes; the blocks of a grid
run one after another).  The port's launch helpers (`_*_cuda`) then call those
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
from bbx_torch.engine.tables import tables as TTables
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
    assert S._solvable_exact_bits_cuda(bits, ids, v3).shape == (0,)
    for dtype in (torch.float32, torch.bfloat16):
        planes, feats, overlap = A._afterstate_buffer_cuda(
            torch.zeros((0, 8, 8)), torch.zeros((0, 3, 8, 8)), dtype)
        assert planes.shape == (0, 192, 8, 8, 2) and planes.dtype == dtype
        assert feats.shape == (0, 192, 3) and feats.dtype == dtype
        assert overlap.shape == (0, 192) and overlap.dtype == torch.bool
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
