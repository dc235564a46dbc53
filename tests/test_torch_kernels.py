"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  This file imports
neither JAX nor `bbx`, so it also runs on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(`--noconftest` because `tests/conftest.py` imports JAX).  Kernel outputs
are bool, integer or 0/1 float, and must equal the plain version exactly.
"""
import json

import numpy as np
import pytest
import torch

from bbx_torch.agent import ppo as P
from bbx_torch.agent.trainer import PPOTrainer
from bbx_torch.cli import evaluate as TE
from bbx_torch.device import float32_exact
from bbx_torch.engine import solvability as S
from bbx_torch.engine import step as TStep
from bbx_torch.engine import state as TState
from bbx_torch.engine.parity import ParityEngine
from bbx_torch.engine.step import observe, step
from bbx_torch.engine.tables import tables as TTables
from bbx_torch.env import vector as V
from bbx_torch.models import afterstate as A
from bbx_torch.models import network_from_config
from bbx_torch.utils.checkpoints import save_checkpoint

TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "bfloat16"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _midgame(device, n=256, moves=14, seed=5):
    """Reachable states: n lanes of random valid play on `device`."""
    g = TState.make_generator(seed, device)
    state = TState.reset(n, g, device)
    obs = observe(state)
    for _ in range(moves):
        u = torch.rand(obs["action_mask"].shape, generator=g, device=device)
        out = step(state, torch.where(obs["action_mask"], u, -1.0).argmax(1),
                   auto_reset=True)
        state, obs = out.state, out.obs
    ids = torch.randint(0, 37, (n, 3), generator=g, device=device,
                        dtype=torch.int32)
    return state, obs, ids


def _random_boards(device, n=256, seed=1):
    rng = np.random.default_rng(seed)
    fills = rng.uniform(0.1, 0.9, n)
    raw = (rng.random((n, 8, 8)) < fills[:, None, None]).astype(np.uint8)
    ids = rng.integers(0, 37, (n, 3)).astype(np.int32)
    return torch.from_numpy(raw).to(device), torch.from_numpy(ids).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 256, 16384])
@pytest.mark.parametrize("which", ["random", "reachable"])
def test_verdict_kernels_match_plain(cuda, which, n):
    """K1, K2 and K3 equal their plain versions on one lane (the parity
    engine's shape), 256 and 16,384; each takes one launch a call, and
    nothing else on the card."""
    if which == "random":
        board, ids = _random_boards(cuda, n=n)
    else:
        state, _, ids = _midgame(cuda, n=n)
        board = state.board
    bits = S.board_bits(board)
    v3 = S.valid3_bits(bits, ids)
    assert torch.equal(v3, S.valid3_bits_plain(bits, ids))
    fast = S.solvable_disjoint_bits(bits, ids, v3)
    assert torch.equal(fast, S.solvable_disjoint_bits_plain(bits, ids, v3))
    exact = S.solvable_exact_bits(bits, ids, v3)
    assert torch.equal(exact, S.solvable_exact_bits_plain(bits, ids, v3))
    if n > 1:
        assert fast.any() and (~fast).any() and (~exact).any()
    _assert_one_launch_a_call(lambda: S.valid3_bits(bits, ids), "valid3_kernel")
    _assert_one_launch_a_call(lambda: S.solvable_disjoint_bits(bits, ids, v3),
                              "disjoint_kernel")
    _assert_one_launch_a_call(lambda: S.solvable_exact_bits(bits, ids, v3), "exact_kernel")


def _one_gap_boards(n, device):
    """n boards with no full line: row r = lane % 8 free at columns c and
    c + 1 (c = lane // 8 % 7), each other row free at one cell, one in each
    column but c and c + 1 and a second in column c + 4 (mod 8).  The only
    two free cells side by side are the gap's, and the columns beside it
    (c - 1, c + 2) have one free cell each, so no 3x3 square comes free
    beside the gap's columns when they clear."""
    lane = torch.arange(n, device=device)
    row, col = lane % 8, (lane // 8) % 7
    board = torch.ones((n, 8, 8), dtype=torch.uint8, device=device)
    board[lane, row, col] = 0
    board[lane, row, col + 1] = 0
    for k in range(1, 8):
        other = (col + 2 + (k - 1 if k < 7 else 2)) % 8  # never c or c + 1
        board[lane, (row + k) % 8, other] = 0
    return board


@pytest.mark.gpu
def test_exact_kernel_where_line_clears_decide(cuda):
    """K3 at 4,096 lanes of `_one_gap_boards`: three horizontal dominoes
    are solvable only through the gap's row, which the first completes
    (exact true, disjoint false); with the 3x3 square third, never (the
    first clears one row and two columns).  Bit for bit with the plain
    version, one launch a call."""
    tb = TTables(cuda)
    flat = tb.PLACEMENT[:, 0].reshape(-1, 8, 8)
    domino = int((tb.PIECE_NBLOCKS == 2).logical_and(flat[:, 0, 1]).nonzero()[0])
    square = int((tb.PIECE_NBLOCKS == 9).nonzero()[0])
    n = 4096
    bits = S.board_bits(_one_gap_boards(n, cuda))
    ids = torch.full((n, 3), domino, dtype=torch.int32, device=cuda)
    ids[1::2, 2] = square
    v3 = S.valid3_bits(bits, ids)
    got = S.solvable_exact_bits(bits, ids, v3)
    assert torch.equal(got, S.solvable_exact_bits_plain(bits, ids, v3))
    assert got[0::2].all() and not got[1::2].any()
    assert not S.solvable_disjoint_bits(bits, ids, v3).any()
    _assert_one_launch_a_call(lambda: S.solvable_exact_bits(bits, ids, v3), "exact_kernel")


def _assert_k4_equal(board, pieces, dtype):
    got = A.afterstate_buffer(board, pieces, dtype)
    want = A.afterstate_buffer_plain(board, pieces, dtype)
    for name, a, b in zip(("planes", "feats", "overlap"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_afterstate_kernel_matches_plain(cuda, dtype):
    _, obs, _ = _midgame(cuda, n=64)
    _assert_k4_equal(obs["board"], obs["pieces"], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_afterstate_kernel_matches_plain_at_update_minibatch(cuda, dtype):
    """At run9's minibatch of 2048, on the planes the update rebuilds from
    its compact buffer (used slots zeroed)."""
    state, obs, _ = _midgame(cuda, n=2048)
    mb = P._minibatch_obs({"board": state.board, "mask": obs["action_mask"],
                           "piece_ids": state.piece_ids.to(torch.int8),
                           "used": state.used})
    board, pieces = mb["board"].contiguous(), mb["pieces"].contiguous()
    assert not pieces.flatten(2).any(2).all()
    _assert_k4_equal(board, pieces, dtype)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """Each wrapper raises on a tensor its kernel does not take, before any
    launch: another dtype, shape or device, or a tensor that is not
    contiguous."""
    bits = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        S.valid3_bits(bits, ids.long())
    with pytest.raises(ValueError, match="shape"):
        S.valid3_bits(bits, ids[:3])
    v3 = S.valid3_bits(bits, ids)
    with pytest.raises(ValueError, match="contiguous"):
        S.solvable_exact_bits(bits, ids, v3.transpose(0, 1).contiguous().transpose(0, 1))
    store = torch.zeros(4 * 192 + 16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        S.solvable_disjoint_bits(bits, ids, store[4:4 + 4 * 192].view(4, 3, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        S.solvable_exact_bits(bits, ids, store[4:4 + 4 * 192].view(4, 3, 64))
    board = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        A.afterstate_buffer(board.half(), torch.zeros((2, 3, 8, 8), device=cuda),
                            torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        A.afterstate_buffer(board, torch.zeros((2, 3, 8, 8), device=cuda), torch.float16)
    # K8: the inputs' dtype and shape, and widths beyond its limits.
    net = network_from_config(TINY_NET).to(cuda)
    planes, feats, ctx = net.afterstates(board, torch.zeros((2, 3, 8, 8), device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        A.evaluator_scores(net.evaluator, planes.float(), feats, ctx, torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        A.evaluator_scores(net.evaluator, planes, feats, ctx[:, :2].contiguous(),
                           torch.bfloat16)
    wide = network_from_config(dict(TINY_NET, eval_channels=[4, 40])).to(cuda)
    with pytest.raises(ValueError, match="K8 takes"):
        A.evaluator_scores(wide.evaluator, planes, feats, ctx, torch.bfloat16)
    # K8's backward: the gradient's dtype and shape, the widths, and planes
    # that require a gradient.
    ds = torch.zeros(2 * 192, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds.float(), torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        A._evaluator_grads_cuda(net.evaluator, planes, feats, ctx, ds[:191], torch.bfloat16)
    with pytest.raises(ValueError, match="K8 takes"):
        A._evaluator_grads_cuda(wide.evaluator, planes, feats, ctx, ds, torch.bfloat16)
    with pytest.raises(ValueError, match="carry no gradient"):
        A.evaluator_scores_autograd(net.evaluator, planes.clone().requires_grad_(True),
                                    feats, ctx, torch.bfloat16)
    # K9: the mask's dtype and shape, the seed's dtype.
    mask = torch.ones((4, 192), dtype=torch.bool, device=cuda)
    seed = torch.tensor(7, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        V._sample_valid_actions_cuda(mask.to(torch.uint8), seed)
    with pytest.raises(ValueError, match="shape"):
        V._sample_valid_actions_cuda(mask[:, :191], seed)
    with pytest.raises(ValueError, match="int64"):
        V._sample_valid_actions_cuda(mask, seed.int())
    # K6's two entry points, the step and K7.
    state = TState.reset(4, TState.make_generator(0, cuda), cuda)
    acts = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        TStep._move_core(state, acts[:3])
    with pytest.raises(ValueError, match="CUDA"):
        step(state, acts.cpu())
    with pytest.raises(ValueError, match="int32"):
        step(state.replace(score=state.score.long()), acts)
    with pytest.raises(ValueError, match="contiguous"):
        step(state.replace(used=state.used.t().contiguous().t()), acts)
    moved = TStep._move_core(state, acts)
    seed = TState.regen_seed(state.rng, cuda)
    with pytest.raises(ValueError, match="int64"):
        TState.regen_pieces(moved.bits.int(), state.piece_ids, seed, moved.need)


@pytest.mark.gpu
def test_parity_engine_on_card_matches_cpu(cuda):
    moves_rng = np.random.default_rng(3)
    a, b = ParityEngine(3, device="cpu"), ParityEngine(3, device=cuda)
    while not a.game_over:
        vm = a.get_valid_moves()
        assert b.get_valid_moves() == vm
        mv = vm[moves_rng.integers(len(vm))]
        a.make_move(*mv)
        b.make_move(*mv)
        np.testing.assert_array_equal(a.board, b.board)
        np.testing.assert_array_equal(a.piece_ids, b.piece_ids)
        assert (a.score, a.game_over) == (b.score, b.game_over)


@pytest.mark.gpu
def test_forward_bfloat16_card_matches_cpu(cuda):
    """One bf16 forward on the card against the same network on the CPU:
    logits within rtol 2e-2 plus atol 2e-2 x the largest magnitude (bf16
    rounds at other places in cuDNN and on the CPU); masked logits equal."""
    _, obs, _ = _midgame(torch.device("cpu"), n=8)
    net = network_from_config(TINY_NET, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        lc, vc = net(obs["board"], obs["pieces"], obs["action_mask"])
        lg, vg = net.to(cuda)(*(obs[k].to(cuda) for k in
                                ("board", "pieces", "action_mask")))
    m = obs["action_mask"]
    lg, vg = lg.cpu(), vg.cpu()
    scale = lc[m].abs().max().item()
    torch.testing.assert_close(lg[m], lc[m], rtol=2e-2, atol=2e-2 * scale)
    assert torch.equal(lg[~m], lc[~m])
    torch.testing.assert_close(vg, vc, rtol=2e-2, atol=2e-2 * vc.abs().max().item())


@pytest.mark.gpu
def test_evaluate_main_on_card_launches_every_kernel(cuda, tmp_path):
    """The eval path launches K1, K4, K6, K7 and K8; the verdict tiers K2
    and K3 run inside K7, so their standalone kernels are not launched."""
    counters = (S.valid3_bits, A.afterstate_buffer, TStep._move_core,
                TState.regen_pieces, A.evaluator_scores)
    net = network_from_config(TINY_NET, generator=torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path), "tiny.pt", {"params": net.state_dict()},
                           config={"network": TINY_NET})
    for fn in (*counters, S.solvable_disjoint_bits, S.solvable_exact_bits):
        fn.launches = 0
    out = str(tmp_path / "r.json")
    assert TE.main(["--checkpoint", ckpt, "--episodes", "64",
                    "--deterministic", "--output", out]) == 0
    with open(out) as f:
        assert json.load(f)["completed"] == 64
    assert all(fn.launches > 0 for fn in counters), [fn.launches for fn in counters]
    assert S.solvable_disjoint_bits.launches == S.solvable_exact_bits.launches == 0


@pytest.mark.gpu
def test_move_kernel_matches_plain(cuda):
    """K6: every output equal to the plain version, dtypes included, with
    used slots, finished lanes, streaks, and valid and random actions."""
    state, obs, _ = _midgame(cuda, n=512)
    g = torch.Generator(device=cuda).manual_seed(4)
    n = state.num_envs
    state = state.replace(
        used=torch.rand((n, 3), generator=g, device=cuda) < 0.3,
        done=torch.rand(n, generator=g, device=cuda) < 0.1,
        streak=torch.randint(0, 9, (n,), generator=g, device=cuda,
                             dtype=torch.int32))
    u = torch.rand((n, 192), generator=g, device=cuda)
    acts = torch.where(torch.arange(n, device=cuda) % 4 == 0,
                       torch.randint(0, 192, (n,), generator=g, device=cuda),
                       torch.where(obs["action_mask"], u, -1.0).argmax(1))
    before = TStep._move_core.launches
    got = TStep._move_core(state, acts)
    want = TStep._move_core_plain(state, acts)
    assert TStep._move_core.launches == before + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    assert (want[4] > 0).any() and (~want[0]).any()


def _assert_one_launch_a_call(fn, kernel):
    """One call of `fn` launches `kernel` once and nothing else on the card:
    the call captured into a CUDA graph is one node, a kernel node of that
    function, read through libcuda (`torch.profiler` can lose a launch's
    record)."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    assert count.value == 1, count.value
    node_type = ctypes.c_int(-1)
    assert cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[0]), ctypes.byref(node_type)) == 0
    assert node_type.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS: the function first
    assert cuda.cuGraphKernelNodeGetParams(ctypes.c_void_p(nodes[0]), params) == 0
    name = ctypes.c_char_p()
    assert cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])) == 0
    assert kernel in name.value.decode(), name.value


@pytest.mark.gpu
def test_gae_kernel_matches_plain_bit_for_bit(cuda):
    """K5 bit for bit at run9's [128, 512], default's [128, 64] and
    tpu.yaml's [128, 4096], and at ragged shapes: one step, three of the
    kernel's 128-step chunks, envs that fill no whole block; dones at t = 0
    and t = T - 1.  One launch a call, and nothing else on the card."""
    g = torch.Generator(device=cuda).manual_seed(5)
    cfg = P.PPOConfig()
    for t_len, n in ((128, 512), (128, 64), (128, 4096), (1, 45), (300, 45), (257, 1)):
        args = (torch.randn((t_len, n), generator=g, device=cuda),
                torch.rand((t_len, n), generator=g, device=cuda) < 0.02,
                torch.randn((t_len, n), generator=g, device=cuda),
                torch.randn(n, generator=g, device=cuda))
        args[1][0, ::2] = True
        args[1][-1, ::3] = True
        before = P.compute_gae.launches
        got = P.compute_gae(cfg, *args)
        assert P.compute_gae.launches == before + 1
        for a, b in zip(got, P.compute_gae_plain(cfg, *args)):
            assert torch.equal(a, b), (t_len, n)
    _assert_one_launch_a_call(lambda: P.compute_gae(cfg, *args), "gae_kernel")
    with pytest.raises(ValueError, match="float32"):
        P.compute_gae(cfg, args[0].double(), *args[1:])


@pytest.mark.gpu
def test_trainer_on_card_launches_every_kernel_and_resumes(cuda, tmp_path):
    """Two tiny PPO iterations on the card launch the train path's kernels
    (K1, K4-K8 and K8's backward; K2 and K3 run inside K7): K8 on each
    rollout step and the last value (8 + 1 a rollout) and in every update
    minibatch (2 epochs x 2 minibatches an update), K8b, K8w and the
    reduction once in every update minibatch; a saved run loads and runs
    one more finite iteration."""
    cfg = {"training": {"num_envs": 16, "rollout_steps": 8, "batch_size": 64},
           "ppo": {"num_epochs": 2, "final_learning_rate": 1e-4},
           "network": dict(TINY_NET)}
    grads = (A._evaluator_grad_tiles, A._evaluator_grad_dense0, A._evaluator_grad_reduce)
    counters = (S.valid3_bits, A.afterstate_buffer, P.compute_gae,
                TStep._move_core, TState.regen_pieces, A.evaluator_scores, *grads)
    for fn in counters:
        fn.launches = 0
    tr = PPOTrainer(cfg, seed=3, total_timesteps=512, device=cuda)
    for _ in range(2):
        m = {k: float(v) for k, v in tr.iterate().items()}
        assert all(np.isfinite(v) for v in m.values()), m
    assert P.compute_gae.launches == 2
    assert A.evaluator_scores.launches == 2 * (8 + 1) + 2 * 4
    assert [fn.launches for fn in grads] == [2 * 4] * 3
    assert all(fn.launches > 0 for fn in counters), [fn.launches for fn in counters]
    path = tr.save(str(tmp_path), "mid")
    tr2 = PPOTrainer(cfg, seed=3, total_timesteps=512, device=cuda)
    tr2.load(path)
    assert tr2.global_step == 2 * 128
    m = {k: float(v) for k, v in tr2.iterate().items()}
    assert all(np.isfinite(v) for v in m.values()), m


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["realistic", "all"])
def test_regen_kernel_matches_plain(cuda, which):
    """K7 against `regen_pieces_plain` on the same seed tensor, bit for bit
    in ids and attempts, at 4,096 mid-game lanes: the lanes that used
    their triple with a random valid move in need, then every lane."""
    state, obs, _ = _midgame(cuda, n=4096, moves=24, seed=9)
    g = torch.Generator(device=cuda).manual_seed(9)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
    acts = torch.where(obs["action_mask"], u, -1.0).argmax(1).to(torch.int32)
    moved = TStep._move_core(state, acts)
    valid, board, used_after = moved[0], moved[3], moved[11]
    need = (used_after.all(dim=1) & valid if which == "realistic"
            else torch.ones_like(valid))
    bits = S.board_bits(board)
    seed = TState.regen_seed(g, cuda)
    before = TState.regen_pieces.launches
    got = TState.regen_pieces(bits, state.piece_ids, seed, need)
    assert TState.regen_pieces.launches == before + 1
    want = TState.regen_pieces_plain(bits, state.piece_ids, seed, need)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert need.any() and (want[1][need] >= 1).all() and (want[1][~need] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("lane_base", [0, 256])
def test_regen_kernel_lane_base(cuda, lane_base):
    """K7 on each rank's 256 lanes of a 512-lane fleet (lane base 0 and
    256: rank 1's lanes hash as lanes 256-511) against
    `regen_pieces_plain` at the same base, bit for bit, and against those
    lanes of the whole fleet regenerated from lane 0."""
    state, obs, _ = _midgame(cuda, n=512, moves=25, seed=11)
    g = torch.Generator(device=cuda).manual_seed(11)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
    acts = torch.where(obs["action_mask"], u, -1.0).argmax(1).to(torch.int32)
    moved = TStep._move_core(state, acts)
    need = moved[11].all(dim=1) & moved[0]
    bits = S.board_bits(moved[3])
    seed = TState.regen_seed(g, cuda)
    whole = TState.regen_pieces(bits, state.piece_ids, seed, need)
    rows = slice(lane_base, lane_base + 256)
    part = (bits[rows].contiguous(), state.piece_ids[rows].contiguous(), seed,
            need[rows].contiguous())
    got = TState.regen_pieces(*part, lane_base=lane_base)
    want = TState.regen_pieces_plain(*part, lane_base=lane_base)
    for a, b, w in zip(got, want, whole):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, w[rows])
    assert need[rows].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 16384])
def test_regen_kernel_matches_plain_at_path_lanes(cuda, n):
    """K7 against `regen_pieces_plain` on the inputs of one step of a
    mid-game fleet at the eval/train paths' 512 lanes and the engine path's
    16,384, bit for bit; K7's attempts equal the step's `regen_attempts`
    when the step runs from the same generator state."""
    state, obs, _ = _midgame(cuda, n=n, moves=25, seed=11)
    g = torch.Generator(device=cuda).manual_seed(11)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
    acts = torch.where(obs["action_mask"], u, -1.0).argmax(1).to(torch.int32)
    rng_state = state.rng.get_state()
    moved = TStep._move_core(state, acts)
    need = moved[11].all(dim=1) & moved[0]
    bits = S.board_bits(moved[3])
    seed = TState.regen_seed(state.rng, cuda)
    state.rng.set_state(rng_state)
    got = TState.regen_pieces(bits, state.piece_ids, seed, need)
    want = TState.regen_pieces_plain(bits, state.piece_ids, seed, need)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert need.any()
    assert torch.equal(step(state, acts, auto_reset=True).regen_attempts, got[1])


@pytest.mark.gpu
def test_step_makes_no_host_sync(cuda):
    """A step of a mid-game fleet on the card runs under sync-debug mode
    "error": regen (K7) and the rest of the step never wait for the host."""
    state, obs, _ = _midgame(cuda, n=1024)
    g = torch.Generator(device=cuda).manual_seed(3)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
    acts = torch.where(obs["action_mask"], u, -1.0).argmax(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(state, acts, auto_reset=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.reward.shape == (1024,)


def _finish_inputs(device, n, auto_reset, seed=13):
    """`bbx_step_finish`'s inputs for one step of a mid-game fleet of n
    lanes on the card, as the step makes them: `bbx_move`'s blocks for
    random valid (and every fourth lane random) actions, K7's ids on them,
    a fresh draw; and the plain move core's outputs for the oracle."""
    state, obs, _ = _midgame(device, n=n, moves=20, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=device)
    acts = torch.where(torch.arange(n, device=device) % 4 == 0,
                       torch.randint(0, 192, (n,), generator=g, device=device),
                       torch.where(obs["action_mask"], u, -1.0).argmax(1))
    acts = TStep._require_state(state, acts)
    blocks = TStep._launch_move(state, acts, torch.cuda.current_stream().cuda_stream,
                                TTables(device))
    moved = TStep._move_core_plain(state, acts)
    seed_t = TState.regen_seed(g, device)
    ids, _ = TState.regen_pieces(moved.bits, state.piece_ids, seed_t, moved.need)
    fresh = TState.fresh_pieces(n, g, device) if auto_reset else None
    return state, blocks, moved, ids, fresh


def _assert_same_step(got, want):
    fields = ("board", "piece_ids", "used", "score", "streak", "moves",
              "lines_total", "max_streak", "blocks_total", "done", "prev_holes",
              "prev_center", "ep_return", "ep_len")
    for f in fields:
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for part in (got[1], got[4]):
        other = want[1] if part is got[1] else want[4]
        assert set(part) == set(other)
        for k in part:
            assert part[k].dtype == other[k].dtype and torch.equal(part[k], other[k]), k
    for a, b in zip(got[2:4] + tuple(got[5:]), want[2:4] + tuple(want[5:])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,auto_reset", [(512, True), (512, False), (16384, True)])
def test_step_finish_kernel_matches_plain(cuda, n, auto_reset):
    """K6's `bbx_step_finish`, on `bbx_move`'s blocks as the step passes
    them, equals `_step_finish_plain` run on the card on the same inputs,
    bit for bit (reward and episode return included), at the eval/train
    paths' 512 lanes and the engine path's 16,384."""
    state, blocks, moved, ids, fresh = _finish_inputs(cuda, n, auto_reset)
    before = TStep._step_finish_cuda.launches
    got = TStep._step_finish_cuda(state, blocks, ids, fresh, TStep.RewardConfig(),
                                  auto_reset, torch.cuda.current_stream().cuda_stream,
                                  TTables(cuda))
    assert TStep._step_finish_cuda.launches == before + 1
    want = TStep._step_finish_plain(state, moved, ids, fresh, TStep.RewardConfig(),
                                    auto_reset)
    _assert_same_step(got, want)
    assert want[3].any() and moved.need.any() and (~moved.valid).any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 16384])
def test_step_matches_plain_step(cuda, n):
    """The whole step on the card (K6, K7, K6: one launch each a step)
    against the plain step on the card, from one mid-game fleet and one
    generator state, for 8 steps of random valid actions: every field,
    the obs, reward, done, info and regen's attempts, bit for bit."""
    state, obs, _ = _midgame(cuda, n=n, moves=14, seed=17)
    rng_state = state.rng.get_state()
    plain = state.replace(rng=torch.Generator(device=cuda))
    plain.rng.set_state(rng_state)
    g = torch.Generator(device=cuda).manual_seed(17)
    counters = (TStep._move_core, TStep._step_finish_cuda, TState.regen_pieces)
    before = [c.launches for c in counters]
    for _ in range(8):
        u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
        acts = torch.where(obs["action_mask"], u, -1.0).argmax(1)
        got = step(state, acts, auto_reset=True)
        want = TStep._step_plain(plain, acts, TStep.RewardConfig(), True)
        _assert_same_step(got, want)
        state, plain, obs = got.state, want.state, got.obs
    assert [c.launches - b for c, b in zip(counters, before)] == [8, 8, 8]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 32, 33, 4097])
def test_regen_kernel_at_chunk_edges(cuda, n):
    """K7 around its 32-lane chunks (N one short of, at and one past a
    chunk; 4,097 lanes): ids and attempts equal to `regen_pieces_plain`."""
    state, obs, _ = _midgame(cuda, n=4097, moves=20, seed=19)
    g = torch.Generator(device=cuda).manual_seed(19)
    u = torch.rand(obs["action_mask"].shape, generator=g, device=cuda)
    moved = TStep._move_core(state, torch.where(obs["action_mask"], u, -1.0).argmax(1))
    bits, ids = moved.bits[:n].contiguous(), state.piece_ids[:n].contiguous()
    need = torch.rand(n, generator=g, device=cuda) < 0.5
    need[-1] = True
    seed = TState.regen_seed(g, cuda)
    want = TState.regen_pieces_plain(bits, ids, seed, need)
    got = TState.regen_pieces(bits, ids, seed, need)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _k8_case(device, widths, b, dtype, seed=5):
    """A seeded network at `widths` (eval_channels, eval_hidden, ctx_dim)
    with non-zero biases, and K8's inputs for `b` mid-game lanes."""
    (c1, c2), hidden, ctx = widths
    net = network_from_config(
        {"type": "afterstate", "eval_channels": [c1, c2], "eval_hidden": hidden,
         "ctx_dim": ctx, "compute_dtype": str(dtype)[6:]},
        generator=torch.Generator().manual_seed(seed)).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_((torch.rand(p.shape, generator=g, device=device) - 0.5) * 0.2)
    _, obs, _ = _midgame(device, n=b, moves=12, seed=seed)
    return net, net.afterstates(obs["board"].float().contiguous(), obs["pieces"].contiguous())


def _assert_k8_close(net, inputs, dtype):
    """K8 against its plain version (cuDNN and cuBLAS; float32 with TF32
    off): bf16 within rtol 2e-2 plus atol 2e-2 x the largest score (K8
    rounds each layer once, after its bias, where the plain version also
    rounds the convolutions before their bias, and sums in another order);
    float32 within 1e-4 (sums in another order)."""
    before = A.evaluator_scores.launches
    with torch.no_grad(), float32_exact():
        got = A.evaluator_scores(net.evaluator, *inputs, dtype)
        want = A.evaluator_scores_plain(net.evaluator, *inputs, dtype)
    assert A.evaluator_scores.launches == before + 1
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    assert scale > 0.1
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths,b", [(((24, 24), 96, 32), 512), (((24, 24), 96, 32), 2048),
                                      (((4, 4), 8, 6), 64), (((5, 12), 20, 7), 3),
                                      (((32, 32), 128, 256), 512)])
def test_evaluator_kernel_matches_plain(cuda, widths, b, dtype):
    """K8 at run9 widths at the rollout's and eval's B = 512 and the
    update minibatch's 2048, at the tests' tiny widths, at widths that
    fill no padded tile and at the width limits, in both dtypes."""
    net, inputs = _k8_case(cuda, widths, b, dtype)
    _assert_k8_close(net, inputs, dtype)


@pytest.mark.gpu
def test_evaluator_kernel_follows_an_optimizer_step(cuda):
    """K8 lays its weights out from the parameters at every call: after an
    in-place Adam step on the evaluator, it agrees with the plain version
    on the new weights (a stale layout would not)."""
    net, inputs = _k8_case(cuda, ((24, 24), 96, 32), 256, torch.bfloat16)
    with torch.no_grad():
        first = A.evaluator_scores(net.evaluator, *inputs, torch.bfloat16)
    opt = torch.optim.Adam(net.evaluator.parameters(), lr=0.05)
    scores = A.evaluator_scores_plain(net.evaluator, *inputs, torch.bfloat16)
    scores.float().square().mean().backward()
    opt.step()
    _assert_k8_close(net, inputs, torch.bfloat16)
    with torch.no_grad():
        again = A.evaluator_scores(net.evaluator, *inputs, torch.bfloat16)
    assert (again.float() - first.float()).abs().max() > 0.1


# ---------------------------------------------------------------------------
# K8's backward.
# ---------------------------------------------------------------------------

K8B_PARAMS = ("convs.0.weight", "convs.0.bias", "convs.1.weight", "convs.1.bias",
              "dense0.weight", "dense0.bias", "dense1.weight", "dense1.bias")
K8B_COUNTERS = (A._evaluator_grad_tiles, A._evaluator_grad_dense0, A._evaluator_grad_reduce)


def _assert_grads_close(net, inputs, ds, dtype):
    """K8's backward against its plain version, `evaluator_grads_plain`
    (K8's rounding points in tensor ops: float32 with TF32 off, float64
    sums in the float32 forward), on the same inputs and upstream gradient
    and with K8's own ReLU decisions at conv2 and dense0 (read from its x0
    and dz0): each gradient tensor g within rel |g_plain| + rel max
    |g_plain|, rel = 2e-2 in bf16 (K8's forward tolerance) and 1e-4 in
    float32 (sums in another order).  The decisions themselves may differ
    from the plain version's only where a float32 sum lands on the other
    side of a bf16 rounding boundary: at most 1% of them, each at a
    pre-activation within 2e-2 of the layer's largest of 0.  Two runs give
    the same bits."""
    planes, feats, ctx = inputs
    ev = net.evaluator
    with float32_exact(), torch.no_grad():
        before = [c.launches for c in K8B_COUNTERS]
        w = A._GradWork(ev, planes, feats, ctx, ds, dtype)
        for launch in K8B_COUNTERS:
            launch(w)
        dctx2, grads2 = A._evaluator_grads_cuda(ev, planes, feats, ctx, ds, dtype)
        masks = w.relu_masks()
        want_ctx, want, pre = A.evaluator_grads_plain(ev, planes, feats, ctx, ds, dtype,
                                                      masks=masks)
    assert [c.launches - b for c, b in zip(K8B_COUNTERS, before)] == [2, 2, 2]
    got = [w.dctx] + w.grads()
    assert all(torch.equal(a, b) for a, b in zip(got, [dctx2] + list(grads2)))
    for layer, z in pre.items():
        flips = masks[layer] != (z > 0)
        assert flips.float().mean() <= 1e-2, layer
        assert (z[flips].abs() <= 2e-2 * z.abs().max()).all(), layer
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs = {}
    for name, g, w_ in zip(("ctx",) + K8B_PARAMS, got, [want_ctx] + want):
        assert g.dtype == w_.dtype and g.shape == w_.shape, name
        assert torch.isfinite(g).all(), name
        g, w_ = g.double(), w_.double()
        assert w_.abs().max() > 0, name
        errs[name] = ((g - w_).abs().max().item(), w_.abs().max().item(),
                      ((g - w_).abs() - rel * w_.abs() - rel * w_.abs().max()).max().item())
    assert all(e[2] <= 0 for e in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths,b", [(((24, 24), 96, 32), 512), (((24, 24), 96, 32), 2048),
                                      (((4, 4), 8, 6), 64), (((5, 12), 20, 7), 3)])
def test_evaluator_grads_match_plain(cuda, widths, b, dtype):
    """K8b, K8w and the reduction at run9 widths at B = 512 and the update
    minibatch's 2048, at the tests' tiny widths and at widths that fill no
    padded tile, in both dtypes."""
    net, inputs = _k8_case(cuda, widths, b, dtype)
    g = torch.Generator(device=cuda).manual_seed(b)
    ds = torch.randn(b * 192, generator=g, device=cuda).to(dtype)
    _assert_grads_close(net, inputs, ds, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_evaluator_grads_at_the_width_limits(cuda, dtype):
    """K8's backward at the width limits (32 channels, hidden 128, context
    256) on 512 lanes, where K8b's rings leave da1 no shared memory of its
    own: its row lies over da2t's, and the data group waits for dW2's
    reads before it writes da1 and for dW1's before the next da2."""
    net, inputs = _k8_case(cuda, ((32, 32), 128, 256), 512, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    ds = torch.randn(512 * 192, generator=g, device=cuda).to(dtype)
    assert A._GradWork(net.evaluator, *inputs, ds, dtype).plan["k8b_da1_apart"] == 0
    _assert_grads_close(net, inputs, ds, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [512, 2048])
def test_evaluator_grad_dense0_matches_float64(cuda, b):
    """K8w (its ring of bulk copies and tensor-core products) at run9
    widths in bf16 at B = 512 and the update minibatch's 2048, on the x0
    and dz0 that K8b writes: its splits' partials summed against dz0^T x0
    in float64 within 1e-5 of the largest element; two runs give the same
    bits.  The plan: K8b 16 warps an SM or more, K8w at least 3 stages."""
    net, inputs = _k8_case(cuda, ((24, 24), 96, 32), b, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(b)
    ds = torch.randn(b * 192, generator=g, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = A._GradWork(net.evaluator, *inputs, ds, torch.bfloat16)
        A._evaluator_grad_tiles(w)
        A._evaluator_grad_dense0(w)
        first = w.partw.clone()
        A._evaluator_grad_dense0(w)
    assert torch.equal(first, w.partw)
    dz0, x0 = w.dz0_matrix()[:, :96], w.x0_matrix()
    exact = dz0.double().t() @ x0.double()
    total = first.view(-1, 96, x0.shape[1]).double().sum(0)
    assert (total - exact).abs().max() <= 1e-5 * exact.abs().max()
    assert w.plan["k8b_threads"] * w.plan["k8b_resident_blocks_per_sm"] >= 16 * 32
    assert w.plan["k8w_stages"] >= 3 and w.plan["k8w_resident_blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_evaluator_grad_reduce_matches_float64(cuda):
    """The reduction at run9 widths in bf16 at the update minibatch's B =
    2048, on the records, partials and tile sums that K8b and K8w write:
    dctx and each parameter's gradient within 2e-2 |x| + 2e-2 max |x| of
    the same sums taken in float64 (`_GradWork.reduce_plain`) and rounded
    to bf16; two runs give the same bits."""
    net, inputs = _k8_case(cuda, ((24, 24), 96, 32), 2048, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(2048)
    ds = torch.randn(2048 * 192, generator=g, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = A._GradWork(net.evaluator, *inputs, ds, torch.bfloat16)
        for launch in K8B_COUNTERS:
            launch(w)
        first_ctx, first = w.dctx.clone(), w.flat.clone()
        A._evaluator_grad_reduce(w)
        want_ctx, want = w.reduce_plain(torch.float64)
    assert torch.equal(first_ctx, w.dctx) and torch.equal(first, w.flat)
    sizes = [p.numel() for p in net.evaluator.parameters()]
    pairs = [("ctx", w.dctx, want_ctx)] + list(zip(K8B_PARAMS, w.flat.split(sizes),
                                                    want.split(sizes)))
    for name, got, exact in pairs:
        got, exact = got.double(), exact.double()
        assert exact.abs().max() > 0, name
        assert ((got - exact).abs() <= 2e-2 * exact.abs() + 2e-2 * exact.abs().max()).all(), name


@pytest.mark.gpu
def test_evaluator_grads_follow_an_optimizer_step(cuda):
    """K8's backward lays its weights out from the parameters at every
    call: after an in-place Adam step it agrees with the plain version on
    the new weights."""
    net, inputs = _k8_case(cuda, ((24, 24), 96, 32), 256, torch.bfloat16)
    opt = torch.optim.Adam(net.evaluator.parameters(), lr=0.05)
    A.evaluator_scores_plain(net.evaluator, *inputs, torch.bfloat16).float().square().mean().backward()
    opt.step()
    g = torch.Generator(device=cuda).manual_seed(3)
    ds = torch.randn(256 * 192, generator=g, device=cuda).to(torch.bfloat16)
    _assert_grads_close(net, inputs, ds, torch.bfloat16)


@pytest.mark.gpu
def test_network_backward_on_card_runs_the_evaluator_kernels(cuda):
    """With gradients on, the network's forward on the card runs K8 and its
    backward runs K8b, K8w and the reduction, once each, and no plain
    evaluator: the parameters' gradients are close to the CPU's
    checkpointed plain evaluator's (float32, TF32 off; 1e-4 of each
    tensor's largest)."""
    _, obs, _ = _midgame(torch.device("cpu"), n=16)
    net = network_from_config(dict(TINY_NET, compute_dtype="float32"),
                              generator=torch.Generator().manual_seed(4))
    args = [obs[k] for k in ("board", "pieces", "action_mask")]

    def grads(model, device):
        model.zero_grad()
        logits, value = model(*(a.to(device) for a in args))
        m = args[2].to(device)
        (torch.where(m, logits, 0.0).square().sum() + value.sum()).backward()
        return {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}

    want = grads(net, "cpu")
    counters = (A.evaluator_scores, *K8B_COUNTERS)
    before = [c.launches for c in counters]
    with float32_exact():
        got = grads(net.to(cuda), cuda)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    errs = {k: ((got[k] - w).abs().max().item(), w.abs().max().item()) for k, w in want.items()}
    assert all(torch.isfinite(g).all() for g in got.values())
    assert all(e <= 1e-4 * m for e, m in errs.values()), errs


# ---------------------------------------------------------------------------
# K9: the uniform valid-action sampler.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [512, 16384, 16383, 300])
def test_sample_kernel_matches_plain(cuda, n):
    """K9 equals its plain version bit for bit on one seed tensor: random
    masks of every density, and rows with no valid action, one, and all
    192; each drawn action is valid (0 on an empty row); lane counts that
    fill no whole block or warp.  One launch a call, and nothing else on
    the card; a mask that does not start on 16 bytes is refused."""
    g = torch.Generator(device=cuda).manual_seed(n)
    density = torch.rand((n, 1), generator=g, device=cuda)
    mask = torch.rand((n, 192), generator=g, device=cuda) < density
    mask[0] = False
    mask[1] = False
    mask[1, 191] = True
    mask[2] = True
    seed = torch.randint(0, 2**32, (), generator=g, device=cuda, dtype=torch.int64)
    before = V.sample_valid_actions_device.launches
    got = V._sample_valid_actions_cuda(mask, seed)
    assert V.sample_valid_actions_device.launches == before + 1
    want = V.sample_valid_actions_plain(mask, seed)
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert got[0] == 0 and got[1] == 191
    some = mask.any(dim=1)
    rows = torch.arange(n, device=cuda)
    assert mask[rows[some], got[some].long()].all() and not got[~some].any()
    _assert_one_launch_a_call(lambda: V._sample_valid_actions_cuda(mask, seed), "sample_kernel")
    store = torch.zeros(n * 192 + 16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        V._sample_valid_actions_cuda(store[4:4 + n * 192].view(n, 192), seed)
