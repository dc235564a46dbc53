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
from bbx_torch.engine import solvability as S
from bbx_torch.engine import step as TStep
from bbx_torch.engine import state as TState
from bbx_torch.engine.parity import ParityEngine
from bbx_torch.engine.step import observe, step
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
@pytest.mark.parametrize("which", ["random", "reachable"])
def test_verdict_kernels_match_plain(cuda, which):
    if which == "random":
        board, ids = _random_boards(cuda)
    else:
        state, _, ids = _midgame(cuda)
        board = state.board
    bits = S.board_bits(board)
    v3 = S.valid3_bits(bits, ids)
    assert torch.equal(v3, S.valid3_bits_plain(bits, ids))
    fast = S.solvable_disjoint_bits(bits, ids, v3)
    assert torch.equal(fast, S.solvable_disjoint_bits_plain(bits, ids, v3))
    exact = S.solvable_exact_bits(bits, ids, v3)
    assert torch.equal(exact, S.solvable_exact_bits_plain(bits, ids, v3))
    assert fast.any() and (~fast).any() and (~exact).any()


@pytest.mark.gpu
def test_afterstate_kernel_matches_plain(cuda):
    _, obs, _ = _midgame(cuda, n=64)
    board, pieces = obs["board"], obs["pieces"]
    for got, want in zip(A.afterstate_buffer(board, pieces),
                         A.afterstate_buffer_plain(board, pieces)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_afterstate_kernel_matches_plain_at_update_minibatch(cuda):
    """At run9's minibatch of 2048, on the planes the update rebuilds from
    its compact buffer (used slots zeroed)."""
    state, obs, _ = _midgame(cuda, n=2048)
    mb = P._minibatch_obs({"board": state.board, "mask": obs["action_mask"],
                           "piece_ids": state.piece_ids.to(torch.int8),
                           "used": state.used})
    board, pieces = mb["board"].contiguous(), mb["pieces"].contiguous()
    assert not pieces.flatten(2).any(2).all()
    for got, want in zip(A.afterstate_buffer(board, pieces),
                         A.afterstate_buffer_plain(board, pieces)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    bits = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        S.valid3_bits(bits, ids.long())
    with pytest.raises(ValueError, match="shape"):
        S.valid3_bits(bits, ids[:3])
    v3 = S.valid3_bits(bits, ids)
    with pytest.raises(ValueError, match="contiguous"):
        S.solvable_exact_bits(bits, ids, v3.transpose(0, 1).contiguous().transpose(0, 1))
    board = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        A.afterstate_buffer(board.half(), torch.zeros((2, 3, 8, 8), device=cuda))


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
    """The eval path launches K1, K4, K6 and K7; the verdict tiers K2 and
    K3 run inside K7, so their standalone kernels are not launched."""
    counters = (S.valid3_bits, A.afterstate_buffer, TStep._move_core,
                TState.regen_pieces)
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


@pytest.mark.gpu
def test_gae_kernel_matches_plain_bit_for_bit(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    t_len, n = 128, 512
    args = (torch.randn((t_len, n), generator=g, device=cuda),
            torch.rand((t_len, n), generator=g, device=cuda) < 0.02,
            torch.randn((t_len, n), generator=g, device=cuda),
            torch.randn(n, generator=g, device=cuda))
    cfg = P.PPOConfig()
    for a, b in zip(P.compute_gae(cfg, *args), P.compute_gae_plain(cfg, *args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="float32"):
        P.compute_gae(cfg, args[0].double(), *args[1:])


@pytest.mark.gpu
def test_trainer_on_card_launches_every_kernel_and_resumes(cuda, tmp_path):
    """Two tiny PPO iterations on the card launch the train path's kernels
    (K1, K4-K7; K2 and K3 run inside K7); a saved run loads and runs one
    more finite iteration."""
    cfg = {"training": {"num_envs": 16, "rollout_steps": 8, "batch_size": 64},
           "ppo": {"num_epochs": 2, "final_learning_rate": 1e-4},
           "network": dict(TINY_NET)}
    counters = (S.valid3_bits, A.afterstate_buffer, P.compute_gae,
                TStep._move_core, TState.regen_pieces)
    for fn in counters:
        fn.launches = 0
    tr = PPOTrainer(cfg, seed=3, total_timesteps=512, device=cuda)
    for _ in range(2):
        m = {k: float(v) for k, v in tr.iterate().items()}
        assert all(np.isfinite(v) for v in m.values()), m
    assert P.compute_gae.launches == 2
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
