"""The port's host-facing layer on the CPU: the renderer, the config
writer, the device helpers, `PolicyAgent`, the play, eval and benchmark
CLIs' single-env paths, profiling, and the analytic FLOP count.

bbx is the oracle where it has a counterpart: rendered strings are
byte-equal to bbx's; `PolicyAgent` on bbx's flat CNN (float32, small
widths, every bias, norm scale and running statistic redrawn), converted
by `bbx_torch.models.convert`, picks bbx's deterministic action, with
log-probabilities, entropies and values within 1e-5 (the eval-mode
tolerance of `tests/test_torch_network.py`).  The FLOP count equals
`torch.utils.flop_counter.FlopCounterMode`'s on the CPU's plain path (the
evaluator checkpointed in a gradient step) exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bbx import render as JR
from bbx.agent.policy_agent import PolicyAgent as JPolicyAgent
from bbx.models import network as JN
from bbx_torch import render as TR
from bbx_torch.agent import PolicyAgent
from bbx_torch.agent.ppo import PPOConfig
from bbx_torch.agent.trainer import iteration_flops
from bbx_torch.cli import benchmark as TB
from bbx_torch.cli import evaluate as TE
from bbx_torch.cli import play as TP
from bbx_torch.models import AfterstateNetwork, BlockBlastNetwork, network_from_config
from bbx_torch.models import flops as F
from bbx_torch.models.convert import block_blast_state_dict_from_flax
from bbx_torch.models.network import ActorCritic
from bbx_torch.utils import device as TD
from bbx_torch.utils.checkpoints import save_checkpoint
from bbx_torch.utils.config import load_config, save_config
from bbx_torch.utils.profiling import PhaseTimer, trace

torch.set_num_threads(1)

TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "float32"}
SMALL_CNN = dict(conv_channels=(4, 8, 8), fc_hidden=(16, 8))
AGENT_ATOL = 1e-5


# ---------------------------------------------------------------------------
# Renderer.
# ---------------------------------------------------------------------------

def _boards(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 8, 8)) < rng.uniform(0.1, 0.9, (n, 1, 1))).astype(np.uint8)


@pytest.mark.parametrize("show_coords", [True, False])
def test_render_board_equals_bbx(show_coords):
    for board in _boards(6):
        got = TR.render_board(board, show_coords)
        assert got == JR.render_board(board, show_coords)
        assert TR.render_board(torch.from_numpy(board), show_coords) == got


def test_render_pieces_equal_bbx():
    for pid in range(37):
        assert TR.render_piece(pid) == JR.render_piece(pid)
    rng = np.random.default_rng(1)
    for _ in range(8):
        ids = rng.integers(0, 37, 3).tolist()
        used = (rng.random(3) < 0.4).tolist()
        assert TR.render_pieces(ids, used) == JR.render_pieces(ids, used)


def test_render_placement_and_game_state_equal_bbx():
    rng = np.random.default_rng(2)
    seen = set()
    for board in _boards(12, seed=3):
        pid, r, c = int(rng.integers(37)), int(rng.integers(8)), int(rng.integers(8))
        got = TR.render_board_with_placement(board, pid, r, c)
        assert got == JR.render_board_with_placement(board, pid, r, c)
        seen |= {m for m in (TR.GHOST, TR.BAD) if m in got}
        ids, used = rng.integers(0, 37, 3).tolist(), (rng.random(3) < 0.5).tolist()
        kw = dict(score=int(rng.integers(1000)), moves=int(rng.integers(50)),
                  combo=int(rng.integers(4)), game_over=bool(rng.random() < 0.5))
        assert (TR.render_game_state(board, ids, used, **kw)
                == JR.render_game_state(board, ids, used, **kw))
    empty = np.zeros((8, 8), np.uint8)
    assert (TR.render_board_with_placement(empty, 17, 0, 0)
            == JR.render_board_with_placement(empty, 17, 0, 0))
    assert seen == {TR.GHOST, TR.BAD}


# ---------------------------------------------------------------------------
# Config and device helpers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_save_config_roundtrip(tmp_path, suffix):
    cfg = load_config(None)
    cfg["training"]["num_envs"] = 123
    cfg["network"]["conv_channels"] = [8, 16]
    path = str(tmp_path / "sub" / f"c{suffix}")
    save_config(cfg, path)
    assert load_config(path) == cfg


def test_device_utils_on_cpu():
    dev = TD.get_device("cpu")
    assert dev == torch.device("cpu")
    g = TD.set_seed(5, "cpu")
    a = np.random.random()
    t = torch.rand(2, generator=g)
    TD.set_seed(5, "cpu")
    assert np.random.random() == a
    assert torch.equal(torch.rand(2, generator=TD.set_seed(5, "cpu")), t)
    info = TD.get_device_info("cpu")
    assert info["platform"] == "cpu" and info["num_devices"] == 1
    assert info["num_processes"] == 1 and info["process_index"] == 0
    assert TD.memory_stats(torch.device("cpu")) == {}
    TD.clear_memory()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            TD.get_device()


# ---------------------------------------------------------------------------
# PolicyAgent against bbx's.
# ---------------------------------------------------------------------------

def _redraw(tree, rng, draws):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng, draws)
        elif k in draws:
            out[k] = rng.uniform(*draws[k], np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def agents():
    jnet = JN.BlockBlastNetwork(**SMALL_CNN, dtype=jnp.float32)
    v = jnet.init({"params": jax.random.key(0), "dropout": jax.random.key(0)},
                  jnp.zeros((2, 8, 8)), jnp.zeros((2, 3, 8, 8)), train=False)
    rng = np.random.default_rng(0)
    params = _redraw(v["params"], rng, {"scale": (0.5, 1.5), "bias": (-0.3, 0.3)})
    stats = _redraw(v["batch_stats"], rng, {"mean": (-0.3, 0.3), "var": (0.5, 2.0)})
    jagent = JPolicyAgent(jnet, {"params": params, "batch_stats": stats})
    tnet = BlockBlastNetwork(**SMALL_CNN, compute_dtype=torch.float32)
    tagent = PolicyAgent(tnet, block_blast_state_dict_from_flax(params, stats),
                         device="cpu")
    return jagent, tagent


def _observations(b, seed=4):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, 192)) < 0.3).astype(np.int8)
    mask[:, 0] = 1
    return {"board": (rng.random((b, 8, 8)) < 0.4).astype(np.float32),
            "pieces": (rng.random((b, 3, 8, 8)) < 0.2).astype(np.float32),
            "action_mask": mask}


def test_policy_agent_matches_bbx(agents):
    jagent, tagent = agents
    assert not tagent.network.training
    batch = _observations(6)
    for i in range(6):
        obs = {k: v[i] for k, v in batch.items()}
        ja, jinfo = jagent.select_action(obs, deterministic=True)
        ta, tinfo = tagent.select_action(obs, deterministic=True)
        assert ta == ja and set(tinfo) == set(jinfo)
        for k in jinfo:
            assert abs(tinfo[k] - jinfo[k]) <= AGENT_ATOL, (i, k, tinfo[k], jinfo[k])
        assert batch["action_mask"][i, tagent.select_action(obs)[0]]
    jacts, jlogp, jv = jagent.select_actions(batch, deterministic=True)
    tacts, tlogp, tv = tagent.select_actions(batch, deterministic=True)
    np.testing.assert_array_equal(tacts, jacts)
    np.testing.assert_allclose(tlogp, jlogp, rtol=0, atol=AGENT_ATOL)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=AGENT_ATOL)
    np.testing.assert_allclose(tagent.get_values(batch), jagent.get_values(batch),
                               rtol=0, atol=AGENT_ATOL)
    sampled = tagent.select_actions(batch)[0]
    assert all(batch["action_mask"][i, a] for i, a in enumerate(sampled))


def test_policy_agent_save_load_and_from_checkpoint(tmp_path):
    agent = PolicyAgent(network_from_config(TINY_NET), device="cpu")
    path = str(tmp_path / "agent.pt")
    agent.save(path)
    other = PolicyAgent(network_from_config(
        TINY_NET, generator=torch.Generator().manual_seed(9)), device="cpu")
    other.load(path)
    for a, b in zip(agent.network.state_dict().values(),
                    other.network.state_dict().values()):
        assert torch.equal(a, b)
    ckpt = save_checkpoint(str(tmp_path), "ck.pt", {"params": agent.network.state_dict()},
                           config={"network": TINY_NET})
    loaded = PolicyAgent.from_checkpoint(ckpt, device="cpu")
    assert isinstance(loaded.network, AfterstateNetwork)
    obs = {k: v[0] for k, v in _observations(1).items()}
    assert loaded.select_action(obs, True) == agent.select_action(obs, True)
    default = PolicyAgent(device="cpu")
    assert isinstance(default.network, BlockBlastNetwork)


# ---------------------------------------------------------------------------
# The CLIs' single-env paths.
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_checkpoint(tmp_path):
    net = network_from_config(TINY_NET, generator=torch.Generator().manual_seed(1))
    return save_checkpoint(str(tmp_path), "tiny.pt", {"params": net.state_dict()},
                           config={"network": TINY_NET})


def test_play_random_mode(capsys):
    assert TP.main(["--mode", "random", "--games", "2", "--seed", "3",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "game 2: score=" in out and "2 random games: score mean" in out


def test_play_manual_mode(monkeypatch, capsys):
    """A preview, the move and `q`, through a patched `input`."""
    from bbx_torch.env.single import BlockBlastEnv

    env = BlockBlastEnv(seed=3, device="cpu")
    move = env._action_to_move(env.get_valid_actions()[0])
    answers = iter([f"p {move[0]} {move[1]} {move[2]}", " ".join(map(str, move)), "q"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert TP.main(["--mode", "manual", "--seed", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert " points" in out and "Score: 0 | Moves: 0" in out
    assert "final score: " in out and "in 1 moves" in out
    assert TR.GHOST in out


def test_play_watch_mode(tiny_checkpoint, capsys):
    r = TP.watch(tiny_checkpoint, games=1, delay=0.0, seed=5, device="cpu")
    out = capsys.readouterr().out
    assert r["moves"][0] > 0 and f"game 1: score={r['scores'][0]}" in out
    assert "move 1 | score" in out and "Available pieces" in out


def test_evaluate_render(tiny_checkpoint, capsys):
    assert TE.main(["--checkpoint", tiny_checkpoint, "--episodes", "2",
                    "--deterministic", "--render", "--render-games", "1",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Evaluation over 2 episodes" in out and "game 1: score=" in out
    assert "game 2: score=" not in out


def test_bench_single_env():
    r = TB.bench_single_env(steps=4, device="cpu")
    assert r["name"] == "single_env" and r["device"] == "cpu" and r["steps"] == 4
    assert r["env_steps_per_sec"] > 0
    assert r["us_per_step"] == pytest.approx(1e6 / r["env_steps_per_sec"])


# ---------------------------------------------------------------------------
# Profiling.
# ---------------------------------------------------------------------------

def test_profiling_phase_timer():
    pt = PhaseTimer()
    with pt.phase("a"):
        pass
    held = []
    with pt.phase("a", block_on=held):
        held.append({"x": torch.ones(2)})
    with pt.phase("b"):
        pass
    s = pt.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert set(s["a"]) == {"total_s", "mean_ms", "count"}
    report = pt.report()
    assert report.startswith("phase timing:") and "(2x, " in report


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d.log_dir == log_dir
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# The analytic FLOP count.
# ---------------------------------------------------------------------------

def _nets():
    g = torch.Generator().manual_seed(0)
    return [
        AfterstateNetwork((4, 5), 8, 6, (3, 4), 7, compute_dtype=torch.float32,
                          generator=g),
        BlockBlastNetwork(**SMALL_CNN, dropout_rate=0.0, compute_dtype=torch.float32,
                          generator=g),
        BlockBlastNetwork((4, 8), (8,), use_residual=False, norm="none",
                          compute_dtype=torch.float32, generator=g),
        ActorCritic((3, 4), 6, compute_dtype=torch.float32, generator=g),
    ]


@pytest.mark.parametrize("index", range(4))
def test_flop_count_equals_flop_counter_mode(index):
    """The rollout forward (eval mode, no gradient) and the gradient step
    (train mode: forward, the evaluator's checkpointed recompute and the
    backward of the logits' and values' sum)."""
    net = _nets()[index]
    b = 3
    obs = _observations(b, seed=7)
    board, pieces = torch.from_numpy(obs["board"]), torch.from_numpy(obs["pieces"])
    mask = torch.from_numpy(obs["action_mask"]) > 0
    net.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(board, pieces, mask)
    assert F.network_flops(net, b) == fc.get_total_flops() > 0
    if hasattr(net, "value"):  # the one-ply search's value alone
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            net.value(board, pieces)
        assert F.network_flops(net, b, value_only=True) == fc.get_total_flops() > 0
    net.train()
    with FlopCounterMode(display=False) as fc:
        logits, value = net(board, pieces, mask, generator=torch.Generator().manual_seed(0))
        (logits.sum() + value.sum()).backward()
    assert F.network_flops(net, b, grad=True) == fc.get_total_flops()


def test_iteration_flops_counts_the_trip_counts():
    """Rollout forwards x (steps + the last value) plus gradient steps
    without the evaluator's recompute x epochs x minibatches, as the
    benchmark's `mfu.train` counts; an iteration that searches adds the
    search's value on every simulated lane of every step, until the
    search anneals out (bbx's `_iteration_flops` counts the recompute and
    neither the last value nor the search)."""
    net = network_from_config(TINY_NET)
    cfg = PPOConfig(num_envs=8, rollout_steps=16, minibatch_size=32, num_epochs=4)
    f_roll = F.network_flops(net, 8)
    f_upd = F.network_flops(net, 32, grad=True, recompute=False)
    recompute = sum(f for f, _, again in net.flop_layers(32) if again)
    assert f_upd == F.network_flops(net, 32, grad=True) - recompute < f_upd + recompute
    assert iteration_flops(cfg, net) == 17 * f_roll + 4 * 4 * f_upd
    longer = PPOConfig(num_envs=8, rollout_steps=32, minibatch_size=32, num_epochs=4)
    assert iteration_flops(longer, net) == 33 * f_roll + 4 * 8 * f_upd
    assert iteration_flops(cfg, net) > 10 * (f_roll + f_upd)
    search = PPOConfig(num_envs=8, rollout_steps=16, minibatch_size=32, num_epochs=4,
                       rollout_search_frac=0.5, final_rollout_search_frac=0.0,
                       search_topk=4, schedule_updates=10)
    f_value = F.network_flops(net, 8 * 4, value_only=True)
    assert 0 < f_value < F.network_flops(net, 8 * 4)
    assert iteration_flops(search, net, update_step=0) == iteration_flops(cfg, net) + 16 * f_value
    assert iteration_flops(search, net, update_step=10) == iteration_flops(cfg, net)


def test_kernel_flop_counts():
    """K8's count is the evaluator's with the context's product once a
    (lane, slot); K8b adds its gradient products; K8w is dense0's weight
    gradient; run9 widths, one lane."""
    widths = ((24, 24), 96, 32)
    m = 192
    per_afterstate = 64 * 18 * 24 + 64 * 9 * 24 * 24 + (64 * 24 + 3) * 96 + 96
    assert F.k8_flops(1, widths) == 2 * (m * per_afterstate + 3 * 32 * 96)
    assert F.k8b_flops(1, widths) == F.k8_flops(1, widths) + 2 * m * (
        64 * 24 * 96 + 2 * 64 * 9 * 24 * 24 + 64 * 18 * 24 + 96)
    assert F.k8w_flops(1, widths) == 2 * m * 96 * (64 * 24 + 3 + 32)


# ---------------------------------------------------------------------------
# The root launchers' counterparts: stable_train and quick_bench.
# ---------------------------------------------------------------------------

class _Built(Exception):
    """Raised by the trainer stand-in once it has seen its arguments."""


def _trainer_stand_in(monkeypatch, module):
    """Replace `module.PPOTrainer` by a stand-in that records the config
    and seed it is given and stops the launcher."""
    seen = []

    class StandIn:
        def __init__(self, config, seed=42, **kwargs):
            seen.append({"config": json.loads(json.dumps(config)), "seed": seed})
            raise _Built

    monkeypatch.setattr(module, "PPOTrainer", StandIn)
    return seen


@pytest.mark.parametrize("args", [[], ["--envs", "16", "--steps", "4096", "--extended"]])
def test_stable_train_recipe_equals_the_root_script(args, monkeypatch, tmp_path):
    """The config and seed `bbx-torch-stable-train` gives its trainer are
    the ones the root `stable_train.py` gives bbx's; without --device it
    asks for the card."""
    import stable_train as root

    from bbx.agent import trainer as JT
    from bbx_torch.cli import stable_train as TS

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.argv", ["stable_train.py", *args])
    want = _trainer_stand_in(monkeypatch, JT)
    with pytest.raises(_Built):
        root.main()
    got = _trainer_stand_in(monkeypatch, TS)
    with pytest.raises(_Built):
        TS.main([*args, "--device", "cpu"])
    assert got == want and len(got) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.main(args)


def test_stable_train_saves_and_resumes(monkeypatch, tmp_path, capsys):
    """A tiny run on the CPU (the recipe at 8 lanes, with a tiny network)
    saves `checkpoints/quick_trained`; a second run with more steps
    resumes it at its step and trains on to its own end."""
    from bbx_torch.cli import stable_train as TS

    recipe0 = TS.recipe
    monkeypatch.setattr(TS, "recipe", lambda envs: {
        **recipe0(envs), "network": {"conv_channels": [4, 8], "fc_hidden": [16],
                                     "compute_dtype": "float32"}})
    monkeypatch.chdir(tmp_path)
    assert TS.main(["--steps", "512", "--envs", "8", "--device", "cpu"]) == 0
    assert "saved checkpoints/quick_trained at step 512" in capsys.readouterr().out
    assert TS.main(["--steps", "1024", "--envs", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed quick_trained at step 512" in out
    assert "saved checkpoints/quick_trained at step 1,024" in out


@pytest.mark.parametrize("outcome", ["pass", "fail", "unsteady"])
def test_quick_bench_exit_codes(outcome, monkeypatch, capsys):
    """PASS (0) at or above the gate, FAIL (1) under it, and "no steady
    measurement" (2) when every attempt breaks the spread gate; a broken
    measurement is taken again."""
    from bbx_torch.cli import quick_bench as TQ

    rates = {"pass": TQ.GATE_ENV_STEPS_PER_SEC, "fail": TQ.GATE_ENV_STEPS_PER_SEC - 1}
    calls = []

    def bench_engine(num_envs, steps, device):
        calls.append((num_envs, steps, device))
        result = {"env_steps_per_sec": float(rates.get(outcome, 1e8)),
                  "rel_spread": 0.05, "device": "cpu"}
        if outcome == "unsteady" or len(calls) == 1:
            raise TB.SpreadError("spread", dict(result, rel_spread=0.5))
        return result

    monkeypatch.setattr(TQ, "bench_engine", bench_engine)
    code = TQ.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert code == {"pass": 0, "fail": 1, "unsteady": 2}[outcome], out
    assert TQ.NUM_ENVS == 16_384 and calls[0] == (16_384, 64, torch.device("cpu"))
    if outcome == "unsteady":
        assert len(calls) == TQ.ATTEMPTS and "no steady measurement" in out
    else:
        assert len(calls) == 2 and ("PASS" if outcome == "pass" else "FAIL") in out
