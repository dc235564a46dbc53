"""The port's vectorised env (`bbx_torch.env.vector`) and benchmark CLI
(`bbx_torch.cli.benchmark`), on the CPU.

Counterparts of `tests/test_env.py`'s VectorEnv tests and of
`tests/test_bench_robust.py`, plus the action sampler held against bbx's
(same masks; the draws themselves come from different generators, so the
comparison is of support and behaviour) and the benchmark functions at
tiny sizes.  A CPU run measures nothing of the card: these tests check
the plumbing and the gates, not the rates.
"""
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from bbx.env.vector import RunningMeanStd as JRunningMeanStd
from bbx.env.vector import sample_valid_actions_device as j_sample
from bbx_torch.cli import benchmark as TB
from bbx_torch.env import (
    RunningMeanStd,
    VectorEnv,
    make_vec_env,
    sample_valid_actions_device,
)

torch.set_num_threads(1)

TINY_NET = {"type": "cnn", "conv_channels": [4, 8], "fc_hidden": [16],
            "compute_dtype": "float32"}


class TestVectorEnv:
    def test_shapes(self):
        venv = VectorEnv(num_envs=6, seed=0, device="cpu")
        obs = venv.reset()
        assert obs["board"].shape == (6, 8, 8)
        assert obs["pieces"].shape == (6, 3, 8, 8)
        assert obs["action_mask"].shape == (6, 192)
        masks = venv.get_action_masks()
        assert masks.shape == (6, 192) and masks.any(axis=1).all()

    def test_step_and_autoreset(self):
        venv = VectorEnv(num_envs=6, seed=0, device="cpu")
        venv.reset()
        rng = np.random.default_rng(0)
        ended = 0
        for _ in range(200):
            acts = venv.sample_valid_actions(rng)
            obs, rewards, dones, infos = venv.step(acts)
            assert rewards.shape == (6,) and rewards.dtype == np.float32
            assert infos["score"].shape == (6,)
            ended += int(dones.sum())
            # auto-reset: every lane still has valid moves
            assert venv.get_action_masks().any(axis=1).all()
        assert ended > 0
        venv.close()
        assert venv.state is None

    def test_wrappers(self):
        venv = make_vec_env(num_envs=4, seed=0, normalize_rewards=True,
                            frame_stack=3, device="cpu")
        obs = venv.reset()
        assert obs["board_stack"].shape == (4, 3, 8, 8)
        acts = venv.sample_valid_actions(np.random.default_rng(0))
        obs, rewards, dones, infos = venv.step(acts)
        assert np.isfinite(rewards).all()
        assert obs["board_stack"].shape == (4, 3, 8, 8)
        np.testing.assert_array_equal(obs["board_stack"][:, -1], obs["board"])

    def test_reset_is_seeded(self):
        a, b = (VectorEnv(num_envs=5, seed=3, device="cpu") for _ in range(2))
        oa, ob = a.reset(), b.reset()
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k])
        acts = a.sample_valid_actions(np.random.default_rng(1))
        (oa, ra, da, _), (ob, rb, db, _) = a.step(acts), b.step(acts)
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k])
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)

    def test_needs_a_card_unless_told_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            VectorEnv(num_envs=2)


def test_sample_valid_actions_device_respects_the_mask():
    """Every sampled action is valid, every valid action of a lane is
    drawn, and the frequencies are uniform over the valid set, like bbx's
    sampler on the same masks (chi-square over 4,000 draws a lane, 0.1%)."""
    rng = np.random.default_rng(5)
    mask = rng.random((4, 192)) < 0.05
    mask[:, 7] = True
    reps = 4000
    tmask = torch.from_numpy(np.repeat(mask, reps, axis=0))
    got = sample_valid_actions_device(torch.Generator().manual_seed(0), tmask)
    got = got.numpy().reshape(4, reps)
    want = np.asarray(j_sample(jax.random.key(0), jnp.asarray(np.repeat(mask, reps, 0))))
    want = want.reshape(4, reps)
    for lane in range(4):
        valid = np.flatnonzero(mask[lane])
        for draws in (got[lane], want[lane]):
            assert set(draws.tolist()) == set(valid.tolist())
        counts = np.bincount(got[lane], minlength=192)[valid]
        expected = reps / len(valid)
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert chi2 < scipy.stats.chi2.ppf(0.999, len(valid) - 1), (lane, chi2)


def test_sample_valid_actions_device_all_false_mask_takes_action_0_as_bbx():
    """On a row with no valid action both samplers return action 0 (not a
    uniform draw over all 192): bbx's categorical sees 192 logits of -1e9,
    which its float32 noise cannot separate (the spacing there is 64), and
    the port's sampler takes action 0 where a row counts no valid action."""
    mask = np.zeros((500, 192), bool)
    got = sample_valid_actions_device(torch.Generator().manual_seed(1),
                                      torch.from_numpy(mask)).numpy()
    want = np.asarray(j_sample(jax.random.key(1), jnp.asarray(mask)))
    assert (got == 0).all() and (want == 0).all()


def test_running_mean_std_matches_bbx():
    rng = np.random.default_rng(2)
    a, b = RunningMeanStd(), JRunningMeanStd()
    for _ in range(5):
        x = rng.normal(2.0, 3.0, size=(64,))
        a.update(x)
        b.update(x)
    assert (a.mean, a.var, a.count) == (b.mean, b.var, b.count)


# ---------------------------------------------------------------------------
# robust_rates (mirrors tests/test_bench_robust.py).
# ---------------------------------------------------------------------------

def _fake_timer(durations):
    it = iter(durations)
    return lambda: next(it)


def test_all_good_windows():
    rates, info = TB.robust_rates(_fake_timer([0.10, 0.11, 0.10, 0.09, 0.10]),
                                  steps_per_window=1000, num_windows=5,
                                  min_window_sec=1e-4)
    assert len(rates) == 5
    assert info["impossible_windows"] == 0 and info["outlier_windows"] == 0


def test_impossible_window_discarded_and_retimed():
    rates, info = TB.robust_rates(
        _fake_timer([0.10, 0.105, 1e-6, 0.10, 0.095, 0.10, 0.10]),
        steps_per_window=1000, num_windows=5, min_window_sec=1e-4)
    assert len(rates) == 5
    assert info["impossible_windows"] == 1
    med = sorted(rates)[len(rates) // 2]
    assert (max(rates) - min(rates)) / med <= TB.MAX_REL_SPREAD


def test_gross_outlier_dropped():
    rates, info = TB.robust_rates(_fake_timer([0.10, 0.11, 0.01, 0.10, 0.09, 0.10]),
                                  steps_per_window=1000, num_windows=5,
                                  min_window_sec=1e-4)
    assert len(rates) == 5
    assert info["outlier_windows"] == 1
    assert max(rates) / min(rates) < 1.5


def test_hopeless_timer_runs_out_of_budget():
    rates, info = TB.robust_rates(_fake_timer([1e-6] * 20), steps_per_window=1000,
                                  num_windows=5, max_extra=5, min_window_sec=1e-4)
    assert len(rates) < 3
    assert info["timed_windows"] == 10


# ---------------------------------------------------------------------------
# The benchmark functions and CLI at tiny sizes on the CPU.
# ---------------------------------------------------------------------------

def _fake_clock(monkeypatch, window_seconds):
    """Replace the clock the fleet benchmark reads: consecutive calls
    advance by the given durations in turn (each window reads it twice)."""
    ticks = itertools.accumulate(
        itertools.chain.from_iterable((0.0, d) for d in itertools.cycle(window_seconds)))
    monkeypatch.setattr(TB.time, "perf_counter", lambda: next(ticks))


def test_benchmark_cli_vec_env_on_cpu(monkeypatch, capsys):
    """`--vec-env` on a tiny CPU fleet runs the windows and prints its rate
    and device; the clock is faked so that the spread gate sees equal
    windows (a CPU run measures nothing of the card)."""
    _fake_clock(monkeypatch, [0.5])
    calls = []
    real = TB.fleet_rate

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        calls.append(r)
        return r

    monkeypatch.setattr(TB, "fleet_rate", spy)
    assert TB.main(["--vec-env", "--num-envs", "4", "--steps", "2",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "vec_env:" in out and "device=cpu" in out
    (r,) = calls
    assert r["num_envs"] == 4 and r["chunk"] == 2 and r["chunks_per_window"] == 10
    assert r["windows"] == [4 * 2 * 10 / 0.5] * 5 and r["rel_spread"] == 0.0


def test_fleet_rate_fails_loudly_on_spread(monkeypatch):
    _fake_clock(monkeypatch, [0.5, 0.7, 0.5, 0.9, 0.5])
    with pytest.raises(TB.SpreadError, match="spread") as e:
        TB.fleet_rate(num_envs=2, steps=1, iters=1, device="cpu")
    result = e.value.result
    assert json.loads(str(e.value).split(": ", 1)[1]) == result
    assert result["rel_spread"] > TB.MAX_REL_SPREAD and result["device"] == "cpu"


def test_card_fleet_timing_pins_its_thread_and_restores_it():
    """A card's fleet is timed on one core (the third allowed one), and the
    thread gets its cores back after; a CPU fleet is not pinned."""
    allowed = os.sched_getaffinity(0)
    with TB._pinned_thread(torch.device("cuda")):
        assert os.sched_getaffinity(0) == {sorted(allowed)[min(2, len(allowed) - 1)]}
    assert os.sched_getaffinity(0) == allowed
    with TB._pinned_thread(torch.device("cpu")):
        assert os.sched_getaffinity(0) == allowed


def test_env_benchmark_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1, item 13"):
        TB.main(["--env", "--device", "cpu"])


def test_bench_network_and_train_on_cpu():
    """`bench_network` at two small batches; `bench_train` with a tiny
    network at the smallest fleet whose rollout fills bbx's minimum
    minibatch of 2,048 (32 envs x 64 steps, one minibatch, 10 epochs)."""
    net = TB.bench_network(batch_sizes=(1, 3), device="cpu")
    assert [r["batch"] for r in net["rows"]] == [1, 3] and net["device"] == "cpu"
    assert all(r["latency_ms"] > 0 for r in net["rows"])
    tr = TB.bench_train(num_envs=32, rollout=64, iters=1, network=TINY_NET,
                        device="cpu")
    assert tr["minibatch"] == 2048 and tr["train_env_steps_per_sec"] > 0
    (m,) = tr["metrics"]
    assert all(np.isfinite(v) for v in m.values()), m
