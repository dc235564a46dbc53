"""The port's trainer, train CLI, config and checkpoints, on the CPU.

Counterparts of `tests/test_resume.py` and `tests/test_preemption.py` for
`bbx_torch`: a checkpoint holds params, Adam state, counters, the env
fleet and every generator's state, so (train k, save, train k) equals
(train 2k) exactly, and a SIGTERM mid-run saves a checkpoint that resumes
exactly.  Also: the CLI end to end, and the config loaders, which map
every config of config/ onto the port's PPOConfig.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from bbx.agent.trainer import ppo_config_from as j_ppo_config_from
from bbx.agent.trainer import reward_config_from as j_reward_config_from
from bbx_torch.agent.trainer import PPOTrainer, ppo_config_from, reward_config_from, train
from bbx_torch.cli import train as cli_train
from bbx_torch.engine.state import EnvState
from bbx_torch.utils.checkpoints import (
    FORMAT_KEY,
    FORMAT_VERSION,
    checkpoint_exists,
    latest_step_checkpoint,
    load_checkpoint,
)
from bbx_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "float32"}
CFG = {
    "training": {"num_envs": 8, "rollout_steps": 8, "batch_size": 32,
                 "total_timesteps": 512},
    "ppo": {"num_epochs": 2, "final_learning_rate": 1e-4,
            "final_entropy_coef": 0.0},
    "network": TINY_NET,
}
ITER_STEPS = 64


def _with_paths(cfg, tmp_path, **logging):
    cfg = json.loads(json.dumps(cfg))
    cfg["paths"] = {"checkpoint_dir": str(tmp_path / "ckpt"),
                    "log_dir": str(tmp_path / "logs")}
    cfg["logging"] = {"log_interval": 1, "save_interval": 0,
                      "eval_interval": 0, **logging}
    return cfg


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _assert_same_run(a: PPOTrainer, b: PPOTrainer):
    for (name, p), q in zip(a.network.named_parameters(), b.network.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.train_state.optimizer.state_dict(), b.train_state.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert (a.train_state.update_step, a.global_step) == \
        (b.train_state.update_step, b.global_step)
    for f in dataclasses.fields(EnvState):
        if f.name != "rng":
            assert torch.equal(getattr(a.env_state, f.name),
                               getattr(b.env_state, f.name)), f.name
    for k in a.rngs:
        assert torch.equal(a.rngs[k].get_state(), b.rngs[k].get_state()), k


def test_train_main_on_cpu(tmp_path, capsys, monkeypatch):
    """Two iterations through the CLI from a YAML config: final, latest and
    the step checkpoint with their sidecars, a JSONL row per iteration, and
    the `done:` line.  Without tensorboard (its import made to fail here)
    the TensorBoard logger writes nothing."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _with_paths(dict(CFG, training=dict(CFG["training"], total_timesteps=128)),
                      tmp_path, save_interval=2)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli_train.main(["--config", str(path), "--device", "cpu",
                           "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "done: 128 steps in" in out and out.count("step=") == 2
    ckpt = tmp_path / "ckpt"
    for name in ("final", "latest", "checkpoint_128"):
        assert checkpoint_exists(str(ckpt / name)), name
        with open(ckpt / f"{name}.config.json") as f:
            side = json.load(f)["network"]
        assert {k: side[k] for k in TINY_NET} == TINY_NET
    assert latest_step_checkpoint(str(ckpt)) == str(ckpt / "checkpoint_128")
    payload = load_checkpoint(str(ckpt / "final"))
    assert payload["global_step"] == 128 and payload["update_step"] == 2
    assert all(int(st["step"]) == 2 * 2 * 2
               for st in payload["optimizer"]["state"].values())
    rows = [json.loads(line) for name in os.listdir(tmp_path / "logs")
            if name.endswith(".jsonl")
            for line in open(tmp_path / "logs" / name)]
    assert [r["step"] for r in rows] == [64, 128]
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("policy_loss", "value_loss", "entropy", "approx_kl"))
    assert not os.path.exists(tmp_path / "logs" / "tb")


def test_train_main_without_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_with_paths(CFG, tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--config", str(path)])
    with pytest.raises(RuntimeError, match="cuda"):
        PPOTrainer(CFG)


def test_profile_is_not_ported(tmp_path, monkeypatch, capsys):
    """(Named while `profile=True` raised.)  21 iterations with
    `profile=True`: the trace of the one after update 20 in
    ``<log_dir>/trace``, an `mfu` row in every log line (the CPU has no
    peak, so one is patched in: `iteration_flops` over the iteration's
    seconds over it), the peak printed beside the first, and the phase
    report of the spans and the traced iteration's idle time by span at the
    end."""
    from bbx_torch.agent import trainer as T

    assert T.device_peak_flops(torch.device("cpu"), torch.float32) is None
    monkeypatch.setattr(T, "device_peak_flops", lambda device, dtype: 1e12)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    steps = 4 * 4  # 4 envs x 4 steps, one minibatch, one epoch
    cfg = _with_paths(dict(CFG, training={"num_envs": 4, "rollout_steps": 4,
                                          "batch_size": steps,
                                          "total_timesteps": 21 * steps},
                           ppo={"num_epochs": 1}), tmp_path, log_interval=5)
    stats = train(cfg, profile=True, device="cpu")
    assert stats["global_step"] == 21 * steps
    out = capsys.readouterr().out
    assert out.count("against 1e+12 FLOP/s") == 1
    assert f"profiler trace written to {tmp_path / 'logs' / 'trace'}" in out
    assert "phase timing:" in out and "train.iteration" in out and "(21x, " in out
    assert "idle by span:" in out
    assert any(n.endswith(".json") for n in os.listdir(tmp_path / "logs" / "trace"))
    rows = [json.loads(line) for name in os.listdir(tmp_path / "logs")
            if name.endswith(".jsonl")
            for line in open(tmp_path / "logs" / name)]
    # Updates 5, 10 and 15: the traced iteration moves 20 to 21, as in bbx.
    assert [r["step"] for r in rows] == [5 * steps, 10 * steps, 15 * steps]
    assert all(0.0 < r["mfu"] <= 1.0 for r in rows), rows


def test_exact_resume(tmp_path):
    """(train k, save, train k) == (train 2k): metrics, params, Adam state,
    counters, env fleet and generators."""
    a = PPOTrainer(CFG, seed=5, device="cpu")
    for _ in range(2):
        a.iterate()
    path = a.save(str(tmp_path), "mid", extra={"best_score": 12.5,
                                               "tracker_scores": [1.0, 2.0]})
    cont = [_floats(a.iterate()) for _ in range(2)]

    b = PPOTrainer(CFG, seed=5, device="cpu")
    b.load(path)
    assert b.global_step == 2 * ITER_STEPS
    assert b._loaded_extra == {"best_score": 12.5, "tracker_scores": [1.0, 2.0]}
    res = [_floats(b.iterate()) for _ in range(2)]
    assert cont == res
    _assert_same_run(a, b)


def test_exact_resume_with_bf16_adam_mu(tmp_path):
    """``ppo.adam_mu_dtype: bfloat16`` trains with Adam's first moment in
    bf16 and its second in float32, and (train k, save, train k) == (train
    2k) with it, the saved moments bit for bit."""
    cfg = json.loads(json.dumps(CFG))
    cfg["ppo"]["adam_mu_dtype"] = "bfloat16"
    a = PPOTrainer(cfg, seed=5, device="cpu")
    a.iterate()
    path = a.save(str(tmp_path), "mid")
    moments = [(s["exp_avg"], s["exp_avg_sq"])
               for s in a.train_state.optimizer.state.values()]
    assert moments and all(mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
                           for mu, nu in moments)
    cont = _floats(a.iterate())
    b = PPOTrainer(cfg, seed=5, device="cpu")
    b.load(path)
    loaded = load_checkpoint(path)["optimizer"]["state"]
    for i, s in b.train_state.optimizer.state_dict()["state"].items():
        assert torch.equal(s["exp_avg"], loaded[i]["exp_avg"])
        assert s["exp_avg"].dtype == torch.bfloat16
    assert _floats(b.iterate()) == cont and all(np.isfinite(v) for v in cont.values())
    _assert_same_run(a, b)


_CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # run without tensorboard
sys.path.insert(0, {repo!r})
from bbx_torch.agent.trainer import train
cfg = json.loads(open({cfg_path!r}).read())
train(cfg, seed={seed}, device="cpu")
print('CLEAN_EXIT', flush=True)
"""
SIGTERM_SEED = 11
SIGTERM_ITERS = 8  # the uninterrupted arm's length
SIGTERM_TIMEOUT = 240  # seconds for each wait on the child


def test_sigterm_checkpoint_then_exact_resume(tmp_path):
    """A training subprocess gets SIGTERM mid-run, saves `final` + `latest`
    at the next iteration boundary and exits cleanly; resuming from `final`
    reproduces an uninterrupted run metric for metric."""
    cfg = _with_paths(dict(CFG, training=dict(CFG["training"],
                                              total_timesteps=ITER_STEPS * 400)),
                      tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=ROOT, cfg_path=str(cfg_path),
                                    seed=SIGTERM_SEED))
    proc = subprocess.Popen([sys.executable, "-u", str(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        seen, lines = 0, []
        deadline = time.time() + SIGTERM_TIMEOUT
        while seen < 3 and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            seen += line.startswith("step=")
        assert seen >= 3, "child produced no progress:\n" + "".join(lines)[-4000:]
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=SIGTERM_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = "".join(lines) + rest
    assert proc.returncode == 0, f"child did not exit cleanly:\n{out[-4000:]}"
    assert "SIGTERM received" in out and "CLEAN_EXIT" in out, out[-4000:]
    ckpt = tmp_path / "ckpt"
    for name in ("final", "latest"):
        assert checkpoint_exists(str(ckpt / name)), f"{name} missing"

    a = PPOTrainer(cfg, seed=SIGTERM_SEED, device="cpu")
    series = {}
    for _ in range(SIGTERM_ITERS):
        m = _floats(a.iterate())
        series[a.global_step] = m

    b = PPOTrainer(cfg, seed=SIGTERM_SEED, device="cpu")
    b.load(str(ckpt / "final"))
    assert 0 < b.global_step < SIGTERM_ITERS * ITER_STEPS, b.global_step
    matched = 0
    while b.global_step < SIGTERM_ITERS * ITER_STEPS:
        m = _floats(b.iterate())
        ref = series[b.global_step]
        for k in ref:
            assert m[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-7), (b.global_step, k)
        matched += 1
    assert matched >= 2
    _assert_same_run(a, b)


# ---------------------------------------------------------------------------
# Config.
# ---------------------------------------------------------------------------

_YAMLS = sorted(n for n in os.listdir(os.path.join(ROOT, "config"))
                if n.endswith(".yaml"))


def test_json_config_loads_like_its_yaml_twin(tmp_path):
    src = os.path.join(ROOT, "config", "run9.yaml")
    with open(src) as f:
        raw = yaml.safe_load(f)
    twin = tmp_path / "run9.json"
    twin.write_text(json.dumps(raw))
    assert load_config(str(twin)) == load_config(src)
    assert load_config(str(twin))["network"]["type"] == "afterstate"


@pytest.mark.parametrize("name", _YAMLS)
def test_every_config_maps_onto_ppo_config(name):
    """Each YAML of config/, the search-distillation runs among them, gives
    the same PPOConfig fields and reward coefficients as bbx."""
    cfg = load_config(os.path.join(ROOT, "config", name))
    want = j_ppo_config_from(cfg)
    assert dataclasses.asdict(reward_config_from(cfg)) == {
        k: getattr(j_reward_config_from(cfg), k)
        for k in dataclasses.asdict(reward_config_from(cfg))}
    got = ppo_config_from(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.uses_search == want.uses_search


def test_latest_step_checkpoint_ignores_sidecars(tmp_path):
    assert latest_step_checkpoint(str(tmp_path / "none")) is None
    for name in ("checkpoint_64", "checkpoint_640", "checkpoint_640.config.json",
                 "checkpoint_x", "latest"):
        (tmp_path / name).write_text("")
    assert latest_step_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_640")
    assert not checkpoint_exists(str(tmp_path / "checkpoint_1"))


# ---------------------------------------------------------------------------
# The flat CNN.
# ---------------------------------------------------------------------------

TINY_CNN = {"type": "cnn", "conv_channels": [4, 8], "fc_hidden": [16],
            "compute_dtype": "float32"}


def test_exact_resume_flat_cnn(tmp_path):
    """(train k, save, train k) == (train 2k) for the flat CNN, whose
    rollout and update run BatchNorm in train mode and dropout 0.1: the
    checkpoint holds the running statistics and the dropout generator."""
    cfg = dict(CFG, network=TINY_CNN)
    a = PPOTrainer(cfg, seed=6, device="cpu")
    for _ in range(2):
        a.iterate()
    path = a.save(str(tmp_path), "mid")
    payload = load_checkpoint(path)
    assert "norms.0.running_mean" in payload["params"]
    assert "dropout" in payload["rng_states"]
    cont = [_floats(a.iterate()) for _ in range(2)]

    b = PPOTrainer(cfg, seed=6, device="cpu")
    b.load(path)
    res = [_floats(b.iterate()) for _ in range(2)]
    assert cont == res
    _assert_same_run(a, b)
    for (name, x), y in zip(a.network.named_buffers(), b.network.buffers()):
        assert torch.equal(x, y), name
    fresh = PPOTrainer(cfg, seed=6, device="cpu")
    moved = [not torch.equal(x, y) for x, y in zip(a.network.buffers(),
                                                    fresh.network.buffers())]
    assert all(moved)  # every running statistic moved in training


def test_default_config_builds_the_flat_cnn():
    """config/default.yaml, unchanged, builds the flat CNN at its default
    widths (about 5.3M parameters) with BatchNorm."""
    from bbx_torch.models import BlockBlastNetwork

    tr = PPOTrainer(load_config(os.path.join(ROOT, "config", "default.yaml")),
                    device="cpu")
    assert isinstance(tr.network, BlockBlastNetwork)
    assert tr.num_params == 5_290_113
    assert all(n.kind == "batch" for n in tr.network.norms)
    assert tr.ppo.minibatch_size == 2048 and tr.ppo.num_envs == 64


@pytest.mark.parametrize("marker", [None, FORMAT_VERSION + 1])
def test_trainer_refuses_checkpoint_without_its_format(tmp_path, marker):
    """`load` (resume) and `load_params_only` refuse a payload with no
    format marker (saved before it existed, when `evaluator.dense0` held
    NCHW rows) or with another version, naming the cause, and leave the
    trainer's parameters as they were; the marked payload loads."""
    a = PPOTrainer(CFG, seed=4, device="cpu")
    path = a.save(str(tmp_path), "mid")
    assert load_checkpoint(path)[FORMAT_KEY] == FORMAT_VERSION
    payload = torch.load(path, weights_only=True)
    del payload[FORMAT_KEY]
    if marker is not None:
        payload[FORMAT_KEY] = marker
    bad = str(tmp_path / "bad")
    torch.save(payload, bad)
    b = PPOTrainer(CFG, seed=5, device="cpu")
    before = {k: v.clone() for k, v in b.network.state_dict().items()}
    cause = "no 'bbx_torch_format' marker" if marker is None else f"format {marker}"
    for load in (b.load, b.load_params_only):
        with pytest.raises(ValueError, match=cause):
            load(bad)
    for k, v in b.network.state_dict().items():
        assert torch.equal(v, before[k]), k
    b.load(path)
    assert b.global_step == a.global_step
