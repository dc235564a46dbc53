"""The port's eval entry point, checkpoints, config, kernel build glue, and
the rule that the port imports nothing of JAX or of `bbx`."""
import ast
import json
import os
import re

import pytest
import torch

from bbx_torch.cli import evaluate as TE
from bbx_torch.device import resolve_device
from bbx_torch.models import network_from_config
from bbx_torch.ops import build
from bbx_torch.utils.checkpoints import (
    FORMAT_KEY,
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
from bbx_torch.utils.config import DEFAULT_CONFIG, load_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = {"type": "afterstate", "eval_channels": [4, 4], "eval_hidden": 8,
            "ctx_dim": 6, "value_channels": [4, 4], "value_hidden": 16,
            "compute_dtype": "float32"}


def _bbx_result_keys():
    """The keys of the dict that bbx's `evaluate_policy` returns, read from
    its source (running it would compile the JAX eval loop)."""
    with open(os.path.join(ROOT, "bbx", "cli", "evaluate.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "evaluate_policy")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


@pytest.fixture
def tiny_checkpoint(tmp_path):
    net = network_from_config(TINY_NET, generator=torch.Generator().manual_seed(1))
    return save_checkpoint(str(tmp_path), "tiny.pt", {"params": net.state_dict()},
                           config={"network": TINY_NET})


def test_evaluate_main_on_cpu(tiny_checkpoint, tmp_path, capsys):
    out = str(tmp_path / "r.json")
    rc = TE.main(["--checkpoint", tiny_checkpoint, "--episodes", "4",
                  "--deterministic", "--seed", "7", "--device", "cpu",
                  "--output", out])
    assert rc == 0
    with open(out) as f:
        r = json.load(f)
    assert r["completed"] == 4 and r["truncated"] == 0
    assert set(r) == _bbx_result_keys()
    assert r["score_min"] > 0 and r["length_mean"] > 0
    assert "Evaluation over 4 episodes" in capsys.readouterr().out


def test_evaluate_is_seeded(tiny_checkpoint):
    net = network_from_config(TINY_NET)
    net.load_state_dict(load_checkpoint(tiny_checkpoint)["params"])
    a = TE.evaluate_policy(net, num_episodes=3, deterministic=False, seed=5,
                           device="cpu")
    b = TE.evaluate_policy(net, num_episodes=3, deterministic=False, seed=5,
                           device="cpu")
    assert a == b and not a["deterministic"]


def test_evaluate_main_without_device_raises_without_cuda(tiny_checkpoint,
                                                          monkeypatch):
    """The entry point runs on the card by default and never falls back to
    the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for search in ([], ["--lookahead"]):
        with pytest.raises(RuntimeError, match="cuda"):
            TE.main(["--checkpoint", tiny_checkpoint, "--episodes", "2", *search])
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("topk", [0, 8])
def test_lookahead_eval_main_on_cpu(tiny_checkpoint, tmp_path, topk):
    """`--lookahead` plays policy+1-ply search (all actions, or the top-k)
    and labels its results; the search's draws come from their own
    generator, so two runs agree."""
    outs = []
    for i in range(2):
        out = str(tmp_path / f"r{i}.json")
        assert TE.main(["--checkpoint", tiny_checkpoint, "--episodes", "2",
                        "--lookahead", "--topk", str(topk), "--seed", "4",
                        "--device", "cpu", "--output", out]) == 0
        with open(out) as f:
            outs.append(json.load(f))
    r = outs[0]
    assert r == outs[1] and r["lookahead"] and r["completed"] == 2
    assert set(r) == _bbx_result_keys() and r["score_min"] > 0


def test_config_for_checkpoint_reads_the_sidecar(tiny_checkpoint, tmp_path):
    cfg = TE.config_for_checkpoint(tiny_checkpoint)
    assert cfg["network"]["type"] == "afterstate"
    assert cfg["network"]["eval_channels"] == [4, 4]
    assert cfg["ppo"] == DEFAULT_CONFIG["ppo"]
    bare = str(tmp_path / "none.pt")
    assert TE.config_for_checkpoint(bare) == DEFAULT_CONFIG
    assert load_config(None) is not DEFAULT_CONFIG


def test_checkpoint_roundtrip(tmp_path):
    payload = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 3}
    path = save_checkpoint(str(tmp_path), "a.pt", payload)
    back = load_checkpoint(path)
    assert back["step"] == 3 and torch.equal(back["params"]["w"], payload["params"]["w"])
    assert not os.path.exists(path + ".config.json")
    assert back[FORMAT_KEY] == FORMAT_VERSION and FORMAT_KEY not in payload


def _remarked(path, marker):
    """Rewrite the checkpoint at `path` with its format marker removed
    (a payload saved before the marker existed) or set to `marker`."""
    payload = torch.load(path, weights_only=True)
    del payload[FORMAT_KEY]
    if marker is not None:
        payload[FORMAT_KEY] = marker
    torch.save(payload, path)


@pytest.mark.parametrize("marker", [None, FORMAT_VERSION + 1])
def test_eval_cli_refuses_checkpoint_without_its_format(tiny_checkpoint, marker):
    """The eval CLI refuses a payload with no format marker, or another
    version, and the message names the cause."""
    _remarked(tiny_checkpoint, marker)
    cause = "no 'bbx_torch_format' marker" if marker is None else f"format {marker}"
    with pytest.raises(ValueError, match=cause):
        TE.main(["--checkpoint", tiny_checkpoint, "--episodes", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match=cause):
        load_checkpoint(tiny_checkpoint)


# ---------------------------------------------------------------------------
# The kernel build glue (nvcc itself runs only on a machine with the card).
# ---------------------------------------------------------------------------

def test_build_targets_sm90a_and_keys_by_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    d = build.build_dir()
    assert d == build.build_dir()
    assert os.path.commonpath([d, os.path.join(ROOT, "build")]) == os.path.join(ROOT, "build")


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_kernel_c_signature_matches_binding(name):
    """Each entry point's source exports the bound symbol with as many
    parameters as its ctypes argtypes, and returns cudaGetLastError()."""
    lib, symbol, argtypes = build.SIGNATURES[name]
    with open(os.path.join(build.CSRC, build.SOURCES[lib])) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, symbol
    assert len(m.group(1).split(",")) == len(argtypes)
    assert "return (int)cudaGetLastError();" in src


# ---------------------------------------------------------------------------
# The port imports nothing of JAX or of bbx.
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "bbx")


def _port_files():
    files = ["chip_smoke.py"]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "bbx_torch")):
        files += [os.path.relpath(os.path.join(dirpath, n), ROOT)
                  for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files())
def test_port_imports_no_jax_or_bbx(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path} imports {name}"
    # PyYAML is imported only inside the function that reads a YAML file.
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            assert "yaml" not in mods, f"{path} imports yaml at module level"


def test_smoke_run_uses_run9_widths():
    """`chip_smoke.py` carries config/run9.yaml's `network:` section as JSON
    (the card's machine has no PyYAML); it must stay that section, with the
    defaults `network_from_config` fills in."""
    import chip_smoke

    run9 = load_config(os.path.join(ROOT, "config", "run9.yaml"))["network"]
    for key, value in chip_smoke.RUN9_NETWORK.items():
        assert run9.get(key, {"ctx_dim": 32}.get(key)) == value, key


def test_import_scan_covers_the_training_modules():
    files = set(_port_files())
    for path in ("bbx_torch/agent/ppo.py", "bbx_torch/agent/trainer.py",
                 "bbx_torch/cli/train.py", "bbx_torch/utils/logging.py"):
        assert path in files, path


def test_smoke_run_uses_run9_recipe():
    """`chip_smoke.py`'s training sections are config/run9.yaml's, and its
    rewards are the defaults run9 leaves in place."""
    import chip_smoke

    run9 = load_config(os.path.join(ROOT, "config", "run9.yaml"))
    assert chip_smoke.RUN9_PPO == {k: run9["ppo"][k] for k in chip_smoke.RUN9_PPO}
    assert set(chip_smoke.RUN9_PPO) == set(run9["ppo"])
    assert chip_smoke.RUN9_TRAINING == run9["training"]
    assert chip_smoke.RUN9_REWARDS == run9["rewards"] == DEFAULT_CONFIG["rewards"]
    n, t = run9["training"]["num_envs"], run9["training"]["rollout_steps"]
    assert chip_smoke.TRAIN_TIMESTEPS == 3 * n * t


def test_smoke_run_uses_run8_recipe():
    """`chip_smoke.py`'s distillation phase runs config/run8.yaml's
    `ppo:`, `training:` and `network:` sections as written, and no
    `rewards:` (run8 sets none); the search eval's top-k is run8's."""
    import chip_smoke
    import yaml

    with open(os.path.join(ROOT, "config", "run8.yaml")) as f:
        run8 = yaml.safe_load(f)
    assert chip_smoke.RUN8_PPO == run8["ppo"]
    assert chip_smoke.RUN8_TRAINING == run8["training"]
    assert chip_smoke.RUN8_NETWORK == run8["network"]
    assert chip_smoke.SEARCH_TOPK == run8["ppo"]["search_topk"]
    n, t = run8["training"]["num_envs"], run8["training"]["rollout_steps"]
    assert chip_smoke.DISTILL_TIMESTEPS == 2 * n * t
    written = chip_smoke.distill_config("work")
    assert "rewards" not in run8 and "rewards" not in written
    assert {k: written[k] for k in ("ppo", "training", "network")} == {
        k: run8[k] for k in ("ppo", "training", "network")}


def test_run9_curve_script_runs_run9_unchanged():
    """`scripts_dev/torch_run9_curve.py` trains config/run9.yaml as written
    but for `total_timesteps` (125 iterations, 5 in-run evals) and the
    paths."""
    import importlib.util

    import yaml

    spec = importlib.util.spec_from_file_location(
        "torch_run9_curve", os.path.join(ROOT, "scripts_dev", "torch_run9_curve.py"))
    curve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(curve)
    with open(os.path.join(ROOT, "config", "run9.yaml")) as f:
        run9 = yaml.safe_load(f)
    cfg = curve.run9_config("work")
    assert cfg["training"] == dict(run9["training"], total_timesteps=8_192_000)
    assert cfg["ppo"] == run9["ppo"] and cfg["logging"] == run9["logging"]
    assert cfg["network"] == dict(run9["network"], ctx_dim=32)  # its default
    assert cfg["paths"] == {"checkpoint_dir": os.path.join("work", "checkpoints"),
                            "log_dir": os.path.join("work", "logs")}
    iters = curve.TOTAL_TIMESTEPS // (512 * 128)
    assert iters == 125 and iters // run9["logging"]["eval_interval"] == 5
    assert all(s % (512 * 128 * 25) == 0 for s in curve.BAND_STEPS)


def test_flat_cnn_checkpoint_evaluates_in_eval_mode(tmp_path):
    """A flat-CNN checkpoint (its sidecar names ``type: cnn``) evaluates
    through the CLI; the network runs in eval mode, on its running
    statistics, which the eval leaves untouched, and two runs agree."""
    cfg = {"type": "cnn", "conv_channels": [4, 8], "fc_hidden": [16],
           "compute_dtype": "float32"}
    net = network_from_config(cfg, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    for buf in net.buffers():
        buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    ckpt = save_checkpoint(str(tmp_path), "cnn.pt", {"params": net.state_dict()},
                           config={"network": cfg})
    outs = []
    for i in range(2):
        out = str(tmp_path / f"r{i}.json")
        assert TE.main(["--checkpoint", ckpt, "--episodes", "3", "--deterministic",
                        "--device", "cpu", "--output", out]) == 0
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1] and outs[0]["completed"] == 3
    loaded = network_from_config(cfg)
    loaded.load_state_dict(load_checkpoint(ckpt)["params"])
    before = [b.clone() for b in loaded.buffers()]
    r = TE.evaluate_policy(loaded, num_episodes=3, seed=42, device="cpu")
    assert not loaded.training
    assert all(torch.equal(x, y) for x, y in zip(before, loaded.buffers()))
    assert r == outs[0]
