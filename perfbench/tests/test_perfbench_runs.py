"""Whole runs at a small size on the CPU: the result line's shape, the
refusal without a card, and `correct` coming out false with the timed
path broken underneath (each fault a cell can have) and with the control
(the reference in fp8) in the program's place."""
import contextlib
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import control, faults, harness
from perfbench.drivers import train

# The flat CNN (BatchNorm, the search) has no cell yet (PERF.md, Open
# questions).  These cells of the tests' own, with the limits the card's
# readings gave, drive its paths through the driver and the reference, so
# that its first cell comes back by data files alone.
RUN8 = {
    "run8-distill-train": ({"driver": "train", "start": "start"}, {
        "engine_mismatch": 0, "logp_gap": 0.8, "value_gap": None, "loss_gap": 0.4,
        "policy_loss1_gap": None, "value_loss1_gap": None, "grad_gap": 0.6,
        "grad_dir_gap": 0.003, "update_gap": 0.6, "search_cand_gap": 0.65,
        "search_q_gap": None, "search_choice_gap": 0.24}),
    "run8-polish-train": ({"driver": "train", "start": "search_end"}, {
        "engine_mismatch": 0, "logp_gap": 0.7, "value_gap": None, "loss_gap": None,
        "policy_loss1_gap": None, "value_loss1_gap": 0.006, "grad_gap": 0.6,
        "grad_dir_gap": None, "update_gap": 0.6}),
}
RUN8 = {name: (traffic, {**lim, **{k + ".later": v for k, v in lim.items()}})
        for name, (traffic, lim) in RUN8.items()}
BENCH = harness.load_benchmark()
BENCH = dict(BENCH, workloads=BENCH["workloads"] + [
    {"name": name, "config": "run8", "traffic": name, "chips": 1, "why": "tests"}
    for name in RUN8],
    configs=BENCH["configs"] + [{"name": "run8", "file": "perfbench/configs/run8.json"}])
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345


def _cell(small, name):
    """The cell at the tests' size, with its traffic and limits."""
    cell = harness.Cell(BENCH, name, own_files=name not in RUN8)
    if name in RUN8:
        cell.traffic, cell.limits = RUN8[name]
    cell.config, cell.traffic = small(cell)
    return cell


def _run(small, name, trace):
    cell = _cell(small, name)
    return harness.run_cell(name, SEED, 0.5, trace, "cpu", config=cell.config,
                            traffic=cell.traffic, bench=BENCH, limits=cell.limits)


@pytest.mark.parametrize("name,trace", [("run9-train", False), ("run8-distill-train", False),
                                        ("run8-polish-train", True), ("run9-eval-greedy", True),
                                        ("run9-train", True)])
def test_result_line_shape(small, name, trace):
    cell = _cell(small, name)
    out = _run(small, name, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    expect = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in expect}
    assert set(out["metrics"]) <= set(units)
    for k, v in out["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == set(units)
    for c in out["checks"].values():
        assert c["limit"] is None or c["value"] <= c["limit"]


def test_cli_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "run9-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_cli_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "run9-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def _faults(name):
    return faults.TRAIN_FAULTS if name != "run9-eval-greedy" else faults.EVAL_FAULTS


FAULTS = [(name, fault) for name in CELLS for fault in _faults(name)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(small, name, fault):
    with _faults(name)[fault]():
        out = _run(small, name, False)
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_a_path_broken_only_after_set_up_is_not_correct(small, monkeypatch, fault):
    """A fault that the program would switch on after its first iteration
    (a path taken only once warm) shows in the iteration judged after the
    window."""
    planted = contextlib.ExitStack()
    prepare = train.prepare

    def prepare_then_break(*args, **kwargs):
        out = prepare(*args, **kwargs)
        planted.enter_context(faults.TRAIN_FAULTS[fault]())
        return out

    monkeypatch.setattr(train, "prepare", prepare_then_break)
    with planted:
        out = _run(small, "run9-train", False)
    assert out["correct"] is False


@pytest.mark.parametrize("numbers,correct", [
    ({"a": 0.1, "b": 5.0}, True),   # b's limit is null: reported, not compared
    ({"a": 0.3, "b": 0.0}, False),  # a over its limit
    ({"a": 0.1, "c": 0.0}, False),  # c has no limit in the file
    ({"b": 0.0}, False),            # nothing compared
])
def test_decide_compares_only_numbers_with_a_limit(numbers, correct):
    checks, ok = harness.decide(numbers, {"a": 0.2, "b": None})
    assert ok is correct and checks["a" if "a" in numbers else "b"]["limit"] in (0.2, None)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_number(small, name):
    cell = _cell(small, name)
    cell.config["network"]["compute_dtype"] = "bfloat16"
    if cell.traffic["driver"] == "eval":
        # The widest gap grows with the lanes read: at 16 the control's
        # fell under the limit on one seed of three, at 64 on none.
        cell.traffic["episodes"] = 64
    numbers = control.readings(cell, 11, "cpu")["control"]
    assert any(cell.limits[k] is not None and v > cell.limits[k] for k, v in numbers.items())


@pytest.mark.gpu
def test_a_cell_on_the_card(cuda_card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "run9-eval-greedy",
                          "--seed", "7", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
