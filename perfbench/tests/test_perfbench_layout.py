"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files by name."""
import json
import os
import re

import pytest

from perfbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if os.path.exists(os.path.join(harness.ROOT, word)):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"])


def test_every_config_used_once_and_pairs_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(any(f.startswith(p + "/") for p in BENCH["paths"]) for f in files)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.Cell(BENCH, name)
    assert cell.config["network"] and cell.traffic["driver"]
    assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                       cell.traffic["driver"] + ".py"))
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = harness.reader(m["name"])
        assert callable(reader.read)
        assert m["moves"] in reported
    assert any(isinstance(v, (int, float)) for v in cell.limits.values())
    assert all(v is None or isinstance(v, (int, float)) for v in cell.limits.values())


def test_metric_workloads_name_cells_that_report_what_they_move():
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in CELLS
            if "moves" in m:
                assert m["moves"] in [x["name"] for x in harness.Cell(BENCH, w).end_to_end]


def test_configuration_files_hold_the_published_recipes():
    """Nothing is cut (`reduced` is empty): each file under
    `perfbench/configs/` holds the repo's recipe of its name as it is run
    (`run8.json` too, which no cell uses yet and the CPU tests drive)."""
    yaml = pytest.importorskip("yaml")
    assert all(c["reduced"] == [] for c in BENCH["configs"])
    files = {c["file"] for c in BENCH["configs"]}
    folder = os.path.join(harness.HERE, "configs")
    for name in sorted(os.listdir(folder)):
        files.discard("perfbench/configs/" + name)
        with open(os.path.join(harness.ROOT, "config", name[:-len(".json")] + ".yaml")) as f:
            recipe = yaml.safe_load(f)
        with open(os.path.join(folder, name)) as f:
            assert json.load(f) == recipe
    assert not files
