"""Nothing the benchmark loads is JAX, its libraries or the JAX package,
compared by whole top-level names; the reference imports nothing of the
measured package."""
import ast
import os
import subprocess
import sys

from perfbench import harness

PERFBENCH = harness.HERE


def _sources(sub=""):
    for dirpath, _, names in os.walk(os.path.join(PERFBENCH, sub)):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bbx_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert not {"bbx", "jax"} & set(harness.forbidden_modules()) - {
        k.split(".")[0] for k in sys.modules if k.split(".")[0] in ("bbx", "jax")}
    monkeypatch.setitem(sys.modules, "optax.sub", sys)
    assert "optax" in harness.forbidden_modules()


def test_loading_every_module_loads_no_forbidden_one():
    """In a fresh process: every module of the benchmark, every metric
    reader, every driver's and the reference's imports of the program."""
    code = (
        "import glob, importlib, os, sys\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from perfbench import harness, control, faults, flops, instrument, weights\n"
        "from perfbench.drivers import train, eval\n"
        "from perfbench.reference import judge\n"
        "import bbx_torch.agent.trainer, bbx_torch.cli.evaluate\n"
        "for m in harness.load_benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, USE_FLAX="0"), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_neither_the_program_nor_jax():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("bbx_torch", *harness.FORBIDDEN), (path, name)


def test_benchmark_imports_no_jax_anywhere():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
