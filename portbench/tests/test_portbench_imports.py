"""The import rules: nothing of JAX or the JAX package in a run (compared
by whole top-level names), and nothing of the port in the reference."""

import ast
import subprocess
import sys

from portbench import harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    files = sorted((harness.HERE / "ref").rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in ("sst_tpu_torch", "sst_tpu", "jax", "flax",
                               "jaxlib"), (f, name)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in sorted(harness.HERE.rglob("*.py")):
        for name in _imports(f):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN_TOP_LEVEL, \
                (f, name)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sst_tpu_torch_fake", object())
    assert "sst_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sst_tpu.fake", object())
    assert harness.forbidden_modules() == ["sst_tpu.fake"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.run, portbench.loops, portbench.readings;"
            "from portbench import harness;"
            "[harness.load_module(p, 'm' + str(i)) for i, p in enumerate("
            "sorted((harness.HERE / 'configs').glob('*.py')))];"
            "import sst_tpu_torch.apis, sst_tpu_torch.flagship,"
            " sst_tpu_torch.train.step;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
