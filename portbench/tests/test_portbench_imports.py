"""No module of jax, jaxlib, flax or the JAX package sandstorm_tpu in what
the benchmark runs (top-level names compared whole: sandstorm_tpu_torch,
the program, is allowed in the harness), and nothing of the program in the
reference."""

import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sandstorm_tpu"}


@pytest.mark.parametrize("name, caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("sandstorm_tpu", True),
    ("sandstorm_tpu.fields.fp252", True), ("sandstorm_tpu_torch", False),
    ("sandstorm_tpu_torch.stark.prover", False), ("jaxtyping", False),
    ("sandstorm_tpu2", False)])
def test_forbidden_modules_compares_top_level_names_whole(monkeypatch, name,
                                                          caught):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) is caught


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").rglob("*.py")),
    ids=lambda p: p.relative_to(ROOT).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    for top, level in _imports(path):
        if level:
            continue
        assert top not in FORBIDDEN | {"sandstorm_tpu_torch", "portbench",
                                       "torch"}, (path, top)


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))")],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_in_a_process_of_its_own():
    tops = _modules_after("import portbench.reference.verify")
    assert not tops & (FORBIDDEN | {"sandstorm_tpu_torch", "torch"})


def test_the_harness_and_the_program_load_no_jax():
    tops = _modules_after(
        "import torch\nfrom portbench import run, control\n"
        "run.Program(torch.device('cpu'))\n"
        "from sandstorm_tpu_torch import _native\n"
        "assert not run.forbidden_modules()")
    assert "sandstorm_tpu_torch" in tops
    assert not tops & FORBIDDEN
