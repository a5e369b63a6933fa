"""No JAX in a run, and nothing of the program in the reference: every
scene and reference module, the benchmark's and the tests' own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from sphbench import harness

ROOTS = (harness.HERE, harness.HERE / "tests")
REF_FILES = sorted(p for r in ROOTS for p in (r / "reference").glob("*.py")
                   if p.name != "__init__.py") + [harness.HERE / "pairs.py"]
SCENE_FILES = sorted(p for r in ROOTS for p in (r / "scenes").glob("*.py")
                     if p.name != "__init__.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpusph", "tpusph_torch"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", REF_FILES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not (_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", SCENE_FILES, ids=lambda p: p.name)
def test_scene_imports_no_jax(path):
    """A scene builds the program's simulation (``tpusph_torch``), and
    nothing of JAX."""
    assert not (_imports(path) & (FORBIDDEN - {"tpusph_torch"})), path


def test_reference_loads_nothing_of_the_program():
    """Every reference module, loaded as the harness loads it."""
    code = ("import sys\n"
            "from sphbench import harness\n"
            "n = 0\n"
            "for root in (harness.HERE, harness.HERE / 'tests'):\n"
            "    for p in (root / 'reference').glob('[!_]*.py'):\n"
            "        n += bool(harness.load_part('reference', p.stem, root))\n"
            "import sphbench.pairs\n"
            "print(n, sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.ROOT).stdout
    n, loaded = out.split(" ", 1)
    assert int(n) == len(REF_FILES) - 1     # all but pairs.py
    assert "torch" in eval(loaded)
    assert not (set(eval(loaded)) & FORBIDDEN)


def test_a_run_loads_no_jax():
    """A whole (CPU, tiny) run in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or tpusph, compared whole (the
    program's own tpusph_torch is no match)."""
    code = ("import sys\n"
            "sys.path.insert(0, 'sphbench/tests')\n"
            "from _tiny import run_tiny\n"
            "from sphbench import harness\n"
            "r = run_tiny('boiling_4m.bricks4_card1', 24, steps_per_call=10)\n"
            "assert r['correct'], r['checks']\n"
            "print(harness.forbidden_modules(), "
            "'tpusph_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600).stdout
    assert out.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("tpusph_torch_lookalike", sys)
    try:
        assert "tpusph" not in harness.forbidden_modules()
    finally:
        del sys.modules["tpusph_torch_lookalike"]
