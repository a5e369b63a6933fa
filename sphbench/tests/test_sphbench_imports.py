"""No JAX in a run, and nothing of the program in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

from sphbench import harness

REF_FILES = sorted((harness.HERE / "reference").glob("*.py")) + [
    harness.HERE / "pairs.py"]
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


def test_reference_imports_nothing_of_the_program():
    for path in REF_FILES:
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import sphbench.reference.sph, sphbench.pairs; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=harness.ROOT).stdout
    assert not (set(eval(out)) & FORBIDDEN)


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
