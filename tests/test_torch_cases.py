"""The five ``cases/`` scripts through the port's interpreter on the CPU:

- the staged particles, groups, spec and tables after each script's build
  commands (everything before ``run``) equal to ``tpusph.script.
  Interpreter``'s, exactly;
- the port of tests/test_cases.py (a few steps of each case at coarse
  resolution, and the config-4 budget at dx 0.01);
- the golden-log rows of each case (``tests/golden/log.<case>``, CPU runs of
  ``tpusph``'s ``auto``: dense at 2,048 atoms or fewer, the cell grid
  above) at ``tools/generate_golden.py``'s settings, over the first thermo
  interval, at tests/test_golden.py's bar (rtol 2e-3, a floor of 1e-5 of
  the column's largest magnitude; Atoms exact). The whole logs are the
  test marked ``slow``.

The JAX package runs here only to build (no step), never in Pallas
interpret mode."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tpusph.script import Interpreter as JInterpreter

from tpusph_torch import cases as caselib
from tpusph_torch import cli
from tpusph_torch.script import Interpreter

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

CASES = ["heat_slab", "water_collapse", "droplet", "bubble_rise", "boiling"]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(interp, name):
    interp.sim.screen = False
    path = f"cases/{name}/in.{name}"
    lines = [line for line in open(path).read().splitlines()
             if not line.strip().startswith("run")]
    interp.run_string("\n".join(lines))
    return interp.sim


def _spec(spec):
    return dict(spec._asdict()) if hasattr(spec, "_asdict") \
        else dataclasses.asdict(spec)


@pytest.mark.parametrize("name", CASES)
def test_build_equals_reference(name):
    """After the build commands (the script's default variables), the port
    stages what ``tpusph`` stages: every particle array, the groups, the
    spec, the tables, fix phase_change's configuration, and the run
    settings."""
    a = _build(JInterpreter(), name)
    b = _build(Interpreter(device="cpu"), name)
    assert len(b._staged["x"]) == len(a._staged["x"]) > 1000
    for f in ("x", "v", "type", "rho", "e", "cv", "rmass", "tag", "mobile"):
        np.testing.assert_array_equal(b._staged[f], a._staged[f], f)
    assert sorted(b.groups) == sorted(a.groups)
    for g in a.groups:
        np.testing.assert_array_equal(b.groups[g], a.groups[g], g)
    assert _spec(b.spec) == _spec(a.spec)
    for f in dataclasses.fields(b.tables):
        np.testing.assert_array_equal(getattr(b.tables, f.name),
                                      np.asarray(getattr(a.tables, f.name)),
                                      f.name)
    pa, pb = a.phase_change_config, b.phase_change_config
    assert (pa is None) == (pb is None)
    if pa is not None:
        assert dataclasses.asdict(pb) == dataclasses.asdict(pa)
    for f in ("dt", "neighbor_skin", "reneigh_every", "capacity_pad",
              "thermo_every", "thermo_columns"):
        assert getattr(b, f) == getattr(a, f), f


def test_golden_settings_copy_matches_tools():
    """``tpusph_torch.cases.GOLDEN`` is tools/generate_golden.py's CASES."""
    import generate_golden
    assert caselib.GOLDEN == generate_golden.CASES


# ---------------------------------------------- tests/test_cases.py

def run_case(path, nsteps=5, var=None):
    interp = Interpreter(variables=var or {}, device="cpu")
    interp.sim.screen = False
    lines = [line for line in open(path).read().splitlines()
             if not line.strip().startswith(("run", "dump"))]
    interp.run_string("\n".join(lines))
    interp.command(f"run {nsteps}")
    return interp.sim


def test_heat_slab_case():
    sim = run_case("cases/heat_slab/in.heat_slab", var={"dx": "0.04"})
    assert sim.natoms > 2000
    t = sim.get("e")
    assert np.isfinite(t).all() and t.min() < 1.1 and t.max() > 1.9


def test_water_collapse_case():
    sim = run_case("cases/water_collapse/in.water_collapse")
    assert np.isfinite(sim.get("x")).all()
    assert type(sim._runner.backend).__name__ == "DenseBackend"


def test_droplet_case():
    sim = run_case("cases/droplet/in.droplet")
    assert np.isfinite(sim.get("rho")).all()


def test_bubble_rise_case():
    sim = run_case("cases/bubble_rise/in.bubble_rise", var={"dx": "0.08"})
    assert sim.spec.phase_change and sim.spec.gravity
    assert sim.spec.surface_tension and sim.spec.heat_phasechange
    assert not sim.spec.heatconduction
    assert float(sim.tables.tsat[1, 2]) == 2.0
    assert np.isfinite(sim.get("x")).all()
    assert (sim.get("type") == 2).sum() > 0


def test_boiling_case():
    sim = run_case("cases/boiling/in.boiling", var={"dx": "0.08"},
                   nsteps=12)
    assert sim.spec.phase_change
    assert np.isfinite(sim.get("x")).all()
    # 2,000 atoms at the start: the dense rung, kept while it grows
    assert type(sim._runner.backend).__name__ == "DenseBackend"
    assert sim.natoms > 2000


def test_full_size_counts():
    """Config 4 (bubble rise) reaches its ~500k budget at dx 0.01 (build
    only)."""
    interp = Interpreter(variables={"dx": "0.01"}, device="cpu")
    interp.sim.screen = False
    lines = [line for line in
             open("cases/bubble_rise/in.bubble_rise").read().splitlines()
             if not line.strip().startswith(("run", "dump", "pair_", "fix",
                                             "thermo", "neighbor",
                                             "timestep"))]
    interp.run_string("\n".join(lines))
    assert interp.sim.natoms > 450_000


# ---------------------------------------------- golden logs

def golden_rows(name, tmp_path, nsteps=None):
    """Run ``name``'s golden script through the CLI on the CPU; its thermo
    rows and the golden log's."""
    spec = caselib.GOLDEN[name]
    gold_header, gold = caselib.parse_log(os.path.join(GOLDEN_DIR,
                                                       f"log.{name}"))
    if nsteps is None:
        nsteps = spec["run"]
    script = tmp_path / f"in.{name}"
    script.write_text(caselib.golden_script(name, nsteps))
    log = tmp_path / f"log.{name}"
    args = ["run", str(script), "--device", "cpu", "--log", str(log),
            "--screen", "none"]
    for k, v in spec["var"].items():
        args += ["-var", k, v]
    assert cli.main(args) == 0
    header, rows = caselib.parse_log(str(log))
    assert header == gold_header
    return header, rows, gold


@pytest.mark.parametrize("name", CASES)
def test_golden_first_interval(name, tmp_path):
    """The golden rows at step 0 and after the first thermo interval."""
    every = int(caselib.GOLDEN[name]["pre"][-2].split()[1])
    header, rows, gold = golden_rows(name, tmp_path, nsteps=every)
    assert rows[-1, 0] == every
    caselib.rows_within_bar(header, rows, gold)


@pytest.mark.slow
@pytest.mark.parametrize("name", CASES)
def test_golden_full_log(name, tmp_path):
    """Every golden row of the case."""
    header, rows, gold = golden_rows(name, tmp_path)
    assert rows[-1, 0] == gold[-1, 0]
    caselib.rows_within_bar(header, rows, gold)


def test_cli_runs_on_the_card_unless_asked(tmp_path):
    """``python -m tpusph_torch.cli run`` takes the card by default and
    raises where there is none (no CPU fallback); ``--mesh 4`` runs the
    script in four bricks; ``--profile`` writes a trace."""
    script = tmp_path / "in.tiny"
    script.write_text("variable x equal 1\n")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["run", str(script)])
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["run", str(script), "--mesh", "4"])
    # a 2D periodic block of fluid, 20 steps in four bricks (the JAX
    # package's cell grid on one device holds its trajectory in
    # tests/test_torch_dist.py)
    from test_dist import PERIODIC_SCRIPT
    block = tmp_path / "in.block"
    block.write_text(PERIODIC_SCRIPT.format(lx=3.2, lxf=3.15)
                     + "run 20\n")
    assert cli.main(["run", str(block), "--device", "cpu", "--mesh", "4",
                     "--screen", "none"]) == 0
    sim = cli.last_run.sim
    assert len(sim.mesh) == 4 and sim.brick_spec.shape == (4,)
    assert sim.step_count == 20 and sim.natoms == 512
    assert int(sim.aux.overflow.sum()) == 0
    assert np.isfinite(sim.get("x")).all()
    assert np.array_equal(sim.get("tag"), np.arange(1, 513))
    assert cli.main(["run", str(script), "--device", "cpu"]) == 0
    # --profile traces the run with torch.profiler into a Chrome trace
    prof = tmp_path / "prof"
    assert cli.main(["run", str(script), "--device", "cpu", "--profile",
                     str(prof)]) == 0
    assert (prof / "trace.json").exists()
