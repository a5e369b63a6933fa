"""The column-kernel path of the torch port end to end on the CPU:
``Simulation.run`` on ``PallasBackend`` (the plain versions of the column
kernels, the cell-grid sort and rebuild, the cell-grid vapor query, fix
phase_change), against the JAX package's ``Simulation`` on its dense
O(N^2) backend; and the backend ladder that sends a phase-change run which
cannot strip (or asks for band) to the column kernel.

The system is tests/test_phase_change.py's 12^3 vapour bubble
(``tpusph_torch.bench.build_bubble_sim``) with prob = 1 and
require_interface, so no random draw decides an event and both packages
fire the same events. Bars, those of tests/test_torch_phase_change.py (the
JAX package's strip-vs-cellgrid gate): the same natoms; per-phase mass and
energy sums to 1e-4 relative; the original particles by tag (x, e, rmass)
to rtol 1e-4 / atol 1e-5; inserted vapour positions as a multiset."""

import numpy as np
import pytest
import torch

from tpusph.api import Simulation as JSimulation
from tpusph.ops.pallas_pair import PallasBackend as JPallasBackend
from tpusph.ops.phase_change import PhaseChangeConfig as JConfig

from tpusph_torch.bench import BUBBLE_DX as DX
from tpusph_torch.bench import BUBBLE_SIDE as N_SIDE
from tpusph_torch.bench import build_bubble_sim
from tpusph_torch.ops.band_pair import BandBackend
from tpusph_torch.ops.pallas_pair import PallasBackend

from test_torch_phase_change import inserted_x, originals

L = N_SIDE * DX
STEPS = 10
# z planes of the box too short to strip: 2.5 < 4 x (cutoff + skin) = 3.0
NZ_SHORT = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_sim(backend="dense", **kw):
    sim = JSimulation(dim=3, screen=False)
    return build_bubble_sim(sim=sim, config_cls=JConfig, backend=backend,
                            **kw)


@pytest.mark.parametrize("mode", ["insert", "grow"])
def test_bubble_on_column_kernel_matches_dense(mode):
    ref = jax_sim(mode=mode)
    n0 = ref.natoms
    ref.run(STEPS)
    sim = build_bubble_sim(device="cpu", backend="pallas", mode=mode)
    sim.run(STEPS)
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim._strip_geom is None

    if mode == "insert":
        assert ref.natoms > n0, "no evaporation events fired"
    assert sim.natoms == ref.natoms
    ta, tb = ref.get("type"), sim.get("type")
    for field in ("rmass", "e"):
        for phase in (1, 2):
            a = float(ref.get(field)[ta == phase].astype(np.float64).sum())
            b = float(sim.get(field)[tb == phase].astype(np.float64).sum())
            assert b == pytest.approx(a, rel=1e-4), (field, phase)
    a, b = originals(ref, n0), originals(sim, n0)
    d = b["x"] - a["x"]
    b["x"] = a["x"] + d - L * np.round(d / L)
    for f in ("x", "e", "rmass"):
        np.testing.assert_allclose(b[f], a[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    if mode == "insert":
        xa, xb = inserted_x(ref, n0), inserted_x(sim, n0)
        assert len(xa) == len(xb)
        np.testing.assert_allclose(xb, xa, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(tb, ta)
        assert (sim.get("rmass")[tb == 2].sum()
                > (DX**3 / 10) * (tb == 2).sum())


def test_phase_change_that_cannot_strip_takes_column_kernel():
    """A periodic column axis shorter than 4 x (cutoff + skin): the seam
    bands would overlap, so no strip geometry exists. On the ladder from
    the strip ("strip", what "auto" takes above 2,048 particles; these
    1,440 would take the dense rung) a phase-change run goes to the column
    kernel and fires events; the JAX package's ladder (its TPU form,
    "strip") picks its column kernel on the same inputs; a run without
    phase change takes band, with the band geometry the JAX package's
    chooser gives on the same inputs."""
    sim = build_bubble_sim(device="cpu", backend="strip", nz=NZ_SHORT)
    n0 = sim.natoms
    sim.run(4)
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim.natoms > n0
    assert np.isfinite(sim.get("e")).all()

    ref = jax_sim(backend="strip", nz=NZ_SHORT)
    assert isinstance(ref._select_backend(), JPallasBackend)
    assert ref._select_backend().geom.cap == sim._runner.backend.geom.cap

    plain = build_bubble_sim(device="cpu", backend="strip", nz=NZ_SHORT)
    plain.remove_end_of_step_hook("phase_change")
    plain.phase_change_config = None
    plain.run(1)
    assert isinstance(plain._runner.backend, BandBackend)
    ref.remove_end_of_step_hook("phase_change")
    ref.phase_change_config = None
    assert tuple(plain._band_geom) == tuple(ref._select_band_backend().geom)


def test_cell_overflow_remeasures_with_boosted_cap():
    """A cell holding more rows than its capacity is an overflow with no
    margin shortfall: the run re-measures the cap with the headroom boosted
    x1.5 and continues from where it stood, as the reference does. A boost
    of 0.5 makes the first measured cap (fullest cell x 0.8 + 2) too small;
    the re-measure at 0.75, from the pulled (wrapped) positions, holds
    every row."""
    sim = build_bubble_sim(device="cpu", backend="pallas")
    sim._cap_boost = 0.5
    first = sim._measured_cell_cap(float(sim.tables.max_cut()),
                                   sim.neighbor_skin)
    sim.run(2)
    assert sim._strip_violations == 1 and sim._cap_boost == 0.75
    assert first < sim._runner.backend.geom.cap
    assert int(sim.aux.overflow.sum()) == 0
    assert sim.step_count == 2 and np.isfinite(sim.get("e")).all()


def test_phase_change_under_band_takes_column_kernel():
    """``backend_name = "band"`` on a phase-change run: band has no
    particle pool, so the ladder falls through to the column kernel, as
    the JAX package's does (its band rung returns None for the run)."""
    sim = build_bubble_sim(device="cpu", backend="band")
    n0 = sim.natoms
    sim.run(2)
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim._band_geom is None and sim.natoms > n0
    assert jax_sim(backend="band")._select_band_backend() is None


@pytest.mark.parametrize("name,error,match", [
    ("cellgrid", None, None),
    ("dense", None, None),
    ("bogus", ValueError, "unknown backend"),
])
def test_backends_not_ported_raise(name, error, match):
    """Every rung of the reference's ladder is ported, and an unknown name
    is an error. The cell grid's sweeps and the dense rung: the bubble runs
    on each in insert mode for STEPS steps and is held to the JAX package's
    dense backend at the bars of
    ``test_bubble_on_column_kernel_matches_dense`` (the same events,
    per-phase sums, originals, inserted positions)."""
    sim = build_bubble_sim(device="cpu", backend=name)
    if error is not None:
        with pytest.raises(error, match=match):
            sim.run(1)
        return
    ref = jax_sim(mode="insert")
    n0 = ref.natoms
    ref.run(STEPS)
    sim.run(STEPS)
    from tpusph_torch.ops.cellgrid import CellGridBackend
    from tpusph_torch.ops.dense import DenseBackend
    assert isinstance(sim._runner.backend, {
        "cellgrid": CellGridBackend, "dense": DenseBackend}[name])
    assert ref.natoms > n0 and sim.natoms == ref.natoms
    ta, tb = ref.get("type"), sim.get("type")
    for field in ("rmass", "e"):
        for phase in (1, 2):
            a = float(ref.get(field)[ta == phase].astype(np.float64).sum())
            b = float(sim.get(field)[tb == phase].astype(np.float64).sum())
            assert b == pytest.approx(a, rel=1e-4), (field, phase)
    a, b = originals(ref, n0), originals(sim, n0)
    d = b["x"] - a["x"]
    b["x"] = a["x"] + d - L * np.round(d / L)
    for f in ("x", "e", "rmass"):
        np.testing.assert_allclose(b[f], a[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    xa, xb = inserted_x(ref, n0), inserted_x(sim, n0)
    assert len(xa) == len(xb)
    np.testing.assert_allclose(xb, xa, rtol=1e-4, atol=1e-5)
