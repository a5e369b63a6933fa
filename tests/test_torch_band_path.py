"""The band path of the torch port end to end on the CPU: ``Simulation.run``
on ``BandBackend`` (the plain versions of the band kernels, the slot
build and its skin/2 rebuilds), and the rungs of the backend ladder that
lead to band and away from it, against the JAX package's ``Simulation`` on
its XLA backends (cellgrid, dense), never its interpret-mode band kernel.

- tests/test_band.py's dynamic 10^3 system with ``backend_name = "band"``
  against the reference's cell grid, at that test's 5e-4 (20 steps of its
  40);
- a run without phase change whose strip is abandoned under escalated
  margin floors takes band, warns, and three calm rebuilds later comes
  back to the strip (tests/test_torch_margin_decay.py's retry system, fix
  phase_change off, 44 planes long), with the reference's dense
  trajectory;
- a box whose periodic column axis is too short for both the strip and the
  band (both reference choosers return None) takes the column kernel;
- a band slot overflow re-measures the geometry from the evolved state and
  continues, with the dense trajectory."""

import warnings

import numpy as np
import pytest
import torch

from tpusph.api import Simulation as JSimulation
from tpusph.ops import band_pair as jbp
from tpusph.ops import strip_pair as jsp
from tpusph.state import Box as JBox

from tpusph_torch import api
from tpusph_torch.api import Simulation
from tpusph_torch.ops.band_pair import BandBackend
from tpusph_torch.ops.pallas_pair import PallasBackend
from tpusph_torch.ops.strip_pair import StripBackend

from test_torch_margin_decay import _sim


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dynamic_sim(sim, backend):
    """tests/test_band.py::test_band_dynamics_matches_cellgrid's system: a
    jittered 10^3 lattice (dx 0.5) with random velocities, rhosum + Tait,
    skin 0.25, on ``backend``."""
    sim.backend_name = backend
    rng = np.random.default_rng(7)
    side, dx = 10, 0.5
    ax = np.arange(side) * dx
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    g = g + rng.uniform(-0.05, 0.05, g.shape)
    L = side * dx
    sim.create_box([0, 0, 0], [L, L, L], periodic=(True,) * 3, ntypes=1)
    v = rng.normal(0, 0.05, g.shape)
    sim.add_particles(g.astype(np.float32), 1, v=v.astype(np.float32),
                      rho=1.0, e=1.0, cv=1.0, rmass=0.125)
    sim.pair_rhosum(1)
    sim.pair_taitwater()
    sim.tables.set_taitwater(1, 1, rho0=1.0, c0=8.0, viscosity=0.3,
                             h=2.2 * dx)
    sim.tables.set_rhosum(1, 1, h=2.2 * dx)
    sim.neighbor_skin = 0.25
    sim.dt = 5e-4
    sim.thermo(0)
    return sim


def test_band_dynamics_matches_cellgrid():
    """tests/test_band.py's system on band against the reference's cell
    grid (the reference test runs band in interpret mode; here the port's
    band path meets the reference's XLA cell grid directly). The steps are
    cut from that test's 40 to 20: the plain band sweeps scan 9 x 16
    sub-cells per group on this small box, and 40 steps took 13 s on one
    CPU thread."""
    sim = dynamic_sim(Simulation(dim=3, screen=False, device="cpu"), "band")
    sim.run(20)
    assert isinstance(sim._runner.backend, BandBackend)
    assert sim._strip_geom is None and sim._band_geom is not None
    ref = dynamic_sim(JSimulation(dim=3, screen=False), "cellgrid")
    ref.run(20)
    for field in ("x", "v", "rho", "e"):
        np.testing.assert_allclose(sim.get(field), np.asarray(ref.get(field)),
                                   rtol=5e-4, atol=5e-4, err_msg=field)


def dense_e(n, nz, steps, **kw):
    """e of the reference's dense run of the ``_sim`` system (tag order)."""
    ref = JSimulation(dim=3, screen=False)
    ref.backend_name = "dense"
    ref = _sim(sim=ref, n=n, nz=nz, **kw)
    for k in steps:
        ref.run(k)
    return np.asarray(ref.get("e"))


def test_abandoned_strip_takes_band_then_returns():
    """Floors so high that no strip geometry fits abandon the strip (a
    warning); a run without phase change falls back to band, and after
    three calm rebuilds the retry re-chooses the strip from fresh
    measures. The trajectory is the reference's dense one.

    Without phase change the strip's column headroom is 1.08, not 1.35, so
    tests/test_torch_margin_decay.py's 6 x 6 x 36 box still strips at these
    floors (the margins clip to its columns: W = 1008 < 1152); at 44
    planes no candidate fits."""
    sim = _sim(extra=(4096, 4096), n=6, nz=44)
    with pytest.warns(RuntimeWarning, match="abandoned"):
        sim.run(2)
    assert isinstance(sim._runner.backend, BandBackend)
    assert sim._strip_abandoned and sim.rebuilds == 2
    sim.run(28)
    assert isinstance(sim._runner.backend, StripBackend)
    assert sim._strip_extra == (0, 0) and not sim._strip_abandoned
    assert sim._strip_decays == 1 and sim.step_count == 30
    np.testing.assert_allclose(sim.get("e"), dense_e(6, 44, (2, 28)),
                               rtol=0, atol=5e-6)


def test_no_strip_no_band_takes_column_kernel():
    """A periodic column axis of 5 lattice planes: shorter than 4 x (cutoff
    + skin) = 11.2, so the seam bands would overlap (no strip), and shorter
    than 2 x (cutoff + skin), so every band window would wrap onto itself
    (no band); the reference's choosers say the same. A run without phase
    change takes the column kernel, and its trajectory is the reference's
    dense one (the axis is still longer than 2 x cutoff, so no pair meets
    two images)."""
    sim = _sim(n=8, nz=5)
    x = sim._staged["x"]
    jbox = JBox.create([0, 0, 0], [8.0, 8.0, 5.0], (True,) * 3)
    assert jsp.choose_strip_geometry(jbox, 2.4, 3, 0.4, x=x) is None
    assert jbp.choose_band_geometry(jbox, 2.4, 3, 0.4, x=x) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # not an abandonment
        sim.run(6)
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim._strip_geom is None and sim._band_geom is None
    np.testing.assert_allclose(sim.get("e"), dense_e(8, 5, (6,)),
                               rtol=0, atol=5e-6)


def ballistic_sim(sim, v_seed=3):
    """``_sim``'s 8 x 8 x 24 lattice (heat conduction only, a rebuild
    every 2 steps) with random velocities: no force moves the particles,
    so they cross sub-cell edges ballistically."""
    sim = _sim(sim=sim, n=8, nz=24)
    n = len(sim._staged["x"])
    sim._staged["v"] = np.random.default_rng(v_seed).normal(
        0, 0.5, (n, 3)).astype(np.float32)
    sim.dt = 1e-2
    return sim


def test_band_overflow_remeasures_and_continues(monkeypatch):
    """The first band geometry is chosen with its slot capacity equal to
    the fullest sub-cell of the lattice (48 rows: a headroom of 45.5 / 48
    where the chooser adds 2 and rounds up to 8); the first rebuild after
    particles cross sub-cell edges overflows. The run re-measures from the
    evolved state (the default headroom), continues from the step it
    stood at, and gives the reference's dense trajectory."""
    chosen = []
    choose_band_geometry = api.choose_band_geometry

    def choose(*a, **kw):
        if not chosen:
            kw["headroom"] = 45.5 / 48
        chosen.append(choose_band_geometry(*a, **kw))
        return chosen[-1]

    monkeypatch.setattr(api, "choose_band_geometry", choose)
    sim = ballistic_sim(Simulation(dim=3, screen=False, device="cpu"))
    sim.backend_name = "band"
    sim.run(10)
    assert [g.c for g in chosen] == [48, 64]
    assert sim._strip_violations == 1 and sim.step_count == 10
    assert isinstance(sim._runner.backend, BandBackend)
    assert int(sim.aux.overflow.sum()) == 0 and sim.natoms == 8 * 8 * 24
    ref = ballistic_sim(JSimulation(dim=3, screen=False))
    ref.backend_name = "dense"
    ref.run(10)
    np.testing.assert_allclose(sim.get("e"), np.asarray(ref.get("e")),
                               rtol=0, atol=5e-6)
    # positions up to the periodic wrap
    d = sim.get("x") - np.asarray(ref.get("x"))
    L = np.array([8.0, 8.0, 24.0], np.float32)
    np.testing.assert_allclose(d - L * np.round(d / L), 0.0, atol=5e-6)
