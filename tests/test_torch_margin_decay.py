"""Strip margin-floor decay and the strip retry in the torch port
(``Simulation._maybe_decay_margins``, ``_maybe_retry_strip`` and the
``MarginDecay`` continuation in ``Simulation.run``): the cases of
tests/test_margin_decay.py. The violation ratchet only ever raises the
floors; after three consecutive rebuilds that measure at least one chunk
of slack on both window sides, the decay re-chooses a leaner geometry and
continues the run. Floors so high that no strip geometry fits abandon the
strip for the column kernel (a phase-change run's fallback), and three
calm rebuilds later the retry re-chooses the strip from fresh measures.
"""

import numpy as np
import pytest
import torch

from tpusph_torch.api import Simulation
from tpusph_torch.ops.pallas_pair import PallasBackend
from tpusph_torch.ops.phase_change import PhaseChangeConfig
from tpusph_torch.ops.strip_pair import StripBackend


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(extra=None, sim=None, config_cls=None, n=12, nz=12):
    """tests/test_margin_decay.py's system: a 12^3 lattice, heat conduction
    only, a rebuild every 2 steps and a decay observation every 2. ``sim``
    takes an empty simulation of the JAX package to build the same system
    there from the same numpy inputs. ``config_cls``, a PhaseChangeConfig
    class, turns fix phase_change on: with no vapour type present no event
    fires, so the physics is the same, but the run's fallback backend is
    the column kernel. ``n`` and ``nz`` set the lattice planes along x and
    y, and along z."""
    dx = 1.0
    L = n * dx
    h = 2.4 * dx
    if sim is None:
        sim = Simulation(dim=3, screen=False, device="cpu")
        # the ladder from the strip: "auto" takes the dense rung at 2,048
        # particles or fewer
        sim.backend_name = "strip"
    sim.create_box([0, 0, 0], [L, L, nz * dx], periodic=(True,) * 3,
                   ntypes=1)
    ax = np.arange(n, dtype=np.float32) * dx
    az = np.arange(nz, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, az, indexing="ij"), -1).reshape(-1, 3)
    e = np.where(g[:, 0] < L / 2, 1.5, 1.0).astype(np.float32)
    sim.add_particles(g, np.ones(len(g), np.int32), rho=1.0, e=e, cv=1.0,
                      rmass=dx**3)
    sim.pair_heatconduction()
    sim.tables.set_heatconduction(1, 1, d=0.5, h=h)
    sim.neighbor_skin = 0.4 * dx
    sim.dt = 1e-3
    sim.thermo(2)
    sim.reneigh_every = 2
    if extra is not None:
        sim._strip_extra = extra
    if config_cls is not None:
        sim.configure_phase_change(config_cls(
            t_threshold=2.0, latent=1.0, dm=1e-3, liquid_type=1,
            vapor_type=2, every=2, cutoff=h))
    return sim


def _run(extra=None):
    """(sim, W after 2 steps) after 2 + 28 steps."""
    sim = _sim(extra)
    sim.run(2)
    w0 = sim._strip_geom.w
    sim.run(28)
    return sim, w0


@pytest.fixture(scope="module")
def escalated():
    # an artificially escalated floor, as a violation episode leaves behind
    return _run(extra=(128, 128))


@pytest.fixture(scope="module")
def lean():
    return _run()


def test_decay_shrinks_escalated_floor(escalated):
    # the escalated floor decays once the measured need shows slack
    sim, w0 = escalated
    assert sim._strip_geom.w < w0, (w0, sim._strip_geom.w)
    assert sim._strip_decays >= 1
    assert sim.step_count == 30
    assert sim._strip_extra[0] < 128 and sim._strip_extra[1] < 128
    assert sim._strip_drift == 1.0
    assert np.isfinite(sim.get("e")).all()


def test_decay_preserves_physics(escalated, lean):
    # the decayed geometry gives the trajectory of a run that never had
    # the inflated floor (both windows cover cutoff + skin), and both give
    # the JAX package's on its dense O(N^2) backend, from the same inputs
    # and the same 2 + 28 steps; the sums run over other windows and in
    # another order, so they agree to float32 rounding
    from tpusph.api import Simulation as JSimulation

    (sim_a, _), (sim_b, _) = escalated, lean
    assert sim_a._strip_decays >= 1 and sim_b._strip_decays == 0
    np.testing.assert_allclose(sim_a.get("e"), sim_b.get("e"), rtol=0,
                               atol=5e-6)
    ref = JSimulation(dim=3, screen=False)
    ref.backend_name = "dense"
    ref = _sim(sim=ref)
    ref.run(2)
    ref.run(28)
    e_ref = np.asarray(ref.get("e"))          # get() is tag-ordered
    for sim in (sim_a, sim_b):
        np.testing.assert_allclose(sim.get("e"), e_ref, rtol=0, atol=5e-6)


def test_no_decay_when_lean(lean):
    # a lean geometry does not thrash: decay never fires or is blocked
    # after one no-op prediction, and W stays put
    sim, w0 = lean
    assert sim._strip_geom.w <= w0
    assert sim.step_count == 30


def test_strip_retry_after_abandonment():
    """Floors so large that every strip candidate dies abandon the strip
    (a warning) for the column kernel; after three calm rebuilds the retry
    re-chooses with fresh measures and the strip comes back. The run
    gives the JAX package's dense trajectory of the same system.

    The 12^3 box of tests/test_margin_decay.py strips even at these floors
    since the width cap rose to 1152 rows: the margins clip to the column,
    and its columns of 320 slots give W = 704. A 6 x 6 x 36 box (2 x 2
    columns of 9 lattice sites per plane) makes every candidate's column
    long enough that the clipped window passes the cap."""
    from tpusph.api import Simulation as JSimulation
    from tpusph.ops.phase_change import PhaseChangeConfig as JConfig

    sim = _sim(extra=(4096, 4096), config_cls=PhaseChangeConfig, n=6,
               nz=36)
    with pytest.warns(RuntimeWarning, match="abandoned"):
        sim.run(2)
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim._strip_abandoned
    sim.run(28)
    assert isinstance(sim._runner.backend, StripBackend)
    assert sim._strip_extra == (0, 0)
    assert sim.step_count == 30
    ref = JSimulation(dim=3, screen=False)
    ref.backend_name = "dense"
    ref = _sim(sim=ref, config_cls=JConfig, n=6, nz=36)
    ref.run(2)
    ref.run(28)
    np.testing.assert_allclose(sim.get("e"), np.asarray(ref.get("e")),
                               rtol=0, atol=5e-6)
