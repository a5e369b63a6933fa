"""Strip margin-floor decay in the torch port (``Simulation._maybe_decay_
margins`` and the ``MarginDecay`` continuation in ``Simulation.run``): the
cases of tests/test_margin_decay.py that need no fallback backend. The
violation ratchet only ever raises the floors; after three consecutive
rebuilds that measure at least one chunk of slack on both window sides,
the decay re-chooses a leaner geometry and continues the run.

The strip retry after an abandoned geometry
(test_strip_retry_after_abandonment) needs a fallback backend to retry
from, which the port does not have yet (ROADMAP Queue 1 item 11).
"""

import numpy as np
import pytest
import torch

from tpusph_torch.api import Simulation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(extra=None, sim=None):
    """tests/test_margin_decay.py's system: a 12^3 lattice, heat conduction
    only, a rebuild every 2 steps and a decay observation every 2. ``sim``
    takes an empty simulation of the JAX package to build the same system
    there from the same numpy inputs."""
    dx = 1.0
    n = 12
    L = n * dx
    h = 2.4 * dx
    if sim is None:
        sim = Simulation(dim=3, screen=False, device="cpu")
    sim.create_box([0, 0, 0], [L, L, L], periodic=(True,) * 3, ntypes=1)
    ax = np.arange(n, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
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
