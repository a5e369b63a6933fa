"""Strip margin-floor decay (r4 VERDICT #2): the violation ratchet
(api.run's overflow catch) only ever ESCALATES _strip_extra/_strip_drift,
so one transient inflated the window W for the rest of the sim's life —
a permanent ~1.5x lane tax (W=384 vs 256, PERFORMANCE.md r4). The decay
path (api._maybe_decay_margins + MarginDecay continuation in api.run)
re-chooses a leaner geometry after K consecutive rebuilds measure >= 1
chunk of slack on both window sides. Reference analog: LAMMPS
re-neighboring carries no permanent penalty (SURVEY §3.2 rebuild branch).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, ".")

from tpusph.api import Simulation


def _sim(extra=None, n=12, nz=12):
    """A periodic ``n x n x nz`` lattice (dx 1), heat conduction only, a
    rebuild every 2 steps and a decay observation every 2. ``n`` sets the
    lattice planes along x and y, ``nz`` those along z."""
    dx = 1.0
    L = n * dx
    h = 2.4 * dx
    sim = Simulation(dim=3, screen=False)
    sim.backend_name = "strip"
    sim.create_box([0, 0, 0], [L, L, nz * dx], periodic=(True,) * 3,
                   ntypes=1)
    ax = np.arange(n, dtype=np.float32) * dx
    az = np.arange(nz, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, az, indexing="ij"), -1).reshape(-1, 3)
    sim.add_particles(g, np.ones(len(g), np.int32), rho=1.0, e=1.0,
                      cv=1.0, rmass=dx**3)
    e = np.where(g[:, 0] < L / 2, 1.5, 1.0).astype(np.float32)
    sim.set_values(np.ones(len(g), bool), e=e)
    sim.pair_heatconduction()
    sim.tables.set_heatconduction(1, 1, d=0.5, h=h)
    sim.neighbor_skin = 0.4 * dx
    sim.dt = 1e-3
    sim.thermo(2)          # callback (decay observation) every 2 steps
    sim.reneigh_every = 2  # force a rebuild every 2 steps (calm lattice)
    if extra is not None:
        sim._strip_extra = extra
    return sim


def _strip_w(sim):
    g = sim._current_strip_geom()
    assert g is not None, "strip geometry was abandoned"
    return g.w


def test_decay_shrinks_escalated_floor():
    # an artificially escalated floor (as a violation episode would leave
    # behind) must decay back once the measured need shows slack
    sim = _sim(extra=(128, 128))
    sim.run(2)
    w0 = _strip_w(sim)
    sim.run(28)
    w1 = _strip_w(sim)
    assert w1 < w0, (w0, w1)
    assert sim.step_count == 30
    # floors were lowered, drift reset
    assert sim._strip_extra[0] < 128 and sim._strip_extra[1] < 128
    assert getattr(sim, "_strip_drift", 1.0) == 1.0
    e = np.asarray(sim.get("e"))
    assert np.isfinite(e).all()


def test_decay_preserves_physics():
    # the decayed geometry must produce the same trajectory as a run that
    # never had the inflated floor (both windows cover cutoff+skin)
    sim_a = _sim(extra=(128, 128))
    sim_a.run(30)
    sim_b = _sim()
    sim_b.run(30)
    ea = np.asarray(sim_a.get("e"))   # get() is tag-ordered
    eb = np.asarray(sim_b.get("e"))
    np.testing.assert_allclose(ea, eb, rtol=0, atol=5e-6)


def test_no_decay_when_lean():
    # a lean geometry (no floors) must not thrash: decay either never
    # fires or is blocked after one no-op prediction — W stays put
    sim = _sim()
    sim.run(2)
    w0 = _strip_w(sim)
    sim.run(28)
    assert _strip_w(sim) <= w0
    assert sim.step_count == 30


def test_strip_retry_after_abandonment():
    # floors so large every strip candidate dies -> fallback backend; after
    # K calm rebuilds the retry re-chooses with fresh measures and strip
    # comes back (r5: the 500k bubble-rise settling wave abandoned strip
    # for the rest of the run before this path existed).
    # The lattice must be one that really abandons at these floors. The
    # 12^3 box does not: under the 1152-lane width cap it still strips, at
    # W 576. Nor does the torch port's 6 x 6 x 36: that test turns phase
    # change on (strip headroom 1.35), while this system has none (headroom
    # 1.08) and strips at W 1008. At 6 x 6 x 48 every candidate goes past the
    # cap, the strip is abandoned and the band backend runs; the lean
    # geometry the retry comes back to has W 128. The box is kept 6 wide,
    # more than twice cutoff plus skin (2 x 2.8 = 5.6), so no two periodic
    # images of one neighbour fall inside a particle's range.
    from tpusph.ops.strip_pair import StripBackend
    sim = _sim(extra=(4096, 4096), n=6, nz=48)
    with pytest.warns(RuntimeWarning, match="abandoned"):
        sim.run(2)
    assert not isinstance(sim._runner.backend, StripBackend)
    assert getattr(sim, "_strip_abandoned", False)
    sim.run(28)
    assert isinstance(sim._runner.backend, StripBackend)
    assert sim._strip_extra == (0, 0)
    assert sim.step_count == 30
    e = np.asarray(sim.get("e"))
    assert np.isfinite(e).all()
