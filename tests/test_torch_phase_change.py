"""fix phase_change in the torch port (``tpusph_torch.ops.phase_change``
through ``Simulation.run`` on the strip backend, with the vapor sweep's
plain version) against the JAX package's ``Simulation`` on its dense
O(N^2) backend, and against its own ledgers.

The system is tests/test_phase_change.py's 12^3 vapour bubble in a hot
liquid shell: conduction with T_sat pinning only, prob = 1 and
require_interface, so no random draw decides an event and the two
packages fire the same events. Each interface liquid fires once (one
event drops T below the threshold and rmass below m_min + dm).

Bars, those of the JAX package's own strip-vs-cellgrid gate
(tests/test_phase_change.py:169-225): the same natoms; per-phase mass and
energy sums to 1e-4 relative; the original particles by tag (x, e,
rmass) to rtol 1e-4 / atol 1e-5; inserted vapour positions as a multiset
(the two backends fill different pool slots, so inserted tags differ)."""

import numpy as np
import pytest
import torch

from tpusph.api import Simulation as JSimulation
from tpusph.ops.phase_change import PhaseChangeConfig as JConfig

from tpusph_torch.api import Simulation
from tpusph_torch.bench import BUBBLE_DX as DX
from tpusph_torch.bench import BUBBLE_SIDE as N_SIDE
from tpusph_torch.bench import build_bubble_sim
from tpusph_torch.ops.phase_change import PhaseChangeConfig

L = N_SIDE * DX
STEPS = 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_sim(**kw):
    return build_bubble_sim(device="cpu", **kw)


def jax_sim(**kw):
    """The same bubble, from the same numpy inputs, through the JAX
    package's API on its dense backend."""
    sim = JSimulation(dim=3, screen=False)
    sim.backend_name = "dense"
    return build_bubble_sim(sim=sim, config_cls=JConfig, **kw)


def originals(sim, n0):
    tag = sim.get("tag")
    keep = tag <= n0
    order = np.argsort(tag[keep])
    return {f: sim.get(f)[keep][order] for f in ("x", "e", "rmass")}


def inserted_x(sim, n0):
    x = sim.get("x")[sim.get("tag") > n0]
    x = x - L * np.floor(x / L)     # the dense backend wraps every step
    return x[np.lexsort(x.T)]


@pytest.mark.parametrize("mode", ["insert", "grow"])
def test_bubble_matches_dense(mode):
    ref = jax_sim(mode=mode)
    n0 = ref.natoms
    ref.run(STEPS)
    sim = port_sim(mode=mode)
    sim.run(STEPS)

    if mode == "insert":
        assert ref.natoms > n0, "no evaporation events fired"
    assert sim.natoms == ref.natoms
    for field in ("rmass", "e"):
        ta, tb = ref.get("type"), sim.get("type")
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
        # grow mode moves mass onto existing vapour: the vapour gained it
        assert (sim.get("rmass")[sim.get("type") == 2].sum()
                > (DX**3 / 10) * (sim.get("type") == 2).sum())


def test_ledgers_with_random_selection():
    """prob < 1: the port's own ledgers in a conduction-only box (plain
    heat conduction conserves sum(e) exactly in the pair sums). Mass is
    conserved to float32 rounding of the sums (1e-6), the internal energy
    drops by latent * dm per event to 1e-4 relative, and a rerun with the
    same seed fires the same events (the per-step generator)."""
    sim, again = (port_sim(prob=0.5, tsat=False) for _ in range(2))
    n0 = sim.natoms
    m0 = float(sim._staged["rmass"].astype(np.float64).sum())
    e0 = float(sim._staged["e"].astype(np.float64).sum())
    sim.run(STEPS)
    again.run(STEPS)
    cfg = sim.phase_change_config
    events = sim.natoms - n0
    assert 0 < events
    m1 = float(sim.get("rmass").astype(np.float64).sum())
    e1 = float(sim.get("e").astype(np.float64).sum())
    assert m1 == pytest.approx(m0, rel=1e-6)
    assert e0 - e1 == pytest.approx(cfg.latent * cfg.dm * events, rel=1e-4)
    liquid = sim.get("type") == 1
    assert float((DX**3 - sim.get("rmass")[liquid]).sum()) == pytest.approx(
        cfg.dm * events, rel=1e-4)
    np.testing.assert_array_equal(again.get("tag"), sim.get("tag"))
    np.testing.assert_array_equal(inserted_x(again, n0), inserted_x(sim, n0))


def test_simulation_runs_on_the_card_unless_asked(monkeypatch):
    """No CPU fallback in the entry points: with no CUDA device,
    ``Simulation()`` and the bench builder raise and name device="cpu"."""
    from tpusph_torch.bench import build_bench_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Simulation()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_bench_sim(4096, mode="boiling")
    assert Simulation(device="cpu").device == torch.device("cpu")


def test_min_image_matches_jax():
    """Box.min_image against the JAX package's on displacements that
    include exact half-box lengths (both round half to even)."""
    import jax.numpy as jnp
    from tpusph.state import Box as JBox
    from tpusph_torch.state import Box

    rng = np.random.default_rng(3)
    lo, hi = [0.0, -1.0, 0.5], [3.0, 2.0, 4.5]
    dx = rng.uniform(-7.0, 7.0, (512, 3)).astype(np.float32)
    dx[:6] = [[1.5, 1.5, 2.0], [-1.5, -1.5, -2.0], [4.5, 4.5, 6.0],
              [-4.5, 0.0, 0.0], [3.0, 3.0, 4.0], [0.0, 0.0, 0.0]]
    for per in ((True, True, True), (True, False, True),
                (False, False, False)):
        want = np.asarray(JBox.create(lo, hi, per).min_image(
            jnp.asarray(dx)))
        got = Box.create(lo, hi, per).min_image(torch.as_tensor(dx)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(per))


def test_config_from_script_args_matches_jax():
    args = ["2.0", "0.5", "1.0e-4", "1", "2", "every", "5", "prob", "0.25",
            "mmin", "1e-3", "offset", "0.01", "mode", "grow", "vapor_rho",
            "0.2", "vapor_cv", "2.0", "seed", "7", "cutoff", "0.3",
            "nointerface"]
    want = JConfig.from_script_args(args)
    got = PhaseChangeConfig.from_script_args(args)
    assert got.__dict__ == want.__dict__
    with pytest.raises(ValueError, match="unknown keyword"):
        PhaseChangeConfig.from_script_args(args[:5] + ["bogus", "1"])
