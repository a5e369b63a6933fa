"""The torch port's main path end to end on the CPU: the bench ``dynamic``
configuration at 16^3 = 4096 particles (the smallest box that strips at
h = 3, skin = 1) through ``tpusph_torch.Simulation.run`` — strip layout,
seam refresh every step, rebuilds every 5 steps, the three sweeps' plain
versions, the Kahan-ledger integrator — against the JAX package's
``Simulation`` on its dense O(N^2) backend.

The lattice is translated by half a spacing (a pure translation in the
periodic box): the bench's exact lattice points sit on the strip column
edges, so the rebuild forced at step 0 would see column counts the chooser
never measured and overflow, in the JAX strip backend just as here.

Tolerance: 20 steps of float32 sums in a different order than the
oracle's; measured max differences are ~3e-6 (v), so atol 5e-5 with rtol
1e-5 holds a real margin without admitting a wrong term."""

import numpy as np
import pytest
import torch

from tpusph.bench import build_bench_sim as jax_bench_sim

from tpusph_torch.bench import build_bench_sim

N, STEPS, L = 4096, 20, 16.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: at these sizes the default pool takes
    ~2.5x the CPU time of one thread, and the suite's parallel workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_dynamic_slice_matches_dense():
    ref = jax_bench_sim(N, backend="dense", mode="dynamic")
    ref._staged["x"] += 0.5
    ref.run(STEPS)

    sim = build_bench_sim(N, mode="dynamic", device="cpu")
    sim._staged["x"] += 0.5
    sim.reneigh_every = 5
    sim.run(STEPS)
    assert sim._strip_violations == 0
    # init_aux plus the forced rebuilds at steps 0, 5, 10, 15
    assert int(sim.aux.nbuilds.sum()) == 5
    assert sim.natoms == N

    np.testing.assert_array_equal(sim.get("tag"), ref.get("tag"))
    for field in ("rho", "e", "v"):
        np.testing.assert_allclose(sim.get(field), ref.get(field),
                                   rtol=1e-5, atol=5e-5, err_msg=field)
    # positions wrap only at rebuilds in the strip backend and every step
    # in the dense one: compare under the minimum image
    d = sim.get("x") - ref.get("x")
    d -= L * np.round(d / L)
    assert np.abs(d).max() < 5e-5, np.abs(d).max()


def test_rechoice_continuation_follows_uninterrupted_run():
    """The geometry re-choice's continuation (``_continue_after_abort``,
    then a run that re-chooses the geometry from the pulled state,
    rebuilds, restores f/de/drho by tag and skips the setup force pass)
    follows the uninterrupted trajectory. Both runs rebuild at step 2
    (reneigh_every = 2), so only the summation order can differ: ~1e-7
    measured, 1e-5 allowed; a continuation that loses f/de/drho is off by
    ~1e-2 in v."""
    sims = []
    for interrupted in (False, True):
        sim = build_bench_sim(N, mode="dynamic", device="cpu")
        sim._staged["x"] += 0.5
        sim.reneigh_every = 2
        if interrupted:
            sim.run(2)
            assert sim._continue_after_abort() == 0
            assert sim.state is None
            sim._run_once(2, pre=False)
        else:
            sim.run(4)
        assert sim.step_count == 4
        sims.append(sim)
    a, b = sims
    np.testing.assert_array_equal(a.get("tag"), b.get("tag"))
    for field in ("rho", "e", "v", "x"):
        np.testing.assert_allclose(b.get(field), a.get(field), rtol=1e-5,
                                   atol=1e-5, err_msg=field)
