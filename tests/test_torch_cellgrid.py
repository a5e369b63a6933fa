"""The port's cell grid (``tpusph_torch.grid``), its vapor query and its
three sweeps (``tpusph_torch.ops.cellgrid.CellGridBackend``) against the
JAX package's (``tpusph.grid``, ``tpusph.ops.cellgrid``), on jittered and
exact two-type lattices, 2D and 3D, periodic and not.

Bars of the layout and the query: all exact. The geometry field for field,
the neighbour tables, the sorted order (by tag), cell ids, counts, starts,
ranks and the overflow count; the measured cell cap; the vapor query's
count, nearest row, rsq and nearest owned row and rsq on every row. On an
exact lattice many vapour neighbours share one rsq, so the first-minimum
tie rule decides.

The sweeps mirror tests/test_cellgrid.py: against the JAX package's cell
grid on the same sorted rows and against the port's dense rung by tag, at
that file's bars (rho rtol 2e-5 / atol 1e-6; colour gradient 2e-4 / 2e-4;
f 2e-4 / 5e-4; drho 2e-4 / 5e-5; de 2e-4 / 5e-4), a lone particle seeing
its own periodic images, and 40 steps of dynamics against the dense rung
(thermo rtol 5e-4, positions atol 5e-4); and ``Simulation`` on the cell
grid (named, or seven types) against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph import grid as jgrid
from tpusph import kernels as jkernels
from tpusph.api import Simulation as JSimulation
from tpusph.ops.cellgrid import CellGridBackend as JCellGrid
from tpusph.params import PhysicsSpec as JSpec
from tpusph.state import Box as JBox

from tpusph_torch import grid, kernels
from tpusph_torch.api import Simulation
from tpusph_torch.ops import dense
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.ops.dense import DenseBackend
from tpusph_torch.params import PhysicsSpec, tables_from_numpy
from tpusph_torch.runner import Runner, thermo_scalars
from tpusph_torch.state import Box, state_from_numpy

from test_cellgrid import random_system, stable_lattice_system
from test_pallas import lattice_system
from test_torch_strip_sweeps import host

VTYPE = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(3, True, 5, True), (3, False, 6, True), (2, True, 7, True),
         (2, False, 8, True), (3, True, 9, False), (2, False, 10, False)]


def _system(dim, periodic, seed, jitter):
    st, box, tables = lattice_system(dim, nside=8 if dim == 3 else 16,
                                     seed=seed, periodic=periodic)
    if not jitter:
        nside = 8 if dim == 3 else 16
        ax = [np.arange(nside) * 0.5] * dim
        pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
        x = np.array(st.x)
        x[:len(pts), :dim] = pts
        st = dataclasses.replace(st, x=jnp.asarray(x))
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    return st, box, tables, tbox


def _layouts(dim, periodic, seed, jitter, cap=None):
    st, box, tables, tbox = _system(dim, periodic, seed, jitter)
    cut = float(tables.max_cut())
    jgeom = jgrid.make_geometry(box, cut, dim, skin=0.2, cap=cap)
    geom = grid.make_geometry(tbox, cut, dim, skin=0.2, cap=cap)
    jst, jdata = JCellGrid(jgeom).init_aux(st, box)
    backend = CellGridBackend(geom)
    tst, data = backend.init_aux(state_from_numpy(host(st)), tbox)
    return jgeom, geom, jst, jdata, backend, tst, data, tbox, box, cut


@pytest.mark.parametrize("dim,periodic,seed,jitter", CASES)
def test_build_matches_jax(dim, periodic, seed, jitter):
    # the default cap, and a tight one that overflows
    for cap in (None, 4 if dim == 3 else 2):
        jgeom, geom, jst, jdata, backend, tst, data, *_ = _layouts(
            dim, periodic, seed, jitter, cap=cap)
        assert tuple(geom) == tuple(jgeom)
        want = host(jst)
        for f in ("tag", "type", "x"):
            np.testing.assert_array_equal(getattr(tst, f).numpy(), want[f],
                                          f)
        for f in ("cell_id", "starts", "counts", "rank", "overflow",
                  "nbuilds"):
            np.testing.assert_array_equal(getattr(data, f).numpy(),
                                          np.asarray(getattr(jdata, f)), f)
        assert (int(data.overflow[0]) > 0) == (cap is not None)
    flat, shift = grid.neighbor_cell_ids(geom)
    jflat, jshift = jgrid.neighbor_cell_ids(jgeom)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(shift, jshift)


@pytest.mark.parametrize("dim,periodic,seed,jitter", CASES)
def test_vapor_neighbor_matches_jax(dim, periodic, seed, jitter):
    jgeom, geom, jst, jdata, backend, tst, data, tbox, box, cut = _layouts(
        dim, periodic, seed, jitter)
    got = backend.vapor_neighbor(tst, tbox, VTYPE, cut, data)
    want = JCellGrid(jgeom).vapor_neighbor(jst, box, VTYPE, cut, jdata)
    for name, a, b in zip(("count", "nearest", "rsq", "near_owned",
                           "rsq_owned"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    count = got[0].numpy()
    assert (count > 0).sum() > 0.3 * (tst.type > 0).sum().item()
    if not jitter:
        # ties decided the nearest: rows with two candidates at the least rsq
        x = tst.x.numpy()
        near = got[1].numpy()
        d = x - x[near]
        L = tbox.length.numpy()
        per = np.asarray(box.periodic)
        d = np.where(per, d - L * np.round(d / L), d)
        rsq = (d * d).sum(-1)
        vap = tst.type.numpy() == VTYPE
        has = count > 0
        ties = 0
        for i in np.nonzero(has)[0][:200]:
            dj = x[vap] - x[i]
            dj = np.where(per, dj - L * np.round(dj / L), dj)
            r2 = (dj * dj).sum(-1)
            r2 = r2[r2 > 1e-12]
            ties += int((np.abs(r2 - rsq[i]) < 1e-6).sum() >= 2)
        assert ties > 20


def test_measured_cell_cap_matches_jax():
    """``Simulation._measured_cell_cap`` (measured occupancy x 1.15, or x
    1.6 under phase change, x the overflow boost, + 2, 8-aligned) on the
    same staged positions in both packages."""
    st, box, tables, _ = _system(3, True, 3, True)
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    for boost in (1.0, 1.5):
        for sim in (Simulation(device="cpu", screen=False),
                    JSimulation(screen=False)):
            sim.create_box(np.asarray(box.lo), np.asarray(box.hi),
                           box.periodic, ntypes=2)
            sim.add_particles(x, np.ones(len(x), np.int32))
            sim._cap_boost = boost
            caps = [sim._measured_cell_cap(1.1, 0.2)]
            sim.phase_change_config = object()
            caps.append(sim._measured_cell_cap(1.1, 0.2))
            if isinstance(sim, Simulation):
                got = caps
            else:
                want = caps
        assert got == want, (boost, got, want)


# -------------------------------------------------------- the three sweeps

SWEEP_BARS = {"rho": (2e-5, 1e-6), "cg": (2e-4, 2e-4), "f": (2e-4, 5e-4),
              "drho": (2e-4, 5e-5), "de": (2e-4, 5e-4)}


def _port(st, box, tables, dim, skin=0.1, cap=64):
    """The port's cell grid on the JAX package's state: (backend, sorted
    state, aux, device tables, box)."""
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    geom = grid.make_geometry(tbox, float(tables.max_cut()), dim, skin=skin,
                              cap=cap)
    be = CellGridBackend(geom, box=tbox)
    tst, data = be.init_aux(state_from_numpy(host(st)), tbox)
    return be, tst, data, tables_from_numpy(host(tables)).stacked("cpu"), \
        tbox


def _by_tag(values, state):
    """Rows of ``values`` (sorted-row order) in tag order, alive rows."""
    tag = state.tag.numpy()
    alive = state.type.numpy() > 0
    order = np.argsort(tag[alive], kind="stable")
    return np.asarray(values)[alive][order]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (False, False, False)])
def test_cellgrid_sweeps_match_jax_and_dense(dim, periodic):
    """rho, colour gradient and the force sweep on random two-type systems
    (tests/test_cellgrid.py's): against the JAX package's cell grid on the
    same sorted rows, and against the port's dense rung by tag."""
    st, box, tables = random_system(dim=dim, periodic=periodic, seed=dim)
    kw = dict(dim=dim, kernel=jkernels.LUCY, tait=True, heatconduction=True,
              surface_tension=True, rhosum_every=1)
    jspec, spec = JSpec(**kw), PhysicsSpec(**kw)
    geom = jgrid.make_geometry(box, tables.max_cut(), dim, skin=0.1, cap=64)
    jbe = JCellGrid(geom)
    jst, jdata = jbe.init_aux(st, box)
    want = dict(rho=jbe.rho_summation(jst, tables, jspec, box, aux=jdata))
    want["cg"] = jbe.color_gradient(jst, tables, jspec, box, aux=jdata)
    want["f"], want["drho"], want["de"] = jbe.force(
        jst, tables, jspec, box, aux=jdata, cg=want["cg"])

    be, tst, data, tabs, tbox = _port(st, box, tables, dim)
    assert int(data.overflow[0]) == 0
    got = dict(rho=be.rho_summation(tst, tabs, spec, tbox, data))
    got["cg"] = be.color_gradient(tst, tabs, spec, tbox, data)
    got["f"], got["drho"], got["de"] = be.force(tst, tabs, spec, tbox,
                                                data, cg=got["cg"])
    oracle = dict(rho=dense.rho_summation(tst, tabs, spec, tbox))
    oracle["cg"] = dense.color_gradient(tst, tabs, spec, tbox)
    oracle["f"], oracle["drho"], oracle["de"] = dense.force(
        tst, tabs, spec, tbox, cg=oracle["cg"])
    np.testing.assert_array_equal(tst.tag.numpy(), np.asarray(jst.tag))
    for k, (rtol, atol) in SWEEP_BARS.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
        np.testing.assert_allclose(_by_tag(got[k], tst),
                                   _by_tag(oracle[k], tst), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_cellgrid_small_periodic_box_self_image():
    """A box under 2 cells wide: a lone particle sees its own periodic
    images (which the dense rung's minimum image cannot), against the
    analytic sum and the JAX package's cell grid."""
    from tpusph.params import PairTables as JTables
    from tpusph.state import ParticleState as JState
    cut = 0.9
    jtables = JTables.zeros(1)
    jtables.set_rhosum(1, 1, h=cut)
    spec, jspec = PhysicsSpec(dim=3, kernel=kernels.LUCY), \
        JSpec(dim=3, kernel=jkernels.LUCY)
    w = kernels.kernel_w(kernels.LUCY, 3)
    w0 = float(w(torch.tensor(0.0), cut))
    # L 1.2: the images at 1.2 are out of reach; L 0.8: the six face
    # images at 0.8 < 0.9 add, the diagonals (1.13) do not
    for L, expect in ((1.2, w0), (0.8, w0 + 6 * float(w(torch.tensor(0.8),
                                                          cut)))):
        st = JState.from_arrays(np.array([[0.1, L / 2, L / 2]]), [1],
                                rmass=[1.0], rho=[1.0], capacity=128)
        box = JBox.create([0, 0, 0], [L, L, L])
        be, tst, data, tabs, tbox = _port(st, box, jtables, 3, skin=0.0,
                                          cap=16)
        rho = be.rho_summation(tst, tabs, spec, tbox, data)
        got = float(rho[tst.type > 0][0])
        assert got == pytest.approx(expect, rel=1e-4)
        geom = jgrid.make_geometry(box, cut, 3, skin=0.0, cap=16)
        jbe = JCellGrid(geom)
        jst, jdata = jbe.init_aux(st, box)
        want = jbe.rho_summation(jst, jtables, jspec, box, aux=jdata)
        assert got == pytest.approx(
            float(np.asarray(want)[np.asarray(jst.type) > 0][0]), rel=1e-5)


def test_cellgrid_dynamics_match_dense():
    """40 steps of dynamics (Tait, rhosum every 4, conduction) on the cell
    grid and on the port's dense rung: thermo and positions agree."""
    st, box, tables = stable_lattice_system(dim=2)
    spec = PhysicsSpec(dim=2, kernel=kernels.QUINTIC_SPLINE, tait=True,
                       rhosum_every=4, heatconduction=True)
    be, s2, data, tabs, tbox = _port(st, box, tables, 2, skin=0.15)
    s1 = state_from_numpy(host(st))
    n = int((s1.type > 0).sum())
    dt = 2e-4
    r_dense = Runner(spec, tbox, DenseBackend(tbox))
    s1, aux1 = DenseBackend(tbox).init_aux(s1, tbox)
    s1 = r_dense.setup(s1, tabs, 0, aux1)
    s1, _ = r_dense.run(s1, tabs, dt, 40, aux1, every=40)
    r_grid = Runner(spec, tbox, be)
    s2 = r_grid.setup(s2, tabs, 0, data)
    s2, data = r_grid.run(s2, tabs, dt, 40, data, every=40)
    assert r_grid.ok_steps == 40 and int(data.overflow.sum()) == 0
    t1, t2 = thermo_scalars(s1), thermo_scalars(s2)
    for k in ("ke", "ie", "rho_avg"):
        assert t2[k] == pytest.approx(t1[k], rel=5e-4), k
    x1 = tbox.wrap(torch.as_tensor(_by_tag(s1.x, s1)[:n]))
    x2 = tbox.wrap(torch.as_tensor(_by_tag(s2.x, s2)[:n]))
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), atol=5e-4)


def _seven_type_sims(ntypes):
    """A 2D periodic block of ``ntypes`` particle types (the types cycle
    over a jittered lattice) in both packages, on their cell grids."""
    rng = np.random.default_rng(4)
    ax = np.arange(24) * 0.1
    pts = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    pts = (pts + rng.uniform(-0.01, 0.01, pts.shape)).astype(np.float32)
    types = (np.arange(len(pts)) % ntypes + 1).astype(np.int32)
    v = rng.normal(0, 0.05, (len(pts), 3)).astype(np.float32)
    v[:, 2] = 0
    out = []
    for sim in (JSimulation(dim=2, screen=False),
                Simulation(dim=2, screen=False, device="cpu")):
        sim.create_box([0, 0, -0.05], [2.4, 2.4, 0.05],
                       periodic=(True, True, False), ntypes=ntypes)
        sim.add_particles(pts, types, v=v, rho=1.0, e=1.0, cv=1.0,
                          rmass=0.01)
        for i in range(1, ntypes + 1):
            for j in range(i, ntypes + 1):
                sim.tables.set_taitwater(i, j, rho0=1.0, c0=5.0,
                                         viscosity=0.3, h=0.3)
                sim.tables.set_rhosum(i, j, h=0.3)
        sim.pair_rhosum(3)
        sim.pair_taitwater()
        sim.neighbor_skin = 0.1
        sim.dt = 2e-4
        sim.thermo(0)
        out.append(sim)
    return out


@pytest.mark.parametrize("ntypes,backend", [(2, "cellgrid"), (7, "strip")])
def test_simulation_on_cell_grid_matches_jax(ntypes, backend):
    """``Simulation`` on the cell grid: named, and a run of seven types
    (more than the kernels take), which takes the cell grid on any ladder.
    20 steps in both packages: the same tags, positions to 5e-4 (minimum
    image), rho rtol 1e-4, v atol 5e-4."""
    ref, sim = _seven_type_sims(ntypes)
    ref.backend_name = "cellgrid"
    sim.backend_name = backend
    ref.run(20)
    sim.run(20)
    assert isinstance(sim._runner.backend, CellGridBackend)
    assert sim.natoms == ref.natoms
    np.testing.assert_array_equal(sim.get("tag"), ref.get("tag"))
    d = sim.get("x") - ref.get("x")
    d[:, :2] -= 2.4 * np.round(d[:, :2] / 2.4)
    np.testing.assert_allclose(d, 0.0, atol=5e-4)
    np.testing.assert_allclose(sim.get("rho"), ref.get("rho"), rtol=1e-4)
    np.testing.assert_allclose(sim.get("v"), ref.get("v"), atol=5e-4)
