"""The port's cell grid (``tpusph_torch.grid``) and its vapor query
(``tpusph_torch.ops.cellgrid.CellGridBackend.vapor_neighbor``) against the
JAX package's (``tpusph.grid``, ``tpusph.ops.cellgrid``), on jittered and
exact two-type lattices, 2D and 3D, periodic and not.

Bars: all exact. The geometry field for field, the neighbour tables, the
sorted order (by tag), cell ids, counts, starts, ranks and the overflow
count; the measured cell cap; the vapor query's count, nearest row, rsq
and nearest owned row and rsq on every row. On an exact lattice many
vapour neighbours share one rsq, so the first-minimum tie rule decides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph import grid as jgrid
from tpusph.api import Simulation as JSimulation
from tpusph.ops.cellgrid import CellGridBackend as JCellGrid
from tpusph.state import Box as JBox

from tpusph_torch import grid
from tpusph_torch.api import Simulation
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system
from test_torch_strip_sweeps import host

VTYPE = 2
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
