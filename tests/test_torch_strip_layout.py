"""The torch port's strip layout against the JAX package's, which is XLA
(not Pallas) and cheap on the CPU: the geometry chooser field for field,
and build_strips, refresh_seam and the mixed-phase flags EXACTLY on the
same seeded state (slot order by tag, counts, seam copy map, window
retarget tables, overflow and the coverage shortfalls)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpusph.ops import strip_pair as jsp
from tpusph.ops.band_pair import _state_fields
from tpusph.params import PairTables as JTables
from tpusph.state import Box as JBox
from tpusph.state import ParticleState as JState

from tpusph_torch.ops import strip_pair as tsp
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system

GRID_FIELDS = ("counts", "overflow", "delta", "seam_src", "seam_dest",
               "seam_shift", "margin_short", "margin_need")


def host(tree) -> dict:
    d = jax.device_get(tree)
    return {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d)}


def both_layouts(st, box, cutoff, dim, skin):
    """(JAX geometry, state, aux), (port geometry, state, aux, backend)
    from one JAX state. The JAX rebuild is jitted: op-by-op it compiles
    every op separately, several times slower on the CPU."""
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    gj = jsp.choose_strip_geometry(box, cutoff, dim, skin, x=x)
    gt = tsp.choose_strip_geometry(tbox, cutoff, dim, skin, x=x)
    assert gj is not None and gt is not None
    jb = jsp.StripBackend(gj, box, ntypes=2, interpret=True)
    sj, dj = jax.jit(lambda s: jsp.build_strips(s, gj, box))(jb.resize(st))
    sbt = tsp.StripBackend(gt, ntypes=2)
    stt, dt = sbt.init_aux(state_from_numpy(host(st)), tbox)
    return (gj, sj, dj, jb), (gt, stt, dt, sbt)


def slab_system():
    """Phases split into z-slabs: the mixed-phase flag takes all three of
    its values here (tests/test_strip.py's ST-skip system)."""
    rng = np.random.default_rng(3)
    dx, nxy, nz = 0.5, 8, 48
    ax, az = np.arange(nxy) * dx, np.arange(nz) * dx
    pts = np.stack(np.meshgrid(ax, ax, az, indexing="ij"), -1).reshape(-1, 3)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape)
    n = len(pts)
    lz = nz * dx
    types = np.where(pts[:, 2] < lz / 2.0, 1, 2).astype(np.int32)
    st = JState.from_arrays(
        pts.astype(np.float32), types, rmass=np.full(n, 0.1),
        v=rng.normal(0, 0.05, (n, 3)).astype(np.float32),
        rho=rng.uniform(0.9, 1.2, n).astype(np.float32),
        e=rng.uniform(0.5, 1.5, n).astype(np.float32),
        capacity=((n + 127) // 128) * 128)
    box = JBox.create([0, 0, 0], [nxy * dx, nxy * dx, lz], (True,) * 3)
    return st, box, 2.2 * dx


@pytest.fixture(scope="module")
def slab():
    st, box, cut = slab_system()
    return (st, box) + both_layouts(st, box, cut, 3, 0.2)


@pytest.fixture(scope="module")
def lattice_np():
    """A random-type lattice in a box periodic along no axis."""
    st, box, tables = lattice_system(3, nside=12, periodic=False, seed=8)
    return (st, box) + both_layouts(st, box, tables.max_cut(), 3, 0.2)


@pytest.mark.parametrize("case", ["slab", "lattice_np"])
def test_geometry_and_build_strips_equal(case, request):
    _, _, (gj, sj, dj, _), (gt, stt, dt, _) = request.getfixturevalue(case)
    assert tuple(gt) == tuple(gj)
    ref = host(sj)
    got = {f.name: getattr(stt, f.name).numpy()
           for f in dataclasses.fields(stt)}
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    for name in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      np.asarray(getattr(dj, name)),
                                      err_msg=name)


def test_mixed_flags_equal(slab):
    _, _, (gj, sj, dj, jb), (gt, stt, dt, sbt) = slab
    mix = dt.mix.numpy()
    assert set(np.unique(mix).tolist()) == {0.0, 0.5, 1.0}
    np.testing.assert_array_equal(
        mix, np.asarray(jb._mixed_flags(_state_fields(sj), dj)))


def test_refresh_seam_equal(slab):
    _, box, (gj, sj, dj, jb), (gt, stt, dt, sbt) = slab
    assert dt.seam_src.numel() > 0
    # move every row (sources and stale ghost copies alike), then re-copy
    # the seam bands from their sources
    rng = np.random.default_rng(11)
    n = gt.n_slots
    kick = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    de = rng.normal(0, 0.01, n).astype(np.float32)
    sj2 = dataclasses.replace(sj, x=sj.x + kick, vest=sj.vest + kick,
                              rho=sj.rho + de, e=sj.e - de)
    stt2 = dataclasses.replace(
        stt, x=stt.x + torch.from_numpy(kick),
        vest=stt.vest + torch.from_numpy(kick),
        rho=stt.rho + torch.from_numpy(de), e=stt.e - torch.from_numpy(de))
    ref = jb.refresh_seam(sj2, dj)
    got = sbt.refresh_seam(stt2, dt)
    for name in ("x", "vest", "rho", "e"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_window_violation_counted_with_shortfall():
    """Squeezed margins: both packages count the same coverage violations
    and the same shortfall in rows."""
    st, box, tables = lattice_system(3, nside=12, seed=3)
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    gj = jsp.choose_strip_geometry(box, tables.max_cut(), 3, 0.2, x=x)
    squeezed = gj._replace(mlo=1, mhi=1)
    jb = jsp.StripBackend(squeezed, box, ntypes=2, interpret=True)
    _, dj = jax.jit(lambda s: jsp.build_strips(s, squeezed, box))(
        jb.resize(st))
    tgeom = tsp.StripGeometry(*squeezed)
    tb = tsp.StripBackend(tgeom, ntypes=2)
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    _, dt = tsp.build_strips(tb.resize(state_from_numpy(host(st))), tgeom,
                             tbox)
    assert int(dt.overflow.sum()) > 0
    for name in ("overflow", "margin_short", "margin_need"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      np.asarray(getattr(dj, name)),
                                      err_msg=name)


def test_tables_carry_over():
    jt = JTables.zeros(2)
    jt.set_taitwater(1, 2, rho0=1.0, c0=10.0, viscosity=0.3, h=3.0)
    jt.set_surfacetension(1, 2, sigma=0.05, h=3.0)
    from tpusph_torch.params import PairTables, tables_from_numpy
    tt = PairTables.zeros(2)
    tt.set_taitwater(1, 2, rho0=1.0, c0=10.0, viscosity=0.3, h=3.0)
    tt.set_surfacetension(1, 2, sigma=0.05, h=3.0)
    carried = tables_from_numpy(host(jt))
    for f in dataclasses.fields(tt):
        np.testing.assert_array_equal(getattr(tt, f.name),
                                      getattr(carried, f.name),
                                      err_msg=f.name)
