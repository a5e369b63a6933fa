"""The torch port's band layout against the JAX package's, which is numpy
and XLA (not Pallas) and cheap on the CPU: ``choose_band_geometry`` field
for field, and ``build_slots`` EXACTLY on the same seeded state (the slot of
every tag, every state array with the sentinel fills of dead slots, and
the sub-cell ids, starts, counts, ranks, overflow and build count)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpusph.ops import band_pair as jbp
from tpusph.state import Box as JBox
from tpusph.state import ParticleState as JState

from tpusph_torch.ops import band_pair as tbp
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system
from test_torch_strip_layout import host

AUX_FIELDS = ("cell_id", "starts", "counts", "rank", "x_ref", "overflow",
              "nbuilds")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_box(box):
    return Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)


def alive_x(st):
    return np.asarray(st.x)[np.asarray(st.type) > 0]


def systems():
    """(name, JAX state, box, cutoff, dim): a 3D periodic box, a 3D box
    whose column axis (z) is not periodic, and a 2D periodic box."""
    out = []
    st, box, tables = lattice_system(3, nside=12, seed=5)
    out.append(("3d_periodic", st, box, tables.max_cut(), 3))
    st, box, tables = lattice_system(3, nside=12, seed=6)
    box = JBox.create(np.asarray(box.lo), np.asarray(box.hi),
                      (True, True, False))
    out.append(("3d_open_column", st, box, tables.max_cut(), 3))
    st, box, tables = lattice_system(2, nside=24, seed=7)
    out.append(("2d_periodic", st, box, tables.max_cut(), 2))
    return out


SYSTEMS = {name: rest for name, *rest in systems()}


def both_builds(st, box, gj, nbuilds=None):
    """(JAX state, aux), (port state, aux) of build_slots on geometry gj.
    The JAX build is jitted: op by op it compiles every op separately."""
    jb = jbp.BandBackend(gj, box, ntypes=2, interpret=True)
    sj, dj = jax.jit(lambda s: jbp.build_slots(s, gj, box))(jb.resize(st))
    gt = tbp.BandGeometry(*gj)
    tb = tbp.BandBackend(gt, ntypes=2)
    stt, dt = tbp.build_slots(tb.resize(state_from_numpy(host(st))), gt,
                              port_box(box))
    return (sj, dj), (stt, dt)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_geometry_and_build_slots_equal(name):
    st, box, cutoff, dim = SYSTEMS[name]
    x = alive_x(st)
    gj = jbp.choose_band_geometry(box, cutoff, dim, 0.2, x=x)
    gt = tbp.choose_band_geometry(port_box(box), cutoff, dim, 0.2, x=x)
    assert gj is not None and gt is not None
    assert tuple(gt) == tuple(gj)
    assert gt.col_periodic == (name != "3d_open_column")
    (sj, dj), (stt, dt) = both_builds(st, box, gj)
    assert int(dt.overflow.sum()) == 0
    ref = host(sj)
    got = {f.name: getattr(stt, f.name).numpy()
           for f in dataclasses.fields(stt)}
    for field, a in ref.items():
        np.testing.assert_array_equal(got[field], a, err_msg=field)
    for field in AUX_FIELDS:
        np.testing.assert_array_equal(getattr(dt, field).numpy(),
                                      np.asarray(getattr(dj, field)),
                                      err_msg=field)
    # every alive tag has the same slot, and dead slots hold the sentinel
    # fills (far position, unit rho/cv/rmass)
    alive = got["type"] > 0
    assert alive.sum() == len(x)
    dead = ~alive
    np.testing.assert_array_equal(got["x"][dead], tbp.DEAD_X)
    for field in ("rho", "cv", "rmass"):
        np.testing.assert_array_equal(got[field][dead], 1.0)


def test_geometry_none_cases():
    """No positions, no particles, cutoff + skin <= 0, and a periodic
    column axis shorter than two cell sides (every window would wrap onto
    itself): no geometry, in both packages."""
    st, box, cutoff, dim = SYSTEMS["3d_periodic"]
    x = alive_x(st)
    short = JBox.create([0, 0, 0], [6.0, 6.0, 1.5 * (cutoff + 0.2)],
                        (True,) * 3)
    for jbox, cut, skin, xs in ((box, cutoff, 0.2, None),
                                (box, cutoff, 0.2, x[:0]),
                                (box, 0.0, 0.0, x),
                                (short, cutoff, 0.2, x)):
        assert jbp.choose_band_geometry(jbox, cut, 3, skin, x=xs) is None
        assert tbp.choose_band_geometry(port_box(jbox), cut, 3, skin,
                                        x=xs) is None


def test_band_overflow_counts_and_drops():
    """tests/test_band.py's case: a slot capacity of 8 COUNTS the overflow
    and drops the rows beyond it; kept + overflow = alive, as the JAX
    package's build on the same state."""
    st, box, tables = lattice_system(3, nside=8, seed=3)
    gj = jbp.choose_band_geometry(box, tables.max_cut(), 3, 0.2,
                                  x=alive_x(st))
    tight = gj._replace(c=8)
    (sj, dj), (stt, dt) = both_builds(st, box, tight)
    n_alive = int((np.asarray(st.type) > 0).sum())
    assert int(dt.overflow[0]) > 0
    kept = int(stt.alive.sum())
    assert kept + int(dt.overflow[0]) == n_alive
    assert int(dt.overflow[0]) == int(dj.overflow[0])
    np.testing.assert_array_equal(stt.tag.numpy(), np.asarray(sj.tag))


def test_rebuild_keeps_slots_and_counts_builds():
    """BandBackend.prepare: no rebuild while every particle moved less
    than skin/2, a rebuild (nbuilds + 1, slots re-sorted as the JAX
    package's) once one moved further, and every ``rebuild_every`` steps."""
    st, box, cutoff, dim = SYSTEMS["3d_periodic"]
    gj = jbp.choose_band_geometry(box, cutoff, dim, 0.2, x=alive_x(st))
    gt = tbp.BandGeometry(*gj)
    tbox = port_box(box)
    bb = tbp.BandBackend(gt, ntypes=2)
    s0, aux = bb.init_aux(state_from_numpy(host(st)), tbox)

    def shifted(state, dx):
        # every alive particle moves dx along x (skin/2 = 0.1)
        kick = torch.tensor([dx, 0.0, 0.0])
        return dataclasses.replace(state, x=torch.where(
            state.alive[:, None], state.x + kick, state.x))

    calm = shifted(s0, 0.09)
    s1, aux1, rebuilt = bb.prepare(calm, aux, 1, tbox)
    assert not rebuilt and aux1 is aux
    moved = shifted(s0, 0.11)
    s2, aux2, rebuilt = bb.prepare(moved, aux, 1, tbox)
    assert rebuilt and int(aux2.nbuilds[0]) == 2
    # the JAX package's build of the same slot-ordered, moved state
    moved_j = JState(**{f.name: getattr(moved, f.name).numpy()
                        for f in dataclasses.fields(moved)})
    sj, dj = jax.jit(lambda s: jbp.build_slots(s, gj, box))(moved_j)
    for f in dataclasses.fields(s2):
        np.testing.assert_array_equal(getattr(s2, f.name).numpy(),
                                      np.asarray(getattr(sj, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(aux2.counts.numpy(), np.asarray(dj.counts))
    every = tbp.BandBackend(gt, ntypes=2, rebuild_every=4)
    assert every.prepare(calm, aux, 8, tbox)[2]
    assert not every.prepare(calm, aux, 9, tbox)[2]
