"""The port's fix phase_change interface query (``StripBackend.
vapor_neighbor`` over the plain version of the vapor sweep) against the
JAX package's dense O(N^2) query
(``tpusph.ops.phase_change._vapor_neighbor_dense``), on jittered two-phase
lattices: periodic (seam ghosts present) and with a non-periodic column
axis (z), in 3D and 2D.

Bars: the vapour-neighbour count equal; nearest and nearest-owned rsq to
1e-6 relative plus 2 * cut * ulp(L) absolute; the nearest owned vapour the
same particle by tag. The absolute term is the image shift's rounding:
the dense query forms dx = x_i - x_j and then subtracts L, the strip
x_i - (x_j + L), and the two differ by up to ulp(L) in dx (1.6e-6 of rsq
measured for pairs across the box edge at L = 6). A case on an exact
lattice, where rsq ties are common, pins the tie rule: the nearest is the
lexicographic minimum of (rsq, neighbour offset kk, slot)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.ops.phase_change import _vapor_neighbor_dense
from tpusph.state import Box as JBox

from tpusph_torch.ops import strip_pair
from tpusph_torch.ops.band_pair import pack_fields
from tpusph_torch.ops.rows import OCGX, OCGY, ORHO, RSLOT, RTYPE
from tpusph_torch.state import Box

from test_pallas import lattice_system
from test_torch_strip_sweeps import host, port_layout

VTYPE = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _query(dim, periodic_z, seed, nside, jitter=True):
    st, box, tables = lattice_system(dim, nside=nside, seed=seed)
    if not jitter:
        ax = [np.arange(nside) * 0.5] * dim
        pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
        x = np.array(st.x)
        x[:len(pts), :dim] = pts
        st = dataclasses.replace(st, x=jnp.asarray(x))
    per = list(box.periodic)
    per[2 if dim == 3 else 1] = periodic_z
    box = JBox.create(np.asarray(box.lo), np.asarray(box.hi), tuple(per))
    cut = float(tables.max_cut())
    sb, tst, aux, _ = port_layout(st, box, tables, dim)
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    got = sb.vapor_neighbor(tst, tbox, VTYPE, cut, aux)
    ref = _vapor_neighbor_dense(st, box, VTYPE, cut)
    return st, sb, tst, aux, cut, got, ref


@pytest.mark.parametrize("dim,periodic_z,seed", [
    (3, True, 5), (3, False, 6), (2, True, 7), (2, False, 8)])
def test_vapor_neighbor_matches_dense(dim, periodic_z, seed):
    st, sb, tst, aux, cut, got, ref = _query(dim, periodic_z, seed,
                                             nside=12 if dim == 3 else 32)
    count, nearest, rsq, near_o, rsq_o = (t.numpy() for t in got)
    rcount, _, rrsq, rnear_o, rrsq_o = (np.asarray(a) for a in ref)
    d = host(st)
    rtag = d["tag"]
    alive_ref = d["type"] > 0
    own = (tst.type > 0).numpy() & tst.owned.numpy()
    tag = tst.tag.numpy()
    # port rows in JAX row order, by tag
    pos = np.argsort(tag[own])
    rows = np.nonzero(own)[0][pos]
    ref_rows = np.nonzero(alive_ref)[0][np.argsort(rtag[alive_ref])]
    np.testing.assert_array_equal(tag[rows], rtag[ref_rows])

    np.testing.assert_array_equal(count[rows], rcount[ref_rows])
    has = rcount[ref_rows] > 0
    assert has.sum() > 0.5 * len(rows)
    atol = 2 * cut * float(np.spacing(np.float32(sb.geom.lengths[0])))
    np.testing.assert_allclose(rsq[rows][has], rrsq[ref_rows][has],
                               rtol=1e-6, atol=atol)
    assert np.isinf(rsq[rows][~has]).all()
    np.testing.assert_allclose(rsq_o[rows][has], rrsq_o[ref_rows][has],
                               rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(tag[near_o[rows][has]],
                                  rtag[rnear_o[ref_rows][has]])
    assert tst.owned.numpy()[near_o[rows][has]].all()
    if periodic_z:
        # seam ghosts took part: some nearest vapour is a ghost copy
        assert (~tst.owned.numpy()[nearest[rows][has]]).any()


def test_vapor_tie_rule_on_exact_lattice():
    """On an exact lattice many vapour neighbours sit at the same rsq. The
    plain sweep's nearest must be the lexicographic minimum of (rsq, kk,
    slot) over its window pairs, found here by a numpy sort."""
    st, sb, tst, aux, cut, got, ref = _query(3, True, 9, nside=12,
                                             jitter=False)
    geom = sb.geom
    fld = pack_fields(tst)
    n = geom.n_slots
    slot = torch.arange(n, dtype=torch.float32)
    fld[RSLOT] = torch.where(tst.owned, slot, -slot - 1.0)
    out = strip_pair.plain_vapor_sweep(fld, sb.win, aux.delta, geom, VTYPE,
                                       cut)
    pi, pj, psx, psy, kk = strip_pair._window_pairs(
        fld, sb.win, aux.delta, geom, 0, geom.ncols,
        strip_pair._vapor_cut2(cut))
    pi, pj, psx, psy, kk = (t.numpy() for t in (pi, pj, psx, psy, kk))
    f = fld.numpy()
    keep = (f[RTYPE, pj] == VTYPE) & (f[RTYPE, pi] > 0.5)
    pi, pj, psx, psy, kk = (a[keep] for a in (pi, pj, psx, psy, kk))
    dx0 = f[0, pi] - (f[0, pj] + psx)
    dx1 = f[1, pi] - (f[1, pj] + psy)
    dx2 = f[2, pi] - f[2, pj]
    rsq = (dx0 * dx0 + dx1 * dx1) + dx2 * dx2
    enc = f[RSLOT, pj]
    sl = np.where(enc >= 0, enc, -enc - 1.0)
    order = np.lexsort((sl, kk, rsq, pi))
    first = np.ones(len(order), bool)
    first[1:] = pi[order][1:] != pi[order][:-1]
    win = order[first]
    np.testing.assert_array_equal(out[ORHO].numpy()[pi[win]] > 0, True)
    np.testing.assert_array_equal(out[OCGX].numpy()[pi[win]], sl[win])
    np.testing.assert_array_equal(out[OCGY].numpy()[pi[win]], rsq[win])
    # the offset index decides: (rsq, slot) alone picks other slots
    order2 = np.lexsort((sl, rsq, pi))
    assert (sl[order2[first]] != sl[win]).sum() > 10
    # ties did occur: rows with two or more candidates at the minimum rsq
    mins = np.full(n, np.inf, np.float32)
    np.minimum.at(mins, pi, rsq)
    at_min = np.bincount(pi[rsq == mins[pi]], minlength=n)
    assert (at_min >= 2).sum() > 100
    # and the count still matches the dense query by tag
    count = got[0].numpy()
    own = (tst.type > 0).numpy() & tst.owned.numpy()
    d = host(st)
    alive = d["type"] > 0
    a = count[own][np.argsort(tst.tag.numpy()[own])]
    b = np.asarray(ref[0])[alive][np.argsort(d["tag"][alive])]
    np.testing.assert_array_equal(a, b)


def test_vapor_wrapper_checks_inputs():
    """The wrapper takes the plain version on CPU tensors (no launch
    counted) and raises on a bad dtype, shape, contiguity or device, a
    device with no kernel, and a cut beyond the windows' reach."""
    st, box, tables = lattice_system(3, nside=12, seed=7)
    sb, tst, aux, _ = port_layout(st, box, tables, 3)
    fld = pack_fields(tst)
    kern = strip_pair.vapor_sweep
    cut = float(tables.max_cut())
    args = dict(fld=fld, win=sb.win, delta=aux.delta, geom=sb.geom,
                vtype=VTYPE, cut=cut)
    bad = {
        "fld dtype": dict(fld=fld.double()),
        "fld shape": dict(fld=fld[:, :-128]),
        "fld contiguity": dict(fld=fld.T.contiguous().T),
        "delta dtype": dict(delta=aux.delta.long()),
        "fld device": dict(fld=fld.to("meta")),
        "no kernel": dict(fld=fld.to("meta"), delta=aux.delta.to("meta"),
                          win=strip_pair.StripWindows(
                              sb.win.perm.to("meta"),
                              sb.win.shift.to("meta"))),
        "cut": dict(cut=sb.geom.margin_dist + 0.1),
    }
    n0 = kern.launches
    for what, change in bad.items():
        with pytest.raises(ValueError):
            kern(**{**args, **change})
            pytest.fail(what)
    out = kern(**args)
    assert out.shape == (8, sb.geom.n_slots) and kern.launches == n0
