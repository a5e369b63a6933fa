"""The torch port's compacted force sweep (tpusph_torch/ops/mxu_compact.py)
against the JAX package, on the CPU, without the interpret-mode Pallas
kernel (too slow here): ``measure_union_cap`` equals the reference's
exactly; the plain compacted sweep, fed as the force stage feeds the force
sweep, matches the dense O(N^2) oracle and the port's plain strip force
sweep on the same field matrix at tests/test_strip.py's bars (f and de
rtol 2e-4 / atol 5e-4, drho 2e-4 / 1e-4: the same float32 sums in another
order); with P below the candidate union, the per-tile overflow count and
the sums equal an independent numpy construction of "the first P
survivors in (offset, row) order"; and the wrapper takes the plain
version on CPU tensors and rejects bad inputs, as does the one-pass check
kernel's, which no path launches.

The CUDA kernel sums the kept survivors through a warp box filter: a warp
tests each staged row against the box of its alive rows (the cutoff plus
a float32 margin), then each lane the box's survivors exactly.
``compact_pass_counts`` is the host copy of that filter: on a 3D
periodic, a 2D and an open-edged layout, at the measured P and at a P
below every tile's survivors, every live pair of a kept row survives its
warp's box (with the box's radius cut by 3% some do not), the pair queue's
body passes never exceed the one-pass kernel's lockstep passes, and the
live pairs equal the numpy construction's. The kernel is held to its
check kernel bit for bit on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from tpusph.forces import compute_forces
from tpusph.ops import dense
from tpusph.ops import mxu_compact as jmc
from tpusph.ops import strip_pair as jsp
from tpusph.params import PhysicsSpec as JSpec

from tpusph_torch.ops import all_kernels, mxu_compact, strip_pair, tile_physics
from tpusph_torch.ops.band_pair import pack_fields
from tpusph_torch.ops.mxu_compact import (
    OCNT, compact_pass_counts, measure_union_cap,
)
from tpusph_torch.ops.rows import (
    ODE, ODRHO, OFX, OFY, OFZ, RTYPE, RX, RY, RZ,
)
from tpusph_torch.params import PhysicsSpec
from tpusph_torch.state import Box

from test_mxu_compact import _system
from test_pallas import lattice_system
from test_torch_strip_sweeps import SPECS, TOLS, by_tag, host, port_layout

FORCE_ROWS = {"fx": OFX, "fy": OFY, "fz": OFZ, "drho": ODRHO, "de": ODE}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _union_system(kind):
    """(state, box, cut, dim, skin) of one measure_union_cap case."""
    if kind == "16^3":
        st, box, tables, _ = _system()
        return st, box, tables.max_cut(), 3, 0.5
    if kind == "2d":
        st, box, tables = lattice_system(2, nside=24, seed=5)
        return st, box, tables.max_cut(), 2, 0.2
    # every axis open: the plane axes take no wrap, the column no seam
    st, box, tables = lattice_system(3, nside=12, periodic=False, seed=6)
    return st, box, tables.max_cut(), 3, 0.2


@pytest.mark.parametrize("kind", ["16^3", "2d", "open"])
@pytest.mark.parametrize("headroom", [1.0, 1.3])
def test_union_cap_equals_reference(kind, headroom):
    st, box, cut, dim, skin = _union_system(kind)
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    gt = strip_pair.choose_strip_geometry(tbox, cut, dim, skin, x=x)
    gj = jsp.choose_strip_geometry(box, cut, dim, skin, x=x)
    P = measure_union_cap(x, gt, tbox, cut, headroom=headroom)
    assert P == jmc.measure_union_cap(x, gj, box, cut, headroom=headroom)
    assert P % 128 == 0 and P >= 128
    if kind == "16^3":
        assert P < gt.nnbr * (-(-gt.w // 128) * 128), (P, gt.w)


def compact_layout(name, seed=43):
    """The JAX lattice system, its dense-oracle force stage, and the port's
    strip layout with the force sweep's field matrix packed as the force
    stage packs it (rho and cg patched)."""
    st, box, tables = lattice_system(3, nside=12, periodic=True, seed=seed)
    spec_kw = SPECS[name]
    ref = host(compute_forces(st, tables, JSpec(dim=3, **spec_kw), box,
                              dense, istep=0))
    sb, tst, aux, ttab = port_layout(st, box, tables, 3)
    spec = PhysicsSpec(dim=3, **spec_kw)
    tabs = ttab.stacked("cpu")
    fld, _ = sb.force_fields(tst, tabs, spec, aux, 0)
    return ref, sb, tst, aux, tabs, spec, fld, ttab.max_cut(), box


@pytest.mark.parametrize("name", ["bench", "morris"])
def test_plain_compact_force_matches_dense_and_strip(name):
    ref, sb, tst, aux, tabs, spec, fld, cut, box = compact_layout(name)
    geom = sb.geom
    P = measure_union_cap(tst.x[tst.alive].numpy(), geom, box, cut)
    out = mxu_compact.plain_compact_force(fld, tabs, sb.win, aux.delta, geom,
                                          spec, P, cut)
    assert float(out[OCNT].abs().max()) == 0.0  # no overflow at P
    assert float(out[5:7].abs().max()) == 0.0   # no virial, no rho row
    got = {"tag": tst.tag.numpy(), "type": tst.type.numpy(),
           "owned": tst.owned.numpy(), "f": out[OFX:OFZ + 1].T.numpy(),
           "drho": out[ODRHO].numpy(), "de": out[ODE].numpy()}
    np.testing.assert_array_equal(by_tag(got, "tag")[0],
                                  by_tag(ref, "tag")[0])
    for field in ("f", "drho", "de"):
        (a,) = by_tag(ref, field)
        (b,) = by_tag(got, field)
        rtol, atol = TOLS[field]
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{name} {field} vs dense")
    strip = strip_pair.plain_sweep("force", fld, tabs, sb.win, aux.delta,
                                   geom, spec)
    alive = tst.alive
    for field, row in FORCE_ROWS.items():
        rtol, atol = TOLS["f" if row in (OFX, OFY, OFZ) else field]
        np.testing.assert_allclose(out[row][alive].numpy(),
                                   strip[row][alive].numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{name} {field}")


def first_p_survivors(fld, win, delta, geom, P, cut, cutmax2):
    """Numpy, tile by tile: the tile's alive-row bounding box, the window
    rows that are alive and within cut of it in (offset, row) order, the
    first P of them, and the pairs (alive i, kept j) with 1e-12 < rsq <
    cutmax2. Returns (OCNT per slot, pair i, pair j, pair sx, pair sy)."""
    f = fld.numpy()
    perm, shift, dl = win.perm.numpy(), win.shift.numpy(), delta.numpy()
    cap, ts, n = geom.col_cap, geom.ts, geom.n_slots
    cut2 = np.float32(cut * cut)
    ocnt = np.zeros(n, np.float32)
    pairs = []
    for c in range(geom.ncols):
        for t in range(geom.ntiles):
            b, tt = divmod(t, geom.t_blk)
            islot = c * cap + t * ts + np.arange(ts)
            islot = islot[f[RTYPE, islot] > 0.5]
            if len(islot) == 0:
                continue
            lo = f[RX:RZ + 1, islot].min(1)
            hi = f[RX:RZ + 1, islot].max(1)
            kept = []
            for kk in range(geom.nnbr):
                if perm[c, kk] < 0:
                    continue
                bb = min(max(b + dl[c, kk, b], 0), geom.nblocks - 1)
                tp = bb * geom.t_blk + tt
                rows = np.arange(max(tp * ts - geom.ch * geom.mlo, 0),
                                 min(tp * ts + ts + geom.ch * geom.mhi, cap))
                j = perm[c, kk] * cap + rows
                xj = np.stack([f[RX, j] + shift[c, kk, 0],
                               f[RY, j] + shift[c, kk, 1], f[RZ, j]])
                gap = np.maximum(np.maximum(lo[:, None] - xj,
                                            xj - hi[:, None]), np.float32(0))
                d2 = (gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]
                ok = (f[RTYPE, j] > 0.5) & (d2 < cut2)
                kept += [(jj, *shift[c, kk]) for jj in j[ok]]
            ocnt[c * cap + t * ts:c * cap + (t + 1) * ts] = max(
                len(kept) - P, 0)
            kj = np.array(kept[:P])
            j, sx, sy = kj[:, 0].astype(np.int64), kj[:, 1], kj[:, 2]
            sx, sy = sx.astype(np.float32), sy.astype(np.float32)
            dx0 = f[RX, islot][:, None] - (f[RX, j] + sx)[None]
            dx1 = f[RY, islot][:, None] - (f[RY, j] + sy)[None]
            dx2 = f[RZ, islot][:, None] - f[RZ, j][None]
            rsq = dx0 * dx0 + dx1 * dx1 + dx2 * dx2
            ii, jj = np.nonzero((rsq > 1e-12) & (rsq < cutmax2))
            pairs.append((islot[ii], j[jj], sx[jj], sy[jj]))
    pi, pj, psx, psy = (np.concatenate(a) for a in zip(*pairs))
    return ocnt, pi, pj, psx, psy


def test_overflow_keeps_first_p_survivors():
    """At P = 128, below every tile's candidate union, the sweep keeps the
    first P survivors of each tile in (offset, row) order: OCNT equals the
    independent count exactly and the sums over the kept pairs, formed by
    tile_physics, agree with the plain version (the same pairs; only the
    summation order may differ)."""
    _, sb, tst, aux, tabs, spec, fld, cut, box = compact_layout("bench")
    geom, P = sb.geom, 128
    out = mxu_compact.plain_compact_force(fld, tabs, sb.win, aux.delta, geom,
                                          spec, P, cut)
    ocnt, pi, pj, psx, psy = first_p_survivors(
        fld, sb.win, aux.delta, geom, P, cut, tabs.cutmax2["force"])
    assert ocnt.max() > 0, "P does not cut the union"
    np.testing.assert_array_equal(out[OCNT].numpy(), ocnt)
    pi, pj, psx, psy = (torch.as_tensor(a) for a in (pi, pj, psx, psy))
    fi = {r: fld[r, pi] for r in range(fld.shape[0])}
    fj = {r: fld[r, pj] for r in range(fld.shape[0])}
    h = tile_physics.hoist_i(fi, tabs.tab1, spec, "force")
    dx = (fi[RX] - (fj[RX] + psx), fi[RY] - (fj[RY] + psy), fi[RZ] - fj[RZ])
    rsq = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    lk = tile_physics.Lookups(tabs.tab2, tabs.tab1, spec, fi[RTYPE].long(),
                              fj[RTYPE].long())
    parts = tile_physics.tile_part_sums(fi, fj, h, dx, rsq, lk, spec,
                                        "force")
    for (field, row), p in zip(FORCE_ROWS.items(), parts):
        want = torch.zeros(geom.n_slots).index_add_(0, pi, p)
        np.testing.assert_allclose(out[row].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    # fewer pairs than at the full union: the cap dropped live pairs
    full = mxu_compact.plain_compact_force(
        fld, tabs, sb.win, aux.delta, geom, spec,
        measure_union_cap(tst.x[tst.alive].numpy(), geom, box, cut), cut)
    assert not torch.allclose(full[OFX], out[OFX])


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; it checks dtype, shape, contiguity, device and P first."""
    _, sb, tst, aux, tabs, spec, fld, cut, _ = compact_layout("morris",
                                                              seed=7)
    kern = mxu_compact.compact_force
    n0 = kern.launches
    args = dict(fld=fld, tabs=tabs, win=sb.win, delta=aux.delta,
                geom=sb.geom, spec=spec, P=1024, cut=cut)
    out = kern(**args)
    assert kern.launches == n0
    assert torch.equal(out, mxu_compact.plain_compact_force(**args))
    bad = {
        "fld dtype": dict(fld=fld.double()),
        "fld shape": dict(fld=fld[:, :-128]),
        "fld contiguity": dict(fld=fld.T.contiguous().T),
        "delta dtype": dict(delta=aux.delta.long()),
        "shift shape": dict(win=sb.win._replace(shift=sb.win.shift[:, :3])),
        "tab2 dtype": dict(tabs=tabs._replace(tab2=tabs.tab2.double())),
        "fld device": dict(fld=fld.to("meta")),
        "negative P": dict(P=-1),
    }
    for what, change in bad.items():
        with pytest.raises(ValueError):
            kern(**{**args, **change})
            pytest.fail(what)
    assert kern.launches == n0


def counts_layout(dim, periodic, seed):
    """The port's strip layout of a JAX lattice system and its field matrix
    (positions and types are all the filter reads), with the tables and P
    measured over the alive rows: (backend, state, aux, tabs, fld, cut,
    P)."""
    st, box, tables = lattice_system(dim, nside=12 if dim == 3 else 24,
                                     periodic=periodic, seed=seed)
    sb, tst, aux, ttab = port_layout(st, box, tables, dim)
    cut = ttab.max_cut()
    P = measure_union_cap(tst.x[tst.alive].numpy(), sb.geom, box, cut)
    return (sb, tst, aux, ttab.stacked("cpu"), pack_fields(tst, aux.mix),
            cut, P)


@pytest.mark.parametrize("dim,periodic", [(3, True), (2, True), (3, False)])
@pytest.mark.parametrize("cap", ["measured", "overflow"])
def test_compact_filter_keeps_every_live_pair(dim, periodic, cap):
    """The kernel's warp box filter (``compact_pass_counts``) keeps every
    live pair of a kept row, at the measured P and at P = 128, below the
    tiles' survivors (the kept rows a prefix of a chunk); the queue's body
    passes are at most the lockstep kernel's, those at most the warps' box
    survivors; and the live pairs are exactly the numpy construction's
    pairs of the first P survivors."""
    sb, _, aux, tabs, fld, cut, P = counts_layout(dim, periodic, dim + 50)
    geom, cutmax2 = sb.geom, tabs.cutmax2["force"]
    if cap == "overflow":
        P = 128
    c = compact_pass_counts(fld, sb.win, aux.delta, geom, P, cut, cutmax2)
    assert c["live_outside_box"] == 0, c
    assert 0 < c["queue_passes"] <= c["lockstep_passes"], c
    assert c["lockstep_passes"] <= c["box_survivors"], c
    assert c["box_survivors"] <= -(-geom.ts // 32) * c["kept"], c
    assert c["tiles"] <= c["chunks"], c
    if cap == "overflow":
        assert c["kept"] <= 128 * c["tiles"] < c["survivors"], c
    else:
        assert c["kept"] == c["survivors"], c
    _, pi, *_ = first_p_survivors(fld, sb.win, aux.delta, geom, P, cut,
                                  cutmax2)
    assert c["live_pairs"] == len(pi), c


def test_compact_filter_check_fails_with_radius_cut():
    """The same check with the warp box's radius cut by 3%: live pairs
    fall outside their warp's box, so the check above can fail."""
    sb, _, aux, tabs, fld, cut, P = counts_layout(3, True, 53)
    c = compact_pass_counts(fld, sb.win, aux.delta, sb.geom, P, cut,
                            tabs.cutmax2["force"], radius_scale=0.97)
    assert c["live_outside_box"] > 0, c


def test_check_kernel_wrapper_takes_plain_version_on_cpu():
    """The one-pass check kernel's wrapper (``compact_force_scan``) is in
    the launch-count registry and, on CPU tensors, runs the plain version
    and counts no launch."""
    sb, _, aux, tabs, fld, cut, P = counts_layout(3, True, 53)
    scan = mxu_compact.compact_force_scan
    assert mxu_compact.SCANS == {"force": scan}
    assert all_kernels()["compact_force_scan"] is scan
    n0 = scan.launches
    args = dict(fld=fld, tabs=tabs, win=sb.win, delta=aux.delta,
                geom=sb.geom, spec=PhysicsSpec(dim=3, **SPECS["morris"]),
                P=P, cut=cut)
    assert torch.equal(scan(**args), mxu_compact.plain_compact_force(**args))
    assert scan.launches == n0
