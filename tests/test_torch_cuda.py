"""The CUDA strip sweeps (tpusph_torch/csrc/strip_sweeps.cu), column
sweeps (tpusph_torch/csrc/column_sweeps.cu), band sweeps
(tpusph_torch/csrc/band_sweeps.cu) and the compacted force sweep
(tpusph_torch/csrc/compact_force.cu) against their plain PyTorch versions,
on the card, for every physics branch the kernels carry: Tait /
Morris / ideal gas / LJ, continuity, heat conduction with and without
T_sat pinning, CSF, the virial, rhosum in both forms, scalar-folded tables
with a shared cutoff, all four smoothing kernels, 2D and 3D, periodic and
not. The strip vapor sweep (the fix phase_change interface query) is held
to its plain version exactly: count, both slots and both rsq, on exact
lattices (rsq ties) and jittered ones, with seam-ghost rows where the
column axis is periodic. The compacted force sweep keeps exactly the plain
version's survivors (its overflow count equal on every slot, also with P
below the candidate union) and matches the strip force kernel where
nothing overflows. The column and band force kernels (the queued sweep
of tpusph_torch/csrc/cell_sweep.cuh) equal their one-pass check kernels
bit for bit on every alive row, on layouts that reach their control flow:
a cap not a multiple of 32, one dense cell among sparse ones (chunks that
exit, windows staged in two rounds), 2D, a periodic column of one cell,
open edges, band c 80 and c 128, warps of one alive row (on the column
grid cells of one alive row: its alive rows are each cell's prefix). The
column and band rho and colour-gradient kernels (the same kernel's short
bodies) equal their one-pass check kernels bit for bit on every alive
row on the same cases, 2D, a vapour sphere and a lattice of one colour
(the colour gate). A CUDA tensor never takes a plain version: every wrapper call
moves its launch counter.

Needs an NVIDIA GPU and nvcc (marker ``cuda``); elsewhere every test skips.
tests/conftest.py imports jax, which this file does not need, so on a
machine without jax run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance, per output row: the largest difference over the alive slots
within 2e-5 (rho) or 2e-4 (cgrad, force) of the row's largest magnitude —
the same float32 sums in another order.
"""

import numpy as np
import pytest
import torch

from tpusph_torch import grid, kernels
from tpusph_torch.ops import (band_pair, cell_filter, mxu_compact,
                              pallas_pair, strip_pair)
from tpusph_torch.ops.band_pair import pack_fields
from tpusph_torch.ops.rows import (
    OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RCGZ, RM, RMIX, RRHO,
    RSLOT, RTYPE, RX, RY, RZ, TABLES_1D)
from tpusph_torch.params import PairTables, PhysicsSpec
from tpusph_torch.state import Box, state_from_arrays

pytestmark = pytest.mark.cuda

RTOL = {"rho": 2e-5, "cgrad": 2e-4, "force": 2e-4}
ROWS = {"rho": (ORHO,), "cgrad": (OCGX, OCGY, ODE),
        "force": (OFX, OFY, OFZ, ODRHO, ODE, ORHO)}

SPECS = {
    "bench": dict(kernel=kernels.LUCY, rhosum_every=1, rhosum_nd=True,
                  tait=True, heatconduction=True, surface_tension=True),
    "morris_virial": dict(kernel=kernels.LUCY, morris=True, virial=True),
    "idealgas_cubic": dict(kernel=kernels.CUBIC_SPLINE, ideal_gas=True,
                           rhosum_every=1),
    "lj_quintic": dict(kernel=kernels.QUINTIC_SPLINE, lj=True),
    "heatpc_wendland_st": dict(kernel=kernels.WENDLAND_C2, tait=True,
                               heat_phasechange=True, surface_tension=True,
                               rhosum_every=1, virial=True),
    # uniform tables folded to scalars, one shared active cutoff
    "bench_folded": dict(kernel=kernels.LUCY, rhosum_every=1, rhosum_nd=True,
                         tait=True, heatconduction=True,
                         surface_tension=True, shared_wfd=True,
                         scalar_tables=("c0", "cut", "cut_heat", "cut_rho",
                                        "cut_tension", "gas_gamma",
                                        "heat_D", "rho0", "sigma",
                                        "tait_b", "visc")),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def lattice(dim, nside, periodic, seed, device, dx=0.5, jitter=True,
            uniform=False, hfac=2.2, shape=None, dense_cell=0,
            types="random"):
    """A jittered (or exact) two-type lattice with random v, rho, e (the
    JAX tests' lattice_system, built here with numpy alone); ``uniform``
    makes every pair table uniform over the two types with one cutoff.
    Cutoffs are ``hfac`` spacings; ``shape`` (sites per axis) and a tuple
    ``periodic`` (per axis) override the cube of ``nside``; ``dense_cell``
    more particles are packed into a cube of side 1.2 about (2.25, 2.25,
    2.25), inside one cell of the 12^3 lattice's grid. ``types``: "random"
    (1 or 2 at random), "sphere" (type 2 within L/5 of the box centre,
    the bench's vapour sphere, type 1 elsewhere), "one" (all type 1) or
    "vapour" (all type 2)."""
    rng = np.random.default_rng(seed)
    shape = shape or (nside,) * dim
    ax = [np.arange(m) * dx for m in shape]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape) * jitter
    if dense_cell:
        pts = np.concatenate([pts, 2.25 + rng.uniform(-0.6, 0.6,
                                                      (dense_cell, 3))])
    if dim == 2:
        pts[:, 2] = 0.0
    n = len(pts)
    v = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    if dim == 2:
        v[:, 2] = 0.0
    typ = rng.integers(1, 3, n)
    if types == "sphere":
        side = np.asarray(shape) * dx
        typ = np.where(np.linalg.norm(pts[:, :dim] - side / 2, axis=1)
                       < side.min() / 5, 2, 1)
    elif types == "one":
        typ = np.ones(n, np.int64)
    elif types == "vapour":
        typ = np.full(n, 2, np.int64)
    st = state_from_arrays(
        pts.astype(np.float32), typ, np.full(n, 0.1), v=v,
        rho=rng.uniform(0.9, 1.2, n), e=rng.uniform(0.5, 1.5, n),
        capacity=((n + 127) // 128) * 128, device=device)
    L = [m * dx for m in shape] + [1.0]
    if not isinstance(periodic, tuple):
        periodic = (periodic, periodic, periodic and dim == 3)
    box = Box.create([0, 0, 0], L[:3], periodic, device=device)
    tables = PairTables.zeros(2)
    h = hfac * dx
    for i, j in ((1, 2), (1, 1), (2, 2)):
        tables.set_taitwater(i, j, rho0=1.0, c0=6.0, viscosity=0.4, h=h)
        tables.set_rhosum(i, j, h=h)
        tables.set_heatconduction(i, j, d=0.15, h=0.9 * h)
    tables.set_heatconduction(1, 2, d=0.15, h=0.9 * h, tsat=1.1)
    tables.set_surfacetension(1, 2, sigma=0.8, h=h)
    if uniform:
        for i, j in ((1, 2), (1, 1), (2, 2)):
            tables.set_heatconduction(i, j, d=0.15, h=h)
            tables.set_surfacetension(i, j, sigma=0.8, h=h)
    return st, box, tables


def check_rows(sweep, out_k, out_p, alive):
    """Every output row of the sweep within its tolerance of the plain
    version on the alive slots, and finite."""
    for r in ROWS[sweep]:
        a, b = out_k[r][alive], out_p[r][alive]
        assert torch.isfinite(a).all(), (sweep, r)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        assert err <= RTOL[sweep] * scale, (sweep, r, err, scale)


def strip_layout(st, box, tables, dim, device,
                 candidates=strip_pair.DEFAULT_TS_CH, t_blk=None):
    """(backend, state, aux) of the strip layout of a lattice, its tile rows
    and window chunks chosen from ``candidates`` (and ``t_blk`` tiles a
    block where given)."""
    x = st.x[st.alive].cpu().numpy()
    geom = strip_pair.choose_strip_geometry(box, tables.max_cut(), dim, 0.2,
                                            x=x, candidates=candidates)
    assert geom is not None
    if t_blk is not None:
        geom = geom._replace(t_blk=t_blk)
    backend = strip_pair.StripBackend(geom, ntypes=2, device=device)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    return backend, st, aux


def strip_sweeps_match_plain(backend, st, aux, fld, tabs, spec):
    """The three strip sweep kernels against their plain versions on the
    alive rows of ``fld``, each launch counted, fed as the force stage
    feeds them (rho patched before cgrad, cg before force)."""
    geom = backend.geom
    alive = fld[RTYPE] > 0.5
    for sweep in ("rho", "cgrad", "force"):
        kern = strip_pair.SWEEPS[sweep]
        n0 = kern.launches
        out_k = kern(fld, tabs, backend.win, aux.delta, geom, spec)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        out_p = strip_pair.plain_sweep(sweep, fld, tabs, backend.win,
                                       aux.delta, geom, spec)
        check_rows(sweep, out_k, out_p, alive)
        # feed the next sweep as the force stage does
        if sweep == "rho":
            total = out_p[ORHO] * st.rmass if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            cg = torch.stack([out_p[OCGX], out_p[OCGY], out_p[ODE]])
            fld[RCGX:RCGZ + 1] = torch.where(alive, cg, 0.0)


@pytest.mark.parametrize("name,dim,periodic", [
    ("bench", 3, True), ("bench", 3, False), ("morris_virial", 3, True),
    ("idealgas_cubic", 3, True), ("lj_quintic", 3, False),
    ("heatpc_wendland_st", 3, True), ("bench", 2, True),
    ("heatpc_wendland_st", 2, False),
])
def test_kernels_match_plain_versions(device, name, dim, periodic):
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic,
                              seed=dim + 7, device=device)
    backend, st, aux = strip_layout(st, box, tables, dim, device)
    spec = PhysicsSpec(dim=dim, **SPECS[name])
    strip_sweeps_match_plain(backend, st, aux, pack_fields(st, aux.mix),
                             tables.stacked(device), spec)


def most_pairs_in_one_offset(fld, backend, aux, cut2):
    """The most live pairs one warp of 32 i rows has in one neighbour
    column: what the strip force kernel's pair queue takes in one offset."""
    geom = backend.geom
    pi, _, _, _, kk = strip_pair._window_pairs(fld, backend.win, aux.delta,
                                               geom, 0, geom.ncols, cut2)
    warp = strip_pair._warp_ids(pi, geom)
    return int(torch.bincount(warp * geom.nnbr + kk).max())


@pytest.mark.parametrize("name,dim,shape,periodic,hfac", [
    # 3D: about 330 neighbours a row; 2D: about 110
    ("bench", 3, (20, 20, 12), (True, True, False), 4.5),
    ("heatpc_wendland_st", 3, (20, 20, 12), (True, True, False), 4.5),
    ("bench", 2, (40, 40), True, 6.0),
])
def test_strip_queue_flushes_on_dense_lattices(device, name, dim, shape,
                                               periodic, hfac):
    """Lattices so dense that the force kernel's 128-entry warp pair queue
    fills and runs many times inside one neighbour column: every sweep
    still matches its plain version."""
    st, box, tables = lattice(dim, 0, periodic, seed=dim + 31,
                              device=device, hfac=hfac, shape=shape)
    backend, st, aux = strip_layout(st, box, tables, dim, device)
    spec = PhysicsSpec(dim=dim, **SPECS[name])
    tabs = tables.stacked(device)
    fld = pack_fields(st, aux.mix)
    most = most_pairs_in_one_offset(fld, backend, aux, tabs.cutmax2["force"])
    assert most > 4 * 128, most
    strip_sweeps_match_plain(backend, st, aux, fld, tabs, spec)


@pytest.mark.parametrize("ts_ch,t_blk", [((48, 16), None), ((16, 8), None),
                                         ((48, 16), 1)])
def test_strip_filter_warps_across_tiles(device, ts_ch, t_blk):
    """Tiles of 48 or 16 rows: a warp's 32 lanes lie in two tiles with two
    windows, and a block of one 48-row tile has a second warp of 16 lanes;
    every sweep matches its plain version."""
    st, box, tables = lattice(3, 12, True, seed=43, device=device)
    backend, st, aux = strip_layout(st, box, tables, 3, device,
                                    candidates=(ts_ch,), t_blk=t_blk)
    assert backend.geom.ts == ts_ch[0]
    spec = PhysicsSpec(dim=3, **SPECS["bench"])
    strip_sweeps_match_plain(backend, st, aux, pack_fields(st, aux.mix),
                             tables.stacked(device), spec)


@pytest.mark.parametrize("name", ["bench", "morris_virial"])
def test_strip_filter_warp_with_one_alive_row(device, name):
    """Warps of one alive row among 31 dead ones (every fourth warp keeps
    one lane, the others keep all): the warp's box is that row's point
    dilated by the cutoff, and every sweep matches its plain version."""
    st, box, tables = lattice(3, 12, True, seed=41, device=device)
    backend, st, aux = strip_layout(st, box, tables, 3, device)
    geom = backend.geom
    fld = pack_fields(st, aux.mix)
    slots = torch.arange(geom.n_slots, device=device)
    wid = strip_pair._warp_ids(slots, geom)
    alive = fld[RTYPE] > 0.5
    n_alive = torch.zeros(int(wid.max()) + 1, dtype=torch.long,
                          device=device).index_add_(0, wid, alive.long())
    thin = (wid % 4 == 0) & (n_alive[wid] == 32)
    kill = thin & alive & (slots % 32 != wid % 32)
    for r in range(fld.shape[0]):
        fld[r, kill] = band_pair.dead_lane_fill(r)
    alive = fld[RTYPE] > 0.5
    kept = torch.zeros_like(n_alive).index_add_(0, wid, alive.long())
    assert int(((kept == 1) & (n_alive == 32)).sum()) >= 4
    spec = PhysicsSpec(dim=3, **SPECS[name])
    strip_sweeps_match_plain(backend, st, aux, fld, tables.stacked(device),
                             spec)


def test_force_stage_on_card_matches_cpu(device):
    """One force stage of the bench spec through the wrappers: the kernels
    on the card against the plain versions on the CPU."""
    outs = {}
    for dev in (device, torch.device("cpu")):
        st, box, tables = lattice(3, 12, True, seed=3, device=dev)
        x = st.x[st.alive].cpu().numpy()
        geom = strip_pair.choose_strip_geometry(box, tables.max_cut(), 3,
                                                0.2, x=x)
        backend = strip_pair.StripBackend(geom, ntypes=2, device=dev)
        st, aux = backend.init_aux(st, box)
        spec = PhysicsSpec(dim=3, **SPECS["bench"])
        outs[dev.type] = backend.force_stage(st, tables.stacked(dev), spec,
                                             aux, istep=0)
    for field, rtol in (("rho", 2e-5), ("f", 2e-4), ("drho", 2e-4),
                        ("de", 2e-4)):
        a = getattr(outs["cpu"], field)
        b = getattr(outs["cuda"], field).cpu()
        err = float((a - b).abs().max())
        assert err <= rtol * float(a.abs().max()), (field, err)


def vapor_ties(fld, backend, aux, vtype, cut):
    """Rows with two or more vapour rows at their minimum rsq."""
    geom = backend.geom
    pi, pj, psx, psy, _ = strip_pair._window_pairs(
        fld, backend.win, aux.delta, geom, 0, geom.ncols,
        strip_pair._vapor_cut2(cut))
    keep = (fld[RTYPE][pj] == vtype) & (fld[RTYPE][pi] > 0.5)
    pi, pj, psx, psy = pi[keep], pj[keep], psx[keep], psy[keep]
    d = [fld[RX][pi] - (fld[RX][pj] + psx), fld[RY][pi] - (fld[RY][pj] + psy),
         fld[RZ][pi] - fld[RZ][pj]]
    rsq = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    mn = torch.full((geom.n_slots,), float("inf"), device=fld.device
                    ).scatter_reduce(0, pi, rsq, "amin")
    at = torch.bincount(pi[rsq == mn[pi]], minlength=geom.n_slots)
    return int((at > 1).sum())


@pytest.mark.parametrize("dim,periodic,jitter,types", [
    (3, True, True, "random"), (3, True, False, "random"),
    (3, False, True, "random"), (3, False, False, "random"),
    (2, True, False, "random"), (2, False, True, "random"),
    (3, True, True, "one"), (3, True, True, "vapour"),
    (3, True, False, "sphere"),
])
def test_vapor_kernel_matches_plain_exactly(device, dim, periodic, jitter,
                                            types):
    """The vapor kernel (the type gate, the block's and the warps' boxes)
    exactly equal to its plain version and to its one-pass check kernel
    on all five rows of every slot: exact lattices (ties at the minimum
    rsq) and jittered ones, seam ghosts where the column axis is
    periodic, no vapour row ("one": every block exits on the gate), every
    row vapour, and a vapour sphere on an exact lattice (blocks without
    vapour beside blocks with ties)."""
    st, box, tables = lattice(dim, 16 if types == "sphere" else
                              12 if dim == 3 else 40, periodic,
                              seed=dim + 11, device=device, jitter=jitter,
                              types=types)
    x = st.x[st.alive].cpu().numpy()
    geom = strip_pair.choose_strip_geometry(box, tables.max_cut(), dim, 0.2,
                                            x=x)
    backend = strip_pair.StripBackend(geom, ntypes=2, device=device)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    if periodic:
        assert bool((st.alive & ~st.owned).any()), "no seam ghosts"
    fld = pack_fields(st)
    slot = torch.arange(geom.n_slots, dtype=torch.float32, device=device)
    fld[RSLOT] = torch.where(st.owned, slot, -slot - 1.0)
    cut = tables.max_cut()
    kern, scan = strip_pair.vapor_sweep, strip_pair.SCANS["vapor"]
    n0, s0 = kern.launches, scan.launches
    out_k = kern(fld, backend.win, aux.delta, geom, 2, cut)
    out_s = scan(fld, backend.win, aux.delta, geom, 2, cut)
    torch.cuda.synchronize()
    assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
    out_p = strip_pair.plain_vapor_sweep(fld, backend.win, aux.delta, geom,
                                         2, cut)
    hit = bool((out_p[ORHO][st.alive] > 0).any())
    assert hit == (types != "one")
    for r in (ORHO, OCGX, OCGY, OFX, OFY):
        assert torch.equal(out_k[r], out_p[r]), r
        assert torch.equal(out_k[r], out_s[r]), r
    c = strip_pair.vapor_pass_counts(fld, backend.win, aux.delta, geom, 2,
                                     cut)
    assert c["live_outside_box"] == 0, c
    if types == "one":
        assert c["gate_exits"] == c["blocks"] > 0, c
    elif types == "sphere":
        assert 0 < c["gate_exits"] < c["blocks"], c
    if not jitter and types != "one":
        assert vapor_ties(fld, backend, aux, 2, cut) > 0


def strip_cgrad_case(case, device):
    """The strip layout of one card case of the colour-gradient kernel:
    (backend, state, aux, fld, tables). Dense lattices (3D ~330
    neighbours a row, 2D ~110), tiles of 48 or 16 rows (warps across two
    tiles), a block of one 48-row tile (a second warp of 16 lanes), warps
    of one alive row, a vapour sphere, one colour (the tiles flagged
    mixed: every block exits on the gate) and 2D."""
    dim, nside, periodic, kw, cand, t_blk = 3, 12, True, {}, None, None
    if case == "dense3d":
        nside, periodic = 0, (True, True, False)
        kw = dict(hfac=4.5, shape=(20, 20, 12))
    elif case == "dense2d":
        dim, nside, kw = 2, 0, dict(hfac=6.0, shape=(40, 40))
    elif case in ("tiles48", "warp16"):
        cand, t_blk = ((48, 16),), 1 if case == "warp16" else None
    elif case == "tiles16":
        cand = ((16, 8),)
    elif case == "sphere":
        nside, kw = 16, dict(types="sphere")
    elif case == "one":
        kw = dict(types="one")
    elif case == "2d":
        dim, nside = 2, 40
    st, box, tables = lattice(dim, nside, periodic, seed=dim + 71,
                              device=device, **kw)
    backend, st, aux = strip_layout(
        st, box, tables, dim, device,
        candidates=cand or strip_pair.DEFAULT_TS_CH, t_blk=t_blk)
    if cand:
        assert backend.geom.ts == cand[0][0]
    fld = pack_fields(st, aux.mix)
    if case == "one":
        fld[RMIX] = 1.0
    elif case == "one_alive":
        geom = backend.geom
        slots = torch.arange(geom.n_slots, device=device)
        wid = strip_pair._warp_ids(slots, geom)
        alive = fld[RTYPE] > 0.5
        n_alive = torch.zeros(int(wid.max()) + 1, dtype=torch.long,
                              device=device).index_add_(0, wid,
                                                        alive.long())
        thin = (wid % 4 == 0) & (n_alive[wid] == 32)
        kill = thin & alive & (slots % 32 != wid % 32)
        for r in range(fld.shape[0]):
            fld[r, kill] = band_pair.dead_lane_fill(r)
    return backend, st, aux, fld, tables


@pytest.mark.parametrize("case", ["dense3d", "dense2d", "tiles48",
                                  "tiles16", "warp16", "one_alive", "sphere",
                                  "one", "2d"])
def test_strip_cgrad_matches_one_pass_scan(device, case):
    """The strip colour-gradient kernel (strip_filter_kernel: the warp box
    filter, the colour gate of the block and of each warp, offsets without
    a candidate skipped) within its bar of the plain version and bit for
    bit equal to its one-pass check kernel on every alive row, +0.0 on
    every other; rho patched first, as the force stage does."""
    backend, st, aux, fld, tables = strip_cgrad_case(case, device)
    geom = backend.geom
    spec = PhysicsSpec(dim=geom.dim, **SPECS["bench"])
    tabs = tables.stacked(device)
    alive = fld[RTYPE] > 0.5
    rho = strip_pair.plain_sweep("rho", fld, tabs, backend.win, aux.delta,
                                 geom, spec)[ORHO]
    fld[RRHO] = torch.where(alive, rho * fld[RM], fld[RRHO])
    kern, scan = strip_pair.SWEEPS["cgrad"], strip_pair.SCANS["cgrad"]
    n0, s0 = kern.launches, scan.launches
    out_k = kern(fld, tabs, backend.win, aux.delta, geom, spec)
    out_s = scan(fld, tabs, backend.win, aux.delta, geom, spec)
    torch.cuda.synchronize()
    assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
    out_p = strip_pair.plain_sweep("cgrad", fld, tabs, backend.win,
                                   aux.delta, geom, spec)
    check_rows("cgrad", out_k, out_p, alive)
    rows = list(ROWS["cgrad"])
    bits_k = out_k[rows][:, alive].view(torch.int32)
    bits_s = out_s[rows][:, alive].view(torch.int32)
    differ = int((bits_k != bits_s).any(0).sum())
    assert differ == 0, differ
    if bool((~alive).any()):
        assert not bool((out_k[rows][:, ~alive].view(torch.int32) != 0)
                        .any())
    c = strip_pair.warp_pass_counts(fld, backend.win, aux.delta, geom,
                                    tabs.cutmax2["cgrad"],
                                    tabs.tab1[TABLES_1D.index("color")])
    assert c["live_outside_box"] == 0, c
    if case == "one":
        assert c["gate_exits"] == c["blocks"] > 0, c
    elif case in ("dense3d", "dense2d"):
        assert c["needed_pairs"] > 4 * 128, c


def column_layout(dim, periodic, seed, device, name="bench"):
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic, seed,
                              device, uniform=name == "bench_folded")
    geom = grid.make_geometry(box, tables.max_cut(), dim, skin=0.2)
    backend = pallas_pair.PallasBackend(geom, box, ntypes=2, device=device)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    return backend, st, aux, tables


@pytest.mark.parametrize("name,dim,periodic", [
    ("bench", 3, True), ("bench", 3, False), ("morris_virial", 3, True),
    ("idealgas_cubic", 3, False), ("lj_quintic", 3, True),
    ("heatpc_wendland_st", 3, True), ("bench_folded", 3, True),
    ("bench", 2, True), ("heatpc_wendland_st", 2, False),
])
def test_column_kernels_match_plain_versions(device, name, dim, periodic):
    backend, st, aux, tables = column_layout(dim, periodic, dim + 17, device,
                                             name)
    cg = backend.colgrid
    spec = PhysicsSpec(dim=dim, **SPECS[name])
    tabs = tables.stacked(device)
    fld, _, _ = pallas_pair.pack_dense(st, aux, cg)
    alive = fld[RTYPE] > 0.5
    for sweep in ("rho", "cgrad", "force"):
        kern = pallas_pair.KERNELS[sweep]
        n0 = kern.launches
        out_k = kern(fld, tabs, cg, spec)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        out_p = pallas_pair.plain_column_sweep(sweep, fld, tabs, cg, spec)
        check_rows(sweep, out_k, out_p, alive)
        # empty and dead slots are written as zeros
        assert float(out_k[:, ~alive].abs().max()) == 0.0
        # feed the next sweep as the force stage does
        if sweep == "rho":
            total = out_p[ORHO] * fld[RM] if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            fld[RCGX:RCGZ + 1] = out_p[[OCGX, OCGY, ODE]]


def test_column_force_stage_on_card_matches_cpu(device):
    """One PallasBackend.force_stage of the bench spec: the kernels on the
    card against the plain versions on the CPU, every launch counted."""
    outs = {}
    for dev in (device, torch.device("cpu")):
        backend, st, aux, tables = column_layout(3, True, 5, dev)
        spec = PhysicsSpec(dim=3, **SPECS["bench"])
        n0 = {k: w.launches for k, w in pallas_pair.KERNELS.items()}
        outs[dev.type] = backend.force_stage(st, tables.stacked(dev), spec,
                                             aux, istep=0)
        moved = {k: w.launches - n0[k]
                 for k, w in pallas_pair.KERNELS.items()}
        assert moved == {k: int(dev.type == "cuda") for k in moved}, moved
    for field, rtol in (("rho", 2e-5), ("f", 2e-4), ("drho", 2e-4),
                        ("de", 2e-4)):
        a = getattr(outs["cpu"], field)
        b = getattr(outs["cuda"], field).cpu()
        err = float((a - b).abs().max())
        assert err <= rtol * float(a.abs().max()), (field, err)


def band_layout(dim, periodic, seed, device, name="bench", col_open=False):
    """The lattice in the band layout; ``col_open`` makes the column axis
    (z) non-periodic while the plane axes stay periodic."""
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic, seed,
                              device, uniform=name == "bench_folded")
    if col_open:
        box = Box.create(box.lo.cpu().numpy(), box.hi.cpu().numpy(),
                         (True, True, False), device=device)
    x = st.x[st.alive].cpu().numpy()
    geom = band_pair.choose_band_geometry(box, tables.max_cut(), dim, 0.2,
                                          x=x)
    assert geom is not None
    backend = band_pair.BandBackend(geom, ntypes=2)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    return backend, st, aux, tables


@pytest.mark.parametrize("name,dim,periodic,col_open", [
    ("bench", 3, True, False), ("bench", 3, False, False),
    ("bench", 3, True, True), ("morris_virial", 3, True, False),
    ("idealgas_cubic", 3, False, False), ("lj_quintic", 3, True, True),
    ("heatpc_wendland_st", 3, True, False), ("bench_folded", 3, True, False),
    ("bench", 2, True, False), ("heatpc_wendland_st", 2, False, False),
])
def test_band_kernels_match_plain_versions(device, name, dim, periodic,
                                           col_open):
    backend, st, aux, tables = band_layout(dim, periodic, dim + 27, device,
                                           name, col_open)
    geom = backend.geom
    spec = PhysicsSpec(dim=dim, **SPECS[name])
    tabs = tables.stacked(device)
    fld = pack_fields(st)
    alive = st.alive
    for sweep in ("rho", "cgrad", "force"):
        kern = band_pair.KERNELS[sweep]
        n0 = kern.launches
        out_k = kern(fld, tabs, geom, spec)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        out_p = band_pair.plain_band_sweep(sweep, fld, tabs, geom, spec)
        check_rows(sweep, out_k, out_p, alive)
        # dead slots are written as zeros
        assert float(out_k[:, ~alive].abs().max()) == 0.0
        # feed the next sweep as the force stage does
        if sweep == "rho":
            total = out_p[ORHO] * st.rmass if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            cg = torch.stack([out_p[OCGX], out_p[OCGY], out_p[ODE]])
            fld[RCGX:RCGZ + 1] = torch.where(alive, cg, 0.0)
    if SPECS[name].get("surface_tension"):
        # no mixed-phase gate: the colour gradient is nonzero somewhere
        assert float(fld[RCGX:RCGZ + 1].abs().max()) > 0.0


def test_band_force_stage_on_card_matches_cpu(device):
    """One BandBackend.force_stage of the bench spec: the kernels on the
    card against the plain versions on the CPU, every launch counted."""
    outs = {}
    for dev in (device, torch.device("cpu")):
        backend, st, aux, tables = band_layout(3, True, 5, dev)
        spec = PhysicsSpec(dim=3, **SPECS["bench"])
        n0 = {k: w.launches for k, w in band_pair.KERNELS.items()}
        outs[dev.type] = backend.force_stage(st, tables.stacked(dev), spec,
                                             aux, istep=0)
        moved = {k: w.launches - n0[k]
                 for k, w in band_pair.KERNELS.items()}
        assert moved == {k: int(dev.type == "cuda") for k in moved}, moved
    for field, rtol in (("rho", 2e-5), ("f", 2e-4), ("drho", 2e-4),
                        ("de", 2e-4)):
        a = getattr(outs["cpu"], field)
        b = getattr(outs["cuda"], field).cpu()
        err = float((a - b).abs().max())
        assert err <= rtol * float(a.abs().max()), (field, err)


def feed_force(kernels, fld, tabs, layout, spec):
    """Patch rho and the colour gradient into ``fld`` from the layout's rho
    and cgrad kernels, as the force stage does."""
    alive = fld[RTYPE] > 0.5
    if spec.rhosum_every > 0:
        total = kernels["rho"](fld, tabs, layout, spec)[ORHO]
        if spec.rhosum_nd:
            total = total * fld[RM]
        fld[RRHO] = torch.where(alive, total, fld[RRHO])
    if spec.surface_tension:
        out = kernels["cgrad"](fld, tabs, layout, spec)
        fld[RCGX:RCGZ + 1] = torch.where(alive, out[[OCGX, OCGY, ODE]], 0.0)


def force_matches_plain_and_scan(kind, fld, tabs, layout, spec):
    """The layout's queued force kernel (``kind`` "column" or "band")
    against its plain version, within the bar, and against the one-pass
    check kernel, bit for bit on every alive row; each launch counted.
    Returns the counts of its phases (``cell_filter.cell_pass_counts``)."""
    mod = pallas_pair if kind == "column" else band_pair
    plain = (pallas_pair.plain_column_sweep if kind == "column"
             else band_pair.plain_band_sweep)
    kern = mod.KERNELS["force"]
    scan = (pallas_pair.column_force_scan if kind == "column"
            else band_pair.band_force_scan)
    feed_force(mod.KERNELS, fld, tabs, layout, spec)
    alive = fld[RTYPE] > 0.5
    n0, s0 = kern.launches, scan.launches
    out_k = kern(fld, tabs, layout, spec)
    out_s = scan(fld, tabs, layout, spec)
    torch.cuda.synchronize()
    assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
    check_rows("force", out_k, plain("force", fld, tabs, layout, spec),
               alive)
    rows = list(ROWS["force"])
    differ = int((out_k[rows][:, alive] != out_s[rows][:, alive]).any(0)
                 .sum())
    assert differ == 0, differ
    if bool((~alive).any()):
        assert float(out_k[:, ~alive].abs().max()) == 0.0
    counts = cell_filter.cell_pass_counts(fld, layout, tabs.cutmax2["force"])
    assert counts["live_outside_box"] == 0, counts
    return counts


def keep_one_alive(fld, first_slot, fill):
    """In every third block of 32 slots from ``first_slot`` (a slot index
    tensor of each block's first slot) that holds an alive row, kill all
    alive rows but the last (each dead slot's rows filled by ``fill(r)``):
    warps with one alive row, above dead ranks within the live reach.
    Returns the number of such warps."""
    alive = fld[RTYPE] > 0.5
    slots = first_slot[::3, None] + torch.arange(32, device=fld.device)
    a = alive[slots]
    last = torch.where(a, torch.arange(32, device=fld.device), -1).amax(1)
    kill = a & (torch.arange(32, device=fld.device) != last[:, None])
    dead = slots[kill]
    for r in range(fld.shape[0]):
        fld[r, dead] = fill(r)
    return int((last >= 0).sum())


def keep_first_alive(fld, cg):
    """In every third cell that holds an alive row, kill every rank but
    rank 0 (the dead slots zero, as pack_dense leaves empty ones): cells
    whose one warp holds one alive row, with the alive slots still each
    cell's prefix, as the column kernels need. Returns their number."""
    alive = (fld[RTYPE] > 0.5).reshape(-1, cg.cap)
    cells = alive[:, 0].nonzero()[::3, 0]
    slots = (cells[:, None] * cg.cap
             + torch.arange(1, cg.cap, device=fld.device)).reshape(-1)
    fld[:, slots] = 0.0
    return cells.numel()


def column_case(case, device):
    """The column layout of one card-test case: (fld, colgrid, tables);
    the types at random, but a 16^3 vapour sphere ("sphere") or one type
    ("one")."""
    dim, cap, shape, periodic, dense = 3, None, None, True, 0
    types = {"sphere": "sphere", "one": "one"}.get(case, "random")
    if case == "cap70":
        cap = 70                        # not a multiple of 32
    elif case == "dense_cell":
        cap, dense = 510, 480           # one cell of 507 rows
    elif case == "2d":
        dim = 2
    elif case == "ncz1":
        shape = (12, 12, 4)             # periodic z of 2.0: one cell
    elif case == "open":
        periodic = False
    nside = 40 if dim == 2 else 16 if case == "sphere" else 12
    st, box, tables = lattice(dim, nside, periodic, dim + 51, device,
                              shape=shape, dense_cell=dense, types=types)
    geom = grid.make_geometry(box, tables.max_cut(), dim, skin=0.2, cap=cap)
    backend = pallas_pair.PallasBackend(geom, box, ntypes=2, device=device)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    cg = backend.colgrid
    if case == "ncz1":
        assert cg.ncz == 1
    fld, _, _ = pallas_pair.pack_dense(st, aux, cg)
    return fld, cg, tables


@pytest.mark.parametrize("case,name", [
    ("cap70", "bench"), ("dense_cell", "bench"), ("dense_cell",
                                                   "morris_virial"),
    ("2d", "bench"), ("2d", "heatpc_wendland_st"), ("ncz1", "bench"),
    ("open", "morris_virial"), ("one_alive", "bench"),
])
def test_column_force_matches_one_pass_scan(device, case, name):
    """The column force kernel (the warp box filter and pair queue, blocks
    of up to 128 ranks) bit for bit equal to the one-pass check kernel on
    every alive row: a cap not a multiple of 32; one cell of 507 rows
    beside cells of ~27 (chunks that exit, windows staged in two rounds);
    2D; a periodic column of one cell (staged three times under three
    shifts); open edges; cells of one alive row (a cell's alive rows are
    the prefix of its ranks the kernel's reach search needs)."""
    fld, cg, tables = column_case(case, device)
    if case == "one_alive":
        assert keep_first_alive(fld, cg) >= 4
    dim = cg.dim
    counts = force_matches_plain_and_scan(
        "column", fld, tables.stacked(device), cg,
        PhysicsSpec(dim=dim, **SPECS[name]))
    if case == "dense_cell":
        assert counts["blocks_alive"] < counts["blocks"] // 3, counts
        assert counts["multi_round_windows"] > 0, counts


@pytest.mark.parametrize("case,name", [
    ("cap70", "bench"), ("dense_cell", "bench"),
    ("dense_cell", "idealgas_cubic"), ("2d", "bench"),
    ("2d", "heatpc_wendland_st"), ("ncz1", "bench"), ("open", "bench"),
    ("one_alive", "bench"), ("sphere", "bench"), ("one", "bench"),
])
def test_column_rho_cgrad_match_one_pass_scans(device, case, name):
    """The column rho and colour-gradient kernels (csrc/cell_sweep.cuh on
    the column grid: each staged cell's reach from its alive prefix, the
    box filter and, for the colour gradient, the colour gate's pass over
    the prefixes) within their bars of the plain versions and bit for bit
    equal to the one-pass check kernels on every alive row: a cap not a
    multiple of 32; one cell of 507 rows (chunks that exit, windows staged
    in two rounds); 2D; a periodic column of one cell (staged three times
    under three shifts); open edges; cells of one alive row; a vapour
    sphere (blocks near it sweep, the gate drops the rest) and one colour
    (every block exits on the gate). Rho is patched into the fields before
    the colour gradient, as the force stage does."""
    fld, cg, tables = column_case(case, device)
    if case == "one_alive":
        assert keep_first_alive(fld, cg) >= 4
    spec = PhysicsSpec(dim=cg.dim, **SPECS[name])
    tabs = tables.stacked(device)
    alive = fld[RTYPE] > 0.5
    counts = {}
    for sweep in ("rho", "cgrad"):
        kern, scan = pallas_pair.KERNELS[sweep], pallas_pair.SCANS[sweep]
        n0, s0 = kern.launches, scan.launches
        out_k = kern(fld, tabs, cg, spec)
        out_s = scan(fld, tabs, cg, spec)
        torch.cuda.synchronize()
        assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
        out_p = pallas_pair.plain_column_sweep(sweep, fld, tabs, cg, spec)
        check_rows(sweep, out_k, out_p, alive)
        rows = list(ROWS[sweep])
        bits_k = out_k[rows][:, alive].view(torch.int32)
        bits_s = out_s[rows][:, alive].view(torch.int32)
        differ = int((bits_k != bits_s).any(0).sum())
        assert differ == 0, (sweep, differ)
        assert float(out_k[:, ~alive].abs().max()) == 0.0
        c = counts[sweep] = cell_filter.cell_pass_counts(
            fld, cg, tabs.cutmax2[sweep], sweep,
            tabs.tab1[TABLES_1D.index("color")])
        assert c["live_outside_box"] == 0, c
        assert c["reach_reads"] < c["ballot_reads"], c
        if sweep == "rho":
            total = out_p[ORHO] * fld[RM] if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
    rho, cgrad = counts["rho"], counts["cgrad"]
    if case == "dense_cell":
        assert rho["blocks_alive"] < rho["blocks"] // 3, rho
        assert rho["multi_round_windows"] > 0, rho
    elif case == "one":
        assert cgrad["gate_exits"] == cgrad["blocks_alive"], cgrad
    elif case == "sphere":
        assert 0 < cgrad["needed_pairs"] < cgrad["live_pairs"], cgrad
        assert 0 < cgrad["gate_exits"] < cgrad["blocks_alive"], cgrad


def band_case(case, device):
    """The band layout of one card-test case: (fld, geometry, tables). The
    geometry is the chooser's split of a 16^3 lattice with cutoff 3
    spacings (cells of 4 x 4 sites) into sub-cells one cell tall (G 2, k
    1, ~64 particles a sub-cell) or half a cell (G 4, k 2, ~32), with the
    slots per sub-cell c set as the 1M bench's are (80 and 128); the
    types at random, but a vapour sphere ("sphere") or one type ("one")."""
    periodic = case != "open_c128"
    types = {"sphere": "sphere", "one": "one"}.get(case, "random")
    st, box, tables = lattice(3, 16, periodic, 61, device, hfac=3.0,
                              types=types)
    c, G, p = {"c80": (80, 2, 1), "c128": (128, 4, 2),
               "open_c128": (128, 4, 2), "one_alive": (80, 2, 1),
               "sphere": (128, 4, 2), "one": (80, 2, 1)}[case]
    side = tables.max_cut() + 0.2
    L = 8.0
    nsub = int(L * p // side)
    nsub -= nsub % G if periodic else 0
    k = max(int(np.ceil(side / (L / nsub) - 1e-9)), 1)
    geom = band_pair.BandGeometry(
        ncx=4, ncy=4, nsub=nsub, G=G, c=c, k=k, dim=3, periodic=box.periodic,
        lengths=(L, L, L), origin=(0.0, 0.0, 0.0), cell_xy=(2.0, 2.0),
        s_sub=L / nsub, skin=0.2)
    assert geom.gc <= band_pair.MAX_GC and G + 2 * k <= geom.nsub_pad
    backend = band_pair.BandBackend(geom, ntypes=2)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    return pack_fields(st), geom, tables


@pytest.mark.parametrize("case,name", [
    ("c80", "bench"), ("c80", "heatpc_wendland_st"), ("c128", "bench"),
    ("c128", "morris_virial"), ("open_c128", "bench"),
    ("one_alive", "morris_virial"),
])
def test_band_force_matches_one_pass_scan(device, case, name):
    """The band force kernel bit for bit equal to the one-pass check kernel
    on every alive row: c 80 (chunks of 128 slots across two sub-cells,
    warps with alive rows of both), c 128 (a chunk a sub-cell, its upper
    warps dead), open edges, warps of one alive row above dead ranks."""
    fld, geom, tables = band_case(case, device)
    if case == "c80":
        slot = torch.arange(geom.n_slots, device=device)
        alive = fld[RTYPE] > 0.5
        wid = slot // 32
        sub = slot // geom.c
        lo = torch.full((geom.n_slots // 32,), geom.n_slots, device=device
                        ).scatter_reduce(0, wid[alive], sub[alive], "amin")
        hi = torch.full_like(lo, -1).scatter_reduce(0, wid[alive],
                                                    sub[alive], "amax")
        assert int((hi > lo).sum()) > 0, "no warp across two sub-cells"
    if case == "one_alive":
        subs = torch.arange(geom.total_cells, device=device) * geom.c
        assert keep_one_alive(fld, subs, band_pair.dead_lane_fill) >= 4
    force_matches_plain_and_scan("band", fld, tables.stacked(device), geom,
                                 PhysicsSpec(dim=3, **SPECS[name]))


@pytest.mark.parametrize("case,name", [
    ("c80", "bench"), ("c80", "idealgas_cubic"), ("c128", "bench"),
    ("c128", "heatpc_wendland_st"), ("open_c128", "bench"),
    ("one_alive", "bench"), ("2d", "bench"), ("sphere", "bench"),
    ("one", "bench"),
])
def test_band_rho_cgrad_match_one_pass_scans(device, case, name):
    """The band rho and colour-gradient kernels (the box filter and, for
    the colour gradient, the colour gate of csrc/cell_sweep.cuh) within
    their bars of the plain versions and bit for bit equal to the one-pass
    check kernels on every alive row: c 80 (not a multiple of 32: warps
    across two sub-cells), c 128, open edges, warps of one alive row, 2D,
    a vapour sphere (blocks near it sweep, the gate drops the rest) and
    one colour (every block exits on the gate). Rho is patched into the
    fields before the colour gradient, as the force stage does."""
    if case == "2d":
        backend, st, aux, tables = band_layout(2, True, 61, device)
        fld, geom = pack_fields(st), backend.geom
    else:
        fld, geom, tables = band_case(case, device)
    if case == "one_alive":
        subs = torch.arange(geom.total_cells, device=device) * geom.c
        assert keep_one_alive(fld, subs, band_pair.dead_lane_fill) >= 4
    spec = PhysicsSpec(dim=geom.dim, **SPECS[name])
    tabs = tables.stacked(device)
    alive = fld[RTYPE] > 0.5
    for sweep in ("rho", "cgrad"):
        kern, scan = band_pair.KERNELS[sweep], band_pair.SCANS[sweep]
        n0, s0 = kern.launches, scan.launches
        out_k = kern(fld, tabs, geom, spec)
        out_s = scan(fld, tabs, geom, spec)
        torch.cuda.synchronize()
        assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
        out_p = band_pair.plain_band_sweep(sweep, fld, tabs, geom, spec)
        check_rows(sweep, out_k, out_p, alive)
        rows = list(ROWS[sweep])
        bits_k = out_k[rows][:, alive].view(torch.int32)
        bits_s = out_s[rows][:, alive].view(torch.int32)
        differ = int((bits_k != bits_s).any(0).sum())
        assert differ == 0, (sweep, differ)
        assert float(out_k[:, ~alive].abs().max()) == 0.0
        counts = cell_filter.cell_pass_counts(
            fld, geom, tabs.cutmax2[sweep], sweep,
            tabs.tab1[TABLES_1D.index("color")])
        assert counts["live_outside_box"] == 0, counts
        if sweep == "rho":
            total = out_p[ORHO] * fld[RM] if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
    if case == "one":
        assert counts["gate_exits"] == counts["blocks_alive"], counts
    elif case == "sphere":
        assert 0 < counts["needed_pairs"] < counts["live_pairs"], counts


def compact_inputs(name, dim, periodic, seed, device,
                   candidates=strip_pair.DEFAULT_TS_CH):
    """The strip layout of the lattice (tile rows and window chunks chosen
    from ``candidates``) and the force sweep's field matrix, packed as the
    force stage packs it (rho and cg patched), with P measured over the
    alive rows: (backend, state, aux, fld, tabs, spec, P, cut)."""
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic, seed,
                              device, uniform=name == "bench_folded")
    x = st.x[st.alive].cpu().numpy()
    geom = strip_pair.choose_strip_geometry(box, tables.max_cut(), dim, 0.2,
                                            x=x, candidates=candidates)
    backend = strip_pair.StripBackend(geom, ntypes=2, device=device)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    spec = PhysicsSpec(dim=dim, **SPECS[name])
    tabs = tables.stacked(device)
    fld, _ = backend.force_fields(st, tabs, spec, aux, 0)
    cut = tables.max_cut()
    P = mxu_compact.measure_union_cap(st.x[st.alive].cpu().numpy(), geom,
                                      box, cut)
    return backend, st, aux, fld, tabs, spec, P, cut


COMPACT_ROWS = (OFX, OFY, OFZ, ODRHO, ODE)


def run_compact(backend, aux, fld, tabs, spec, P, cut):
    """The compacted kernel and its one-pass check kernel (one launch
    counted each), the kernel bit for bit equal to the check kernel on
    rows 0-4 of every alive row and on the overflow row of every slot; and
    the plain version. Returns the kernel's and the plain outputs."""
    kern, scan = mxu_compact.compact_force, mxu_compact.compact_force_scan
    n0, s0 = kern.launches, scan.launches
    args = (fld, tabs, backend.win, aux.delta, backend.geom, spec, P, cut)
    out_k = kern(*args)
    out_s = scan(*args)
    torch.cuda.synchronize()
    assert (kern.launches, scan.launches) == (n0 + 1, s0 + 1)
    alive = fld[RTYPE] > 0.5
    rows = list(COMPACT_ROWS)
    differ = int((out_k[rows][:, alive].view(torch.int32)
                  != out_s[rows][:, alive].view(torch.int32)).any(0).sum())
    assert differ == 0, differ
    assert torch.equal(out_k[mxu_compact.OCNT], out_s[mxu_compact.OCNT])
    out_p = mxu_compact.plain_compact_force(fld, tabs, backend.win,
                                            aux.delta, backend.geom, spec,
                                            P, cut)
    return out_k, out_p


def check_compact(out_k, out_p, alive):
    """Rows OFX..ODE within the force tolerance of the plain version's row
    maximum on the alive slots, rows 5-6 zero everywhere, OCNT equal on
    every slot."""
    for r in COMPACT_ROWS:
        a, b = out_k[r][alive], out_p[r][alive]
        assert torch.isfinite(a).all(), r
        err = float((a - b).abs().max())
        assert err <= RTOL["force"] * float(b.abs().max()), (r, err)
    assert float(out_k[5:7].abs().max()) == 0.0
    assert torch.equal(out_k[mxu_compact.OCNT], out_p[mxu_compact.OCNT])


@pytest.mark.parametrize("name,dim,periodic", [
    ("bench", 3, True), ("bench", 3, False), ("morris_virial", 3, True),
    ("idealgas_cubic", 3, True), ("lj_quintic", 3, False),
    ("heatpc_wendland_st", 3, True), ("bench", 2, True),
    ("heatpc_wendland_st", 2, False),
])
def test_compact_kernel_matches_plain_and_strip(device, name, dim, periodic):
    """Every physics branch: the compacted kernel against its plain version
    and, with no overflow at the measured P, against the strip force
    kernel on the same field matrix."""
    backend, st, aux, fld, tabs, spec, P, cut = compact_inputs(
        name, dim, periodic, dim + 17, device)
    out_k, out_p = run_compact(backend, aux, fld, tabs, spec, P, cut)
    alive = st.alive
    check_compact(out_k, out_p, alive)
    assert float(out_k[mxu_compact.OCNT].max()) == 0.0
    strip = strip_pair.SWEEPS["force"](fld, tabs, backend.win, aux.delta,
                                       backend.geom, spec)
    for r in COMPACT_ROWS:
        err = float((out_k[r][alive] - strip[r][alive]).abs().max())
        assert err <= RTOL["force"] * float(strip[r][alive].abs().max()), \
            (r, err)


def test_compact_kernel_overflow_matches_plain(device):
    """At P = 128, below the candidate union: the kernel keeps the same
    first P survivors per tile as the plain version (OCNT equal on every
    slot, the sums within tolerance)."""
    backend, st, aux, fld, tabs, spec, _, cut = compact_inputs(
        "bench", 3, True, 21, device)
    out_k, out_p = run_compact(backend, aux, fld, tabs, spec, 128, cut)
    assert float(out_p[mxu_compact.OCNT].max()) > 0.0
    check_compact(out_k, out_p, st.alive)


def test_compact_kernel_always_launches(device):
    """A CUDA tensor launches the kernel whatever its inputs: with P = 0
    every survivor overflows (zero sums, OCNT the survivor count), and a
    pool with no alive row writes zeros."""
    backend, st, aux, fld, tabs, spec, _, cut = compact_inputs(
        "morris_virial", 3, True, 23, device)
    out_k, out_p = run_compact(backend, aux, fld, tabs, spec, 0, cut)
    check_compact(out_k, out_p, st.alive)
    assert float(out_k[:7].abs().max()) == 0.0
    assert float(out_k[mxu_compact.OCNT].max()) > 0.0
    dead = fld.clone()
    dead[RTYPE] = 0.0
    out_k, out_p = run_compact(backend, aux, dead, tabs, spec, 128, cut)
    assert float(out_k.abs().max()) == 0.0


def kill_rows(fld, slots):
    """Make the rows ``slots`` dead (each field row its dead-lane fill)."""
    for r in range(fld.shape[0]):
        fld[r, slots] = band_pair.dead_lane_fill(r)


@pytest.mark.parametrize("case", ["ts48", "ts16", "one_alive", "dead_tiles"])
def test_compact_kernel_matches_one_pass_scan(device, case):
    """The compacted kernel's control flow against its one-pass check
    kernel (bit for bit, ``run_compact``) and its plain version: tiles of
    48 rows (a second warp of 16 lanes) and of 16 (one warp of 16 lanes,
    the block's other lanes only compact); warps of one alive row (in every
    third warp: the warp's box is one point dilated by the cutoff); tiles
    with no alive row (every third: zeros) beside tiles whose second warp
    has none (it sums nothing)."""
    cand = {"ts48": ((48, 16),), "ts16": ((16, 8),)}.get(
        case, strip_pair.DEFAULT_TS_CH)
    backend, st, aux, fld, tabs, spec, P, cut = compact_inputs(
        "bench", 3, True, 47, device, candidates=cand)
    geom = backend.geom
    slots = torch.arange(geom.n_slots, device=device)
    alive = fld[RTYPE] > 0.5
    if case in ("ts48", "ts16"):
        assert geom.ts == cand[0][0]
    elif case == "one_alive":
        assert keep_one_alive(fld, slots[::32], band_pair.dead_lane_fill) > 4
    else:
        tile = slots // geom.ts
        kill_rows(fld, slots[alive & ((tile % 3 == 0) | (
            (tile % 3 == 1) & (slots % geom.ts >= 32)))])
        live = torch.zeros(geom.n_slots // geom.ts, dtype=torch.long,
                           device=device).index_add_(
            0, tile, (fld[RTYPE] > 0.5).long())
        assert int((live == 0).sum()) > 4 and int((live > 0).sum()) > 4
    out_k, out_p = run_compact(backend, aux, fld, tabs, spec, P, cut)
    check_compact(out_k, out_p, fld[RTYPE] > 0.5)
    assert float(out_k[mxu_compact.OCNT].max()) == 0.0
    if case == "dead_tiles":
        dead = (live == 0)[slots // geom.ts]
        assert float(out_k[:, dead].abs().max()) == 0.0
