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
nothing overflows. A CUDA tensor never takes a plain version: every
wrapper call moves its launch counter.

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
from tpusph_torch.ops import band_pair, mxu_compact, pallas_pair, strip_pair
from tpusph_torch.ops.band_pair import pack_fields
from tpusph_torch.ops.rows import (
    OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RCGZ, RM, RRHO, RSLOT,
    RTYPE)
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
            uniform=False, hfac=2.2, shape=None):
    """A jittered (or exact) two-type lattice with random v, rho, e (the
    JAX tests' lattice_system, built here with numpy alone); ``uniform``
    makes every pair table uniform over the two types with one cutoff.
    Cutoffs are ``hfac`` spacings; ``shape`` (sites per axis) and a tuple
    ``periodic`` (per axis) override the cube of ``nside``."""
    rng = np.random.default_rng(seed)
    shape = shape or (nside,) * dim
    ax = [np.arange(m) * dx for m in shape]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape) * jitter
    if dim == 2:
        pts[:, 2] = 0.0
    n = len(pts)
    v = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    if dim == 2:
        v[:, 2] = 0.0
    st = state_from_arrays(
        pts.astype(np.float32), rng.integers(1, 3, n), np.full(n, 0.1), v=v,
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


@pytest.mark.parametrize("dim,periodic,jitter", [
    (3, True, True), (3, True, False), (3, False, True), (3, False, False),
    (2, True, False), (2, False, True),
])
def test_vapor_kernel_matches_plain_exactly(device, dim, periodic, jitter):
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic,
                              seed=dim + 11, device=device, jitter=jitter)
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
    kern = strip_pair.vapor_sweep
    n0 = kern.launches
    out_k = kern(fld, backend.win, aux.delta, geom, 2, cut)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    out_p = strip_pair.plain_vapor_sweep(fld, backend.win, aux.delta, geom,
                                         2, cut)
    alive = st.alive
    assert bool((out_p[ORHO][alive] > 0).any())
    for r in (ORHO, OCGX, OCGY, OFX, OFY):
        assert torch.equal(out_k[r][alive], out_p[r][alive]), r


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


def compact_inputs(name, dim, periodic, seed, device):
    """The strip layout of the lattice and the force sweep's field matrix,
    packed as the force stage packs it (rho and cg patched), with P
    measured over the alive rows: (backend, state, aux, fld, tabs, spec,
    P, cut)."""
    st, box, tables = lattice(dim, 12 if dim == 3 else 40, periodic, seed,
                              device, uniform=name == "bench_folded")
    x = st.x[st.alive].cpu().numpy()
    geom = strip_pair.choose_strip_geometry(box, tables.max_cut(), dim, 0.2,
                                            x=x)
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


def run_compact(backend, aux, fld, tabs, spec, P, cut):
    """The compacted kernel (one launch counted) and its plain version."""
    kern = mxu_compact.compact_force
    n0 = kern.launches
    out_k = kern(fld, tabs, backend.win, aux.delta, backend.geom, spec, P,
                 cut)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    out_p = mxu_compact.plain_compact_force(fld, tabs, backend.win,
                                            aux.delta, backend.geom, spec,
                                            P, cut)
    return out_k, out_p


COMPACT_ROWS = (OFX, OFY, OFZ, ODRHO, ODE)


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
