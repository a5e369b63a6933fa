"""The band backend on torch — the counterpart of ``tpusph/ops/band_pair.py``
(see its module docstring for the layout's design): the slot-resident
sub-cell layout, the rho / colour-gradient / force sweeps over banded
j-windows as hand-written CUDA kernels (``csrc/band_sweeps.cu``) with their
plain PyTorch version, and ``BandBackend``, whose fused force stage the
strip backend inherits (``StripBackend(BandBackend)``, as in the
reference).

The layout: columns tile the plane (xy in 3D, x in 2D), each column is cut
into ``nsub_pad`` sub-cells along the column axis, and a particle's row IS
its slot, slot = sub-cell * c + rank, re-scattered only at a rebuild
(``build_slots``). A group of G sub-cells (G*c slots) is one i-block; its
j-window in each of the 9 (3D) / 3 (2D) neighbour columns is the group's
sub-cells plus k margin sub-cells on each side, (G + 2k) * c rows.

What the port keeps: ``choose_band_geometry`` is the reference's host
chooser as is, with its TPU cost terms (the 128-lane window pad in the
cost and the ``gc * w_pad > 512_000`` working-set reject) kept for parity,
so the geometry equals the reference's field for field; re-deriving those
terms for the card is later work. The sentinel-dead slots (far position,
unit rho/m/cv) are contract and kept.

What it drops: the reference re-packs an i-array and a materialized band
array (``pack_i``, ``pack_band``, ``band_row``, ``_update_rows``) because
Mosaic cannot slice lanes dynamically, and patches rows of both after each
sweep. The port's sweeps read their windows straight from the slot-major
(F_ROWS, n_slots) field matrix, so a patch is a plain write of one of its
rows, and the all-dead sentinel column of a non-periodic plane edge becomes
a skipped neighbour column. The skin/2 rebuild trigger lives in
``tpusph_torch.grid``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch.forces import drive_stage
from tpusph_torch.grid import BandData, needs_rebuild
from tpusph_torch.ops import cuda_build
from tpusph_torch.ops import tile_physics
from tpusph_torch.ops.rows import (
    F_ROWS, OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, OVIR, RCGX, RCGZ,
    RCV, RE, RM, RMIX, RRHO, RTYPE, RVX, RVZ, RX, RY, RZ,
)
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState

# Far-sentinel position of dead layout slots: every real-vs-dead pair fails
# the rsq < cut^2 test and coinciding dead slots self-exclude through
# rsq > 1e-12, so pair liveness is a pure distance test. Far beyond any box
# length plus image shift, well inside f32 (rsq ~ 1.2e13).
DEAD_X = 2.0e6


def dead_lane_fill(row_id: int) -> float:
    """Fill of a dead slot's field row under the sentinel-dead contract:
    far position, UNIT rho/m/cv. The units matter even though dead slots
    never pass the distance test: a 0 * inf = NaN produced while combining
    a dead slot (e.g. the Hu-Adams a_j at rho_j = 0) would poison a sum."""
    if row_id == RX:
        return DEAD_X
    if row_id in (RRHO, RM, RCV):
        return 1.0
    return 0.0


def pack_fields(state: ParticleState, mix: torch.Tensor | None = None
                ) -> torch.Tensor:
    """(F_ROWS, n_slots) float32 field matrix in R* row order. Pair
    sweeps read vest, not v (the atom_vec_meso forward-comm field set);
    the colour-gradient rows start at zero and are patched by the cgrad
    sweep."""
    n = state.capacity
    fld = torch.zeros(F_ROWS, n, dtype=torch.float32, device=state.device)
    fld[RX:RZ + 1] = state.x.T
    fld[RM] = state.rmass
    fld[RTYPE] = state.type.to(torch.float32)
    fld[RRHO] = state.rho
    if mix is not None:
        fld[RMIX] = mix
    fld[RVX:RVZ + 1] = state.vest.T
    fld[RE] = state.e
    fld[RCV] = state.cv
    return fld


def _scatter_rows(dst: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor,
                  n: int) -> torch.Tensor:
    """dst[dest] = rows, dropping entries whose dest is n (no host sync:
    the dropped entries land on one scratch row that is cut off)."""
    ext = torch.cat([dst, dst[:1]])
    ext[dest] = rows
    return ext[:n]


def _neighbor_offsets(geom):
    if geom.dim == 3:
        return [(ox, oy) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]
    return [(ox, 0) for ox in (-1, 0, 1)]


def _plane_neighbor_perm(geom, ox: int, oy: int):
    """Host-side neighbour-column permutation for one plane offset:
    (perm (ncols,) int, valid (ncols,) bool)."""
    cidx = np.arange(geom.ncols)
    if geom.dim == 3:
        cx, cy = cidx // geom.ncy, cidx % geom.ncy
        nx, ny = cx + ox, cy + oy
        if geom.periodic[0]:
            nx = nx % geom.ncx
        if geom.periodic[1]:
            ny = ny % geom.ncy
        valid = (nx >= 0) & (nx < geom.ncx) & (ny >= 0) & (ny < geom.ncy)
        perm = np.where(valid, nx * geom.ncy + ny, 0)
    else:
        nx = cidx + ox
        if geom.periodic[0]:
            nx = nx % geom.ncx
        valid = (nx >= 0) & (nx < geom.ncx)
        perm = np.where(valid, nx, 0)
    return perm, valid


def _plane_shift(geom, ox: int, oy: int, cidx: np.ndarray):
    """Per-column periodic image shifts (sx, sy) of the (ox, oy) neighbour
    column: the j positions get += shift to sit next to column cidx."""
    if geom.dim == 3:
        cx, cy = cidx // geom.ncy, cidx % geom.ncy
    else:
        cx, cy = cidx, np.zeros_like(cidx)
    nx, ny = cx + ox, cy + oy
    sx = np.zeros(len(cidx), np.float32)
    sy = np.zeros(len(cidx), np.float32)
    if geom.periodic[0]:
        sx = np.where(nx < 0, -geom.lengths[0],
                      np.where(nx >= geom.ncx, geom.lengths[0], 0.0))
    if geom.dim == 3 and geom.periodic[1]:
        sy = np.where(ny < 0, -geom.lengths[1],
                      np.where(ny >= geom.ncy, geom.lengths[1], 0.0))
    return sx.astype(np.float32), sy.astype(np.float32)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

class BandGeometry(NamedTuple):
    """Static band geometry (``tpusph.ops.band_pair.BandGeometry``).

    3D: columns tile the xy plane, sub-cells run along z.
    2D: columns tile the x axis, sub-cells run along y (ncy == 1).
    """
    ncx: int
    ncy: int          # 1 in 2D
    nsub: int         # sub-cells per column (multiple of G when periodic)
    G: int            # sub-cells per i-group
    c: int            # slots per sub-cell (multiple of 8)
    k: int            # margin sub-cells per side (k * s_sub >= cutoff + skin)
    dim: int
    periodic: tuple   # box periodicity (3,)
    lengths: tuple    # global box lengths (Lx, Ly, Lz)
    origin: tuple
    cell_xy: tuple    # cell side along the column-plane axes
    s_sub: float      # sub-cell height along the column axis
    skin: float

    @property
    def ncols(self) -> int:
        return self.ncx * self.ncy if self.dim == 3 else self.ncx

    @property
    def col_axis(self) -> int:
        return 2 if self.dim == 3 else 1

    @property
    def ngroups(self) -> int:
        return -(-self.nsub // self.G)

    @property
    def nsub_pad(self) -> int:
        return self.ngroups * self.G

    @property
    def n_slots(self) -> int:
        return self.ncols * self.nsub_pad * self.c

    @property
    def total_cells(self) -> int:
        return self.ncols * self.nsub_pad

    @property
    def w_real(self) -> int:
        return (self.G + 2 * self.k) * self.c

    @property
    def w_pad(self) -> int:
        """The window padded to the TPU's 128 lanes (the chooser's cost
        term, kept for parity; the port's windows are w_real rows)."""
        return -(-self.w_real // 128) * 128

    @property
    def gc(self) -> int:
        return self.G * self.c

    @property
    def nnbr(self) -> int:
        return 9 if self.dim == 3 else 3

    @property
    def col_periodic(self) -> bool:
        return bool(self.periodic[self.col_axis])


def choose_band_geometry(box: Box, cutoff: float, dim: int, skin: float,
                         x: np.ndarray | None = None,
                         max_gc: int = 512,
                         headroom: float = 1.2) -> BandGeometry | None:
    """Host-side geometry search — ``tpusph.ops.band_pair.
    choose_band_geometry`` line for line: enumerate (sub-cell split p, group
    size G), size the slot capacity from the MEASURED per-sub-cell occupancy
    of ``x``, and pick the candidate with the fewest issued window lanes per
    particle. Returns None when no candidate is valid (the caller falls back
    to the column kernel)."""
    lo = np.asarray(box.lo.cpu(), np.float64)
    hi = np.asarray(box.hi.cpu(), np.float64)
    length = hi - lo
    side = cutoff + skin
    if side <= 0:
        return None
    col_axis = 2 if dim == 3 else 1
    plane_axes = (0, 1) if dim == 3 else (0,)
    nc_plane = {a: max(int(length[a] // side), 1) for a in plane_axes}
    lc = float(length[col_axis])
    col_per = bool(box.periodic[col_axis])

    if x is None:
        return None
    x = np.asarray(x)
    if len(x) == 0:
        return None

    occ_cache = {}

    def occupancy(nsub_real):
        """(max, mean over occupied) particles per sub-cell; it depends on
        nsub alone, not on (G, k)."""
        if nsub_real in occ_cache:
            return occ_cache[nsub_real]
        ncs = np.ones(3, np.int64)
        for a in plane_axes:
            ncs[a] = nc_plane[a]
        ncs[col_axis] = nsub_real
        sizes = np.where(length > 0, length, 1.0) / np.maximum(ncs, 1)
        cc = np.clip(((x - lo) // sizes).astype(np.int64), 0, ncs - 1)
        flat = (cc[:, 0] * ncs[1] + cc[:, 1]) * ncs[2] + cc[:, 2]
        counts = np.bincount(flat)
        occupied = counts[counts > 0]
        out = int(counts.max()), float(occupied.mean())
        occ_cache[nsub_real] = out
        return out

    best = None
    for p in (1, 2, 3, 4, 5, 6):
        nsub0 = int(lc * p // side)
        if nsub0 < 1:
            continue
        for G in range(4, 33):
            if col_per:
                nsub = nsub0 - nsub0 % G
                if nsub < G:
                    continue
            else:
                nsub = nsub0
            s_sub = lc / nsub
            k = max(int(math.ceil(side / s_sub - 1e-9)), 1)
            if k > G:
                continue
            if col_per and G + 2 * k > nsub:
                continue  # the window would wrap onto itself
            max_occ, mean_occ = occupancy(nsub)
            c = max(int(math.ceil((max_occ * headroom + 2) / 8.0)) * 8, 8)
            gc = G * c
            if gc > max_gc:
                continue
            w_real = (G + 2 * k) * c
            w_pad = -(-w_real // 128) * 128
            if gc * w_pad > 512_000:   # the TPU's VMEM working-set guard
                continue
            nnbr = 9 if dim == 3 else 3
            # issued window lanes per alive particle (the TPU's cost)
            cost = nnbr * w_pad / max(G * mean_occ, 1e-9)
            if best is None or cost < best[0]:
                best = (cost, nsub, G, c, k, s_sub)
    if best is None:
        return None
    _, nsub, G, c, k, s_sub = best
    if dim == 3:
        ncx, ncy = nc_plane[0], nc_plane[1]
        cell_xy = (length[0] / ncx, length[1] / ncy)
    else:
        ncx, ncy = nc_plane[0], 1
        cell_xy = (length[0] / ncx, 0.0)
    return BandGeometry(
        ncx=int(ncx), ncy=int(ncy), nsub=int(nsub), G=int(G), c=int(c),
        k=int(k), dim=dim, periodic=box.periodic,
        lengths=tuple(float(v) for v in length),
        origin=tuple(float(v) for v in lo),
        cell_xy=tuple(float(v) for v in cell_xy),
        s_sub=float(s_sub), skin=float(skin))


# --------------------------------------------------------------------------
# the slot-resident build (the rebuild-cadence scatter)
# --------------------------------------------------------------------------

def subcell_id(x: torch.Tensor, geom: BandGeometry) -> torch.Tensor:
    """(N, 3) positions -> flat (column * nsub_pad + sub) cell id: a float32
    tensor-by-tensor divide (as the reference's, so a position on a sub-cell
    edge bins the same way), floor, then wrap on periodic axes and clamp on
    the others."""
    if geom.dim == 3:
        ncs = (geom.ncx, geom.ncy, geom.nsub)
        sizes = (geom.cell_xy[0], geom.cell_xy[1], geom.s_sub)
    else:
        ncs = (geom.ncx, geom.nsub, 1)
        sizes = (geom.cell_xy[0], geom.s_sub, max(geom.lengths[2], 1.0))
    dev = x.device
    origin = torch.tensor(geom.origin, dtype=torch.float32, device=dev)
    size = torch.tensor(sizes, dtype=torch.float32, device=dev)
    nc = torch.tensor(ncs, dtype=torch.int64, device=dev)
    cc = torch.floor((x - origin) / size).to(torch.int64)
    per = torch.tensor(geom.periodic, device=dev)
    cc = torch.where(per, torch.remainder(cc, nc),
                     torch.minimum(torch.clamp(cc, min=0), nc - 1))
    if geom.dim == 3:
        col, sub = cc[:, 0] * geom.ncy + cc[:, 1], cc[:, 2]
    else:
        col, sub = cc[:, 0], cc[:, 1]
    return col * geom.nsub_pad + sub


def build_slots(state: ParticleState, geom: BandGeometry, box: Box,
                nbuilds: torch.Tensor | None = None):
    """Scatter particles into the slot-resident layout, slot = sub-cell * c
    + rank (``tpusph.ops.band_pair.build_slots`` step for step): positions
    wrap (Domain::pbc), a stable sort on the sub-cell id with dead rows
    keyed to ``ncells``, rank = row - start. Particles with rank >= c are
    counted in ``overflow`` AND dropped (the host check aborts). Dead slots
    are sentinel-filled: DEAD_X positions, unit rho/cv/rmass."""
    n = state.capacity
    if n != geom.n_slots:
        raise ValueError(f"state capacity {n} != layout slots "
                         f"{geom.n_slots}")
    dev = state.device
    ncells = geom.total_cells
    c = geom.c

    state = dataclasses.replace(state, x=box.wrap(state.x))
    cid = torch.where(state.alive, subcell_id(state.x, geom), ncells)
    cid_s, perm = torch.sort(cid, stable=True)
    counts = torch.zeros(ncells + 1, dtype=torch.int64, device=dev
                         ).index_add_(0, cid_s, torch.ones_like(cid_s))[:ncells]
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)])
    idx = torch.arange(n, device=dev)
    rank = idx - starts[torch.clamp(cid_s, max=ncells - 1)]
    ok = (cid_s < ncells) & (rank < c)
    slot = torch.where(ok, cid_s * c + rank, n)      # n: the drop row
    overflow = torch.clamp(counts - c, min=0).sum().reshape(1)

    new = {f.name: _scatter_rows(torch.zeros_like(getattr(state, f.name)),
                                 slot, getattr(state, f.name)[perm], n)
           for f in dataclasses.fields(state)}
    dead = new["type"] <= 0
    new["x"] = torch.where(dead[:, None], DEAD_X, new["x"])
    for name in ("rho", "cv", "rmass"):
        new[name] = torch.where(dead, 1.0, new[name])
    new_state = ParticleState(**new)

    if nbuilds is None:
        nbuilds = torch.zeros(1, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    data = BandData(
        cell_id=torch.where(new_state.alive, rows // c, ncells),
        starts=torch.arange(ncells + 1, device=dev) * c, counts=counts,
        rank=rows % c, x_ref=new_state.x, overflow=overflow,
        nbuilds=nbuilds + 1)
    return new_state, data


# --------------------------------------------------------------------------
# the sweeps
# --------------------------------------------------------------------------

# field rows each sweep reads and output rows it writes (OVIR is the force
# sweep's rho row)
_FIELD_ROWS = {"rho": (RX, RY, RZ, RM, RTYPE, RRHO),
               "cgrad": (RX, RY, RZ, RM, RTYPE, RRHO),
               "force": tuple(range(F_ROWS))}
_OUT_ROWS = {"rho": (ORHO,), "cgrad": (OCGX, OCGY, ODE),
             "force": (OFX, OFY, OFZ, ODRHO, ODE, OVIR)}

_FLAG_BITS = ("rhosum_nd", "tait", "morris", "ideal_gas", "lj",
              "heatconduction", "heat_phasechange", "surface_tension",
              "continuity", "virial")


def spec_flags(spec: PhysicsSpec) -> int:
    return sum(1 << k for k, name in enumerate(_FLAG_BITS)
               if getattr(spec, name))


def check_inputs(what: str, fld: torch.Tensor, checks) -> None:
    """Raise ValueError unless every (name, tensor, shape, dtype) of
    ``checks`` has that shape and dtype, lies on fld's device and is
    contiguous."""
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != fld.device:
            raise ValueError(f"{what}: {name} on {t.device}, fld on "
                             f"{fld.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if fld.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {fld.device}")


# the kernels take at most this many i slots per group (one thread each)
# and stage at most this many sub-cells per window (G + 2k)
MAX_GC = 512
MAX_STAGED = 96


@functools.lru_cache(maxsize=8)
def _band_windows(geom: BandGeometry):
    """Host-side, per (column, group) block b = column * ngroups + group
    and per staged sub-cell s of its 9 (3D) / 3 (2D) neighbour windows
    (s = kk * (G + 2k) + d): the window's first slot in that sub-cell, -1
    where it holds no candidate (a neighbour column past a non-periodic
    plane edge, a margin past a non-periodic column end), and the (3,)
    float32 image shift of its positions (plane shift; -L / +L on the
    column axis for group 0's low / the last group's high margin when that
    axis is periodic). Shapes (nblocks, S) and (nblocks, S, 3)."""
    G, k, c, ng, nsp = geom.G, geom.k, geom.c, geom.ngroups, geom.nsub_pad
    nsw = G + 2 * k
    sub = np.arange(ng)[:, None] * G - k + np.arange(nsw)[None, :]
    lo, hi = sub < 0, sub >= nsp
    lcol = geom.lengths[geom.col_axis]
    if geom.col_periodic:
        sz = np.where(lo, -lcol, np.where(hi, lcol, 0.0)).astype(np.float32)
        svalid = np.ones(sub.shape, bool)
    else:
        sz = np.zeros(sub.shape, np.float32)
        svalid = ~(lo | hi)
    subw = np.mod(sub, nsp)
    cidx = np.arange(geom.ncols)
    bases, shifts = [], []
    for ox, oy in _neighbor_offsets(geom):
        perm, valid = _plane_neighbor_perm(geom, ox, oy)
        sx, sy = _plane_shift(geom, ox, oy, cidx)
        ok = valid[:, None, None] & svalid[None]
        bases.append(np.where(ok, (perm[:, None, None] * nsp + subw[None])
                              * c, -1))
        shape = ok.shape
        px = np.broadcast_to(sx[:, None, None], shape)
        py = np.broadcast_to(sy[:, None, None], shape)
        pz = np.broadcast_to(sz[None], shape)
        # 2D: the column axis is y and z takes no shift
        shifts.append(np.stack([px, py, pz] if geom.dim == 3
                               else [px, pz, np.zeros(shape, np.float32)],
                               -1))
    base = np.stack(bases, 2).reshape(geom.ncols * ng, -1)
    shift = np.stack(shifts, 2).reshape(geom.ncols * ng, -1, 3)
    return base.astype(np.int64), shift.astype(np.float32)


def live_reach(fld: torch.Tensor, c: int) -> int:
    """One past the last rank that holds a live row in any cell of ``c``
    slots: the ranks a plain sweep has to look at (one host sync)."""
    live = (fld[RTYPE].reshape(-1, c) > 0.5).any(0).nonzero()
    return int(live[-1]) + 1 if live.numel() else 0


# candidate (i slot, j slot) entries per chunk of a plain sweep: bounds its
# temporaries at any pool size
_PLAIN_CHUNK = 1 << 25


def _live_pairs(fld: torch.Tensor, islot: torch.Tensor, jslot: torch.Tensor,
                jok: torch.Tensor, sh: torch.Tensor, cutmax2: float):
    """Of the candidates (i islot[b, i], j jslot[b, m]) of each i block b,
    those a kernel keeps: j a candidate (``jok``), both types alive and
    1e-12 < rsq < cutmax2, rsq formed from x_i - (x_j + sh[b, m]) as the
    kernels form it. Returns (i slot, j slot, shift (Q, 3))."""
    def take(row, slots):
        return fld[row].index_select(0, slots.reshape(-1)).reshape(
            slots.shape)

    alive_i = take(RTYPE, islot) > 0.5
    alive_j = jok & (take(RTYPE, jslot) > 0.5)
    rsq = None
    for a in range(3):
        d = take(RX + a, islot)[:, :, None] \
            - (take(RX + a, jslot) + sh[..., a])[:, None, :]
        rsq = d * d if rsq is None else rsq + d * d
    keep = (alive_i[:, :, None] & alive_j[:, None, :] & (rsq > 1e-12)
            & (rsq < cutmax2)).nonzero()
    b, i, m = keep[:, 0], keep[:, 1], keep[:, 2]
    return islot[b, i], jslot[b, m], sh[b, m]


def plain_pair_sweep(sweep: str, fld: torch.Tensor, tabs: DeviceTables,
                     spec: PhysicsSpec, nblocks: int, block_rows: int,
                     per_block: int, pairs) -> torch.Tensor:
    """The plain sweep shared by the band and column kernels' plain
    versions. The slots fall into ``nblocks`` i blocks of ``block_rows``
    consecutive slots; ``pairs(b0, b1, cutmax2)`` lists the live pairs
    (i slot, j slot, shift) of blocks [b0, b1) (``_live_pairs``), and
    ``per_block`` is a block's candidate count, which sizes the chunks (0:
    no candidate). The physics of ``tile_physics`` runs on each pair list;
    the rho sweep adds the self term. Returns the (8, n_slots) output
    matrix with the sweep's O* rows filled on alive slots, zero
    elsewhere."""
    out = torch.zeros(8, fld.shape[1], dtype=torch.float32,
                      device=fld.device)
    step = max(1, _PLAIN_CHUNK // max(per_block, 1))
    rows = _FIELD_ROWS[sweep]
    sel = fld[list(rows)]
    for b0 in range(0, nblocks if per_block else 0, step):
        b1 = min(b0 + step, nblocks)
        pi, pj, sh = pairs(b0, b1, tabs.cutmax2[sweep])
        r0, r1 = b0 * block_rows, b1 * block_rows
        h_rows = tile_physics.hoist_i(
            {r: fld[r, r0:r1] for r in rows}, tabs.tab1, spec, sweep)
        h = {key: v.index_select(0, pi - r0) for key, v in h_rows.items()}
        fi = dict(zip(rows, sel.index_select(1, pi)))
        fj = dict(zip(rows, sel.index_select(1, pj)))
        dx = tuple(fi[RX + a] - (fj[RX + a] + sh[:, a]) for a in range(3))
        rsq = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        lk = tile_physics.Lookups(tabs.tab2, tabs.tab1, spec,
                                  fi[RTYPE].long(), fj[RTYPE].long())
        parts = tile_physics.tile_part_sums(fi, fj, h, dx, rsq, lk, spec,
                                            sweep)
        for row, p in zip(_OUT_ROWS[sweep], parts):
            out[row].index_add_(0, pi, p)
    if sweep == "rho":
        # zero on dead slots: type 0's cut_rho entry is 0
        out[ORHO] += tile_physics.rho_self(fld, tabs.tab2, spec)
    return out


def _band_pairs(fld: torch.Tensor, geom: BandGeometry, b0: int, b1: int,
                cutmax2: float, reach: int):
    """The live pairs (``_live_pairs``) of the (column, group) blocks
    [b0, b1) over the kernel's windows (``_band_windows``). Only ranks
    below ``reach`` (``live_reach``) are looked at."""
    dev = fld.device
    wbase, wshift = _band_windows(geom)
    base = torch.as_tensor(wbase[b0:b1], device=dev)          # (B, S)
    sh = torch.as_tensor(wshift[b0:b1], device=dev)           # (B, S, 3)
    r = torch.arange(reach, device=dev)
    islot = ((torch.arange(b0, b1, device=dev) * geom.gc)[:, None, None]
             + (torch.arange(geom.G, device=dev) * geom.c)[None, :, None]
             + r).flatten(1)                                  # (B, G*reach)
    jslot = (base.clamp(min=0)[:, :, None] + r).flatten(1)    # (B, M)
    jok = (base >= 0)[:, :, None].expand(-1, -1, reach).flatten(1)
    return _live_pairs(fld, islot, jslot, jok,
                       sh.repeat_interleave(reach, dim=1), cutmax2)


def plain_band_sweep(sweep: str, fld: torch.Tensor, tabs: DeviceTables,
                     geom: BandGeometry, spec: PhysicsSpec) -> torch.Tensor:
    """The plain PyTorch version of one band sweep, on any device.

    Same contract as the CUDA kernel: for i slot s of group g of column
    col, the candidates are the rows [(g*G - k) * c, (g*G + G + k) * c) of
    each of the 9 (3D) / 3 (2D) neighbour columns, with their image shift
    (``_band_windows``); a pair needs both types alive and 1e-12 < rsq, and
    pairs beyond the sweep's largest cutoff are dropped first
    (``_band_pairs``); then ``plain_pair_sweep``. No mixed-phase flag
    gates anything: the colour gradient and the capillary terms run on
    every pair."""
    reach = live_reach(fld, geom.c)
    per_block = geom.G * reach * geom.nnbr * (geom.G + 2 * geom.k) * reach
    return plain_pair_sweep(
        sweep, fld, tabs, spec, geom.ncols * geom.ngroups, geom.gc,
        per_block, lambda b0, b1, cut2: _band_pairs(fld, geom, b0, b1, cut2,
                                                    reach))


class BandSweepKernel(cuda_build.LaunchCount):
    """Wrapper of one CUDA band sweep (``band_{launcher}_launch``).

    Replaces ``tpusph.ops.band_pair.make_band_kernel(sweep=...)`` (the
    ``pl.pallas_call`` at band_pair.py:554). CPU tensors take the plain
    version (``plain_band_sweep``); CUDA tensors launch the kernel or
    raise. ``launches`` and ``by_card`` count kernel launches only.

    On the card the sweeps are bound by instruction throughput: each i row
    has 9 x (G + 2k) sub-cells of candidates (~3,500 rows to their live
    reach on the 1M bench's lattice at G 4, c 128), ~110 of them within
    the cutoff. All three sweeps filter before they compute: a block per
    group and chunk of up to 128 slots, the chunks past the alive ranks
    exiting at once; per neighbour column the group's staged sub-cells to
    their live reach, a warp's box filter (which also drops the staged
    sub-cells beyond the warp's own +-k) and each lane's exact test of the
    survivors. Force then runs a warp pair queue, the body 32 live pairs a
    pass; rho and the colour gradient add each live pair at once (one
    kernel, ``csrc/cell_sweep.cuh``, shared with the column force sweep),
    and the colour gradient stages only rows of a colour unlike one of
    the block's alive rows (a pair of one colour adds zero), so a block
    far from an interface exits after reading the types of its windows.
    Each row adds its pairs in the one-pass scan's order (the same bits);
    ``cell_filter.cell_pass_counts`` gives the phases' counts. The
    one-pass scans are ``band_rho_scan``, ``band_cgrad_scan`` and
    ``band_force_scan`` (launchers ``*_scan``), check kernels that no path
    launches: the filtered sweeps are held to them bit for bit on the
    card."""

    def __init__(self, sweep: str, launcher: str | None = None):
        self.sweep = sweep
        self.launcher = launcher or sweep
        super().__init__()

    def __call__(self, fld: torch.Tensor, tabs: DeviceTables,
                 geom: BandGeometry, spec: PhysicsSpec) -> torch.Tensor:
        n, T1 = geom.n_slots, tabs.tab1.shape[1]
        what = f"band {self.launcher} sweep"
        check_inputs(what, fld, (
            ("fld", fld, (F_ROWS, n), torch.float32),
            ("tab2", tabs.tab2, (8, T1, T1), torch.float32),
            ("tab1", tabs.tab1, (5, T1), torch.float32)))
        if geom.gc > MAX_GC or geom.G + 2 * geom.k > MAX_STAGED:
            raise ValueError(f"{what}: group of {geom.gc} slots or "
                             f"{geom.G + 2 * geom.k} staged sub-cells beyond "
                             f"{MAX_GC} / {MAX_STAGED}")
        if fld.device.type == "cpu":
            return plain_band_sweep(self.sweep, fld, tabs, geom, spec)
        out = torch.zeros(8, n, dtype=torch.float32, device=fld.device)
        per = geom.periodic
        cuda_build.launch_band(
            self.launcher, fld, tabs.tab2, tabs.tab1, out, n_slots=n,
            ncx=geom.ncx, ncy=geom.ncy, nsub_pad=geom.nsub_pad, G=geom.G,
            c=geom.c, k=geom.k, dim=geom.dim, per_x=int(per[0]),
            per_y=int(geom.dim == 3 and per[1]),
            per_col=int(geom.col_periodic), kernel=spec.kernel,
            flags=spec_flags(spec), T1=T1, lx=geom.lengths[0],
            ly=geom.lengths[1], lcol=geom.lengths[geom.col_axis],
            cutmax2=tabs.cutmax2[self.sweep])
        self.count(fld.device)
        return out


band_rho = BandSweepKernel("rho")
band_cgrad = BandSweepKernel("cgrad")
band_force = BandSweepKernel("force")
# every kernel wrapper of the band backend, by sweep (launch counts)
KERNELS = {"rho": band_rho, "cgrad": band_cgrad, "force": band_force}
# the one-pass scans: on no path, the filtered sweeps' bitwise checks
band_rho_scan = BandSweepKernel("rho", "rho_scan")
band_cgrad_scan = BandSweepKernel("cgrad", "cgrad_scan")
band_force_scan = BandSweepKernel("force", "force_scan")
SCANS = {"rho": band_rho_scan, "cgrad": band_cgrad_scan,
         "force": band_force_scan}


# --------------------------------------------------------------------------
# backend
# --------------------------------------------------------------------------

class BandBackend:
    """The band backend: the slot-resident rebuild and the fused force
    stage over the band kernels. Single device; no particle pool for phase
    change (a phase-change run never takes it). The strip backend
    subclasses it for the pool resize and the force stage, and overrides
    the layout and the sweeps."""

    name = "band"

    def __init__(self, geom, ntypes: int, rebuild_every: int = 0):
        self.geom = geom
        self.ntypes = ntypes
        self.rebuild_every = rebuild_every

    def resize(self, state: ParticleState) -> ParticleState:
        """Pad (or shrink) the pool to exactly n_slots rows. Shrinking only
        removes trailing rows and requires them dead."""
        n = self.geom.n_slots
        cap = state.capacity
        if cap == n:
            return state
        if cap < n:
            def pad(a):
                return torch.cat([a, a.new_zeros((n - cap,) + a.shape[1:])])
            return ParticleState(**{f.name: pad(getattr(state, f.name))
                                    for f in dataclasses.fields(state)})
        tail_alive = int(state.alive[n:].sum())
        if tail_alive:
            raise ValueError(
                f"{self.name} backend: {tail_alive} alive particles beyond "
                f"the {n}-slot layout capacity")
        return ParticleState(**{f.name: getattr(state, f.name)[:n]
                                for f in dataclasses.fields(state)})

    def init_aux(self, state: ParticleState, box: Box):
        return build_slots(self.resize(state), self.geom, box)

    def prepare(self, state: ParticleState, aux: BandData, istep: int,
                box: Box):
        """skin/2 trigger (or every ``rebuild_every`` steps) and the
        rebuild when it fires. Returns (state, aux, rebuilt)."""
        rebuilt = (self.rebuild_every > 0 and istep % self.rebuild_every == 0
                   ) or needs_rebuild(state, aux.x_ref, self.geom.skin)
        if rebuilt:
            state, aux = build_slots(state, self.geom, box,
                                     nbuilds=aux.nbuilds)
        return state, aux, rebuilt

    def _sweep(self, sweep, fld, tabs, spec, aux):
        """One sweep's (8, n_slots) output matrix."""
        return KERNELS[sweep](fld, tabs, self.geom, spec)

    def force_fields_steps(self, state: ParticleState, tabs,
                           spec: PhysicsSpec, aux, istep: int,
                           halo_points: bool = False):
        """The force sweep's inputs as a generator: rho sweep -> rho patch
        -> cgrad sweep -> cg patch. With ``halo_points`` it yields the
        fresh rho (n,) (every step of a rhosum run, as the reference
        refreshes it) and colour gradient (n, 3) and patches in the fields
        it is sent back (``forces.drive_stage``). Returns (fld, rho): the
        field matrix the force sweep reads and the density the step
        keeps."""
        alive = state.alive
        fld = pack_fields(state, aux.mix if spec.surface_tension else None)
        rho = state.rho
        if spec.rhosum_every > 0:
            # the sweep's sum includes the self term (tile_physics.rho_self)
            total = self._sweep("rho", fld, tabs, spec, aux)[ORHO]
            if spec.rhosum_nd:
                total = total * state.rmass
            if istep % spec.rhosum_every == 0:
                rho = torch.where(alive, total, rho)
            if halo_points:
                rho = yield rho
            fld[RRHO] = rho
        if spec.surface_tension:
            out = self._sweep("cgrad", fld, tabs, spec, aux)
            cg = torch.where(alive, torch.stack([out[OCGX], out[OCGY],
                                                 out[ODE]]), 0.0)
            if halo_points:
                cg = (yield cg.T).T
            fld[RCGX:RCGZ + 1] = cg
        return fld, rho

    def force_fields(self, state: ParticleState, tabs, spec: PhysicsSpec,
                     aux, istep: int, halo=None):
        """``force_fields_steps`` run to its end; ``halo``: a field ->
        field callable applied to the fresh rho and colour gradient before
        they are patched in (the bricks' mid-force owner -> ghost refresh,
        ``tpusph``'s ``force_stage(..., halo=)``)."""
        return drive_stage(self.force_fields_steps(
            state, tabs, spec, aux, istep, halo_points=halo is not None),
            halo)

    def force_stage_steps(self, state: ParticleState, tabs,
                          spec: PhysicsSpec, aux, istep: int,
                          halo_points: bool = False):
        """``force_fields_steps`` -> force sweep -> gravity, as a
        generator (see ``force_fields_steps``)."""
        alive = state.alive
        fld, rho = yield from self.force_fields_steps(
            state, tabs, spec, aux, istep, halo_points)
        out = self._sweep("force", fld, tabs, spec, aux)
        upd = dict(
            rho=rho,
            f=torch.where(alive[:, None], out[OFX:OFZ + 1].T, 0.0),
            drho=torch.where(alive, out[ODRHO], 0.0),
            de=torch.where(alive, out[ODE], 0.0))
        if spec.virial:
            upd["vir"] = torch.where(alive, out[OVIR], 0.0)
        if spec.gravity:
            gmask = (alive & state.mobile)[:, None]
            upd["f"] = upd["f"] + torch.where(
                gmask, state.rmass[:, None] * tabs.gravity[None, :], 0.0)
        return dataclasses.replace(state, **upd)

    def force_stage(self, state: ParticleState, tabs, spec: PhysicsSpec,
                    aux, istep: int, halo=None) -> ParticleState:
        """``force_fields`` -> force sweep -> gravity. ``tabs`` is
        ``PairTables.stacked``'s device tables; ``halo`` as in
        ``force_fields``."""
        return drive_stage(self.force_stage_steps(
            state, tabs, spec, aux, istep, halo_points=halo is not None),
            halo)
