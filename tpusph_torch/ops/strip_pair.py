"""The strip backend on torch: z-sorted dense columns, rank windows and
seam-ghost bands — the counterpart of ``tpusph/ops/strip_pair.py`` (see its
module docstring for the layout's design), with the three pair sweeps and
the fix phase_change vapor query as hand-written CUDA kernels
(``csrc/strip_sweeps.cu``).

What the port keeps, and why:
  * ``choose_strip_geometry`` is the reference's host chooser carried over
    as is, with its TPU cost terms (``_TILE_FIXED_LANES``, ``STRIP_W_CAP``,
    the 128-lane window pad, the SMEM-budget reject) kept for parity:
    the geometry then equals the reference's field for field. Re-deriving
    those terms for the card is later work.
  * ``build_strips`` is the reference's rebuild in torch: one (column, z)
    key sort, the destination permutation, seam-ghost bands, the
    window-retarget ``delta`` tables and the rank-exact coverage check.
    torch has no uint32 sort, so keys are int64 with the same 12 column
    bits and 20 z bits.

What it drops: the materialized window array and the bit-packed SMEM
delta tables (``pack_i_strip``, ``pack_window_strip``, ``window_row``,
``_pack_delta``). They exist because Mosaic cannot slice lanes
dynamically; a CUDA block reads its j-window straight from the slot-major
field matrix at a ``delta``-shifted row offset.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch.grid import GridData, needs_rebuild
from tpusph_torch.ops import cuda_build
from tpusph_torch.ops import tile_physics
from tpusph_torch.ops.band_pair import (
    _FIELD_ROWS, _OUT_ROWS, BandBackend, _neighbor_offsets,
    _plane_neighbor_perm, _plane_shift, _scatter_rows, check_inputs,
    dead_lane_fill, pack_fields, spec_flags,
)
from tpusph_torch.ops.rows import (
    F_ROWS, OCGX, OCGY, ODE, OFX, OFY, ORHO, RCV, RM, RMIX, RRHO, RSLOT,
    RTYPE, RX, RY, RZ,
)
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState

TS = 64       # default i-tile rows
CH = 32       # default window chunk rows


class StripGeometry(NamedTuple):
    """Static strip geometry; field meanings as in
    ``tpusph.ops.strip_pair.StripGeometry``."""
    ncx: int
    ncy: int            # 1 in 2D
    col_cap: int        # slots per column, multiple of ts * t_blk
    head: int           # reserved head rows (top-seam ghost band)
    tail: int           # tail ghost budget rows (bottom-seam band)
    mlo: int            # margin chunks (ch rows) below an i-tile's window
    mhi: int            # margin chunks above
    dim: int
    periodic: tuple
    lengths: tuple
    origin: tuple
    cell_xy: tuple
    margin_dist: float  # cutoff + skin the margins must cover
    skin: float
    ts: int = TS
    ch: int = CH
    t_blk: int = 2      # tiles per block (delta tables are per block)

    @property
    def ncols(self) -> int:
        return self.ncx * self.ncy if self.dim == 3 else self.ncx

    @property
    def col_axis(self) -> int:
        return 2 if self.dim == 3 else 1

    @property
    def ntiles(self) -> int:
        return self.col_cap // self.ts

    @property
    def n32(self) -> int:
        """Chunks per column (historic name; chunk = ch rows)."""
        return self.col_cap // self.ch

    @property
    def stride(self) -> int:
        return self.ts // self.ch

    @property
    def n_slots(self) -> int:
        return self.ncols * self.col_cap

    @property
    def w(self) -> int:
        return self.ch * (self.mlo + self.stride + self.mhi)

    @property
    def nblocks(self) -> int:
        return self.ntiles // self.t_blk

    @property
    def block_rows(self) -> int:
        return self.t_blk * self.ts

    @property
    def nnbr(self) -> int:
        return 9 if self.dim == 3 else 3

    @property
    def col_periodic(self) -> bool:
        return bool(self.periodic[self.col_axis])

    @property
    def ghost_depth(self) -> float:
        return 2.0 * self.margin_dist


# The chooser's cost terms, measured for the TPU v5e and kept for parity
# with the reference geometry (module docstring).
_TILE_FIXED_LANES = 18000.0
STRIP_W_CAP = 1152
SLACK = 4

DEFAULT_TS_CH = ((64, 32), (64, 16), (64, 8), (48, 16), (48, 8),
                 (32, 16), (32, 8), (16, 16), (16, 8))


def pad_window_to_vreg(ts: int, ch: int, mlo: int, mhi: int,
                       nch: int) -> tuple[int, int]:
    """Grow the window margins to the next 128-row multiple (the TPU vreg
    width; kept for geometry parity)."""
    stride = ts // ch
    w = ch * (mlo + stride + mhi)
    target = -(-w // 128) * 128
    extra = (target - w) // ch
    add_lo = min(extra // 2, max(nch - mlo, 0))
    mlo += add_lo
    mhi = min(mhi + (extra - add_lo), nch)
    return mlo, mhi


def _pref_t_blk(ts: int) -> int:
    """Tiles per block: ~128 i-rows per block regardless of tile size."""
    return max(128 // ts, 1)


def _delta_pack(nblocks: int) -> int:
    """Delta entries per 32-bit word of the reference's SMEM table (the
    chooser's SMEM-budget reject reads it)."""
    return 4 if nblocks <= 120 else 2


def choose_strip_geometry(box: Box, cutoff: float, dim: int, skin: float,
                          x: np.ndarray | None = None,
                          headroom: float = 1.08,
                          candidates=DEFAULT_TS_CH,
                          plane_nc=None,
                          drift: float = 1.0,
                          extra_rows: tuple = (0, 0)) -> StripGeometry | None:
    """Host-side geometry choice from the MEASURED particle distribution —
    ``tpusph.ops.strip_pair.choose_strip_geometry`` line for line (see its
    docstring for ``drift`` and ``extra_rows``), less the environment
    knobs. ``plane_nc`` forces the plane column counts (the bricks: every
    brick runs one layout, so the lead brick's choice binds them all).
    Returns None when the box cannot strip."""
    if x is None or len(x) == 0:
        return None
    lo = np.asarray(box.lo.cpu(), np.float64)
    hi = np.asarray(box.hi.cpu(), np.float64)
    length = hi - lo
    side = cutoff + skin
    if side <= 0:
        return None
    col_axis = 2 if dim == 3 else 1
    plane_axes = (0, 1) if dim == 3 else (0,)
    nc = {a: max(int(length[a] // side), 1) for a in plane_axes}
    ncols = int(np.prod([nc[a] for a in plane_axes]))
    if ncols >= (1 << 12):
        return None  # sort key budget: 12 column bits + 20 z bits
    lz = float(length[col_axis])
    col_per = bool(box.periodic[col_axis])
    depth = 2.0 * side
    if col_per and lz < 2.0 * depth * (1.0 - 1e-6):
        return None  # the ghost bands would overlap across the column

    # measure on the positions build_strips will bin: f32 wrap, then f32
    # floor/mod column binning (see the reference for why bit-equality
    # matters here)
    x32 = np.asarray(x, np.float32)
    xw = x32.copy()
    for a in range(x32.shape[1]):
        if box.periodic[a]:
            la = np.float32(lo[a])
            xw[:, a] = la + np.mod(x32[:, a] - la, np.float32(length[a]))
    x = xw
    offsets = ([(ox, oy) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]
               if dim == 3 else [(ox, 0) for ox in (-1, 0, 1)])

    def ceil128(v):
        return -(-v // 128) * 128

    def measure_nc(nc):
        """Per-row extreme rank reach and occupancy for ONE plane-column
        count choice."""
        cols = None
        for a in plane_axes:
            cell = np.float32(length[a] / nc[a])
            cc = np.floor((x[:, a] - np.float32(lo[a])) / cell
                          ).astype(np.int64)
            cc = cc % nc[a] if box.periodic[a] else np.clip(cc, 0,
                                                            nc[a] - 1)
            cols = cc if cols is None else cols * nc[a] + cc
        z = np.clip(x[:, col_axis] - np.float32(lo[col_axis]),
                    np.float32(0.0), np.float32(lz * (1 - 1e-7)))
        ncols = int(np.prod([nc[a] for a in plane_axes]))
        counts = np.bincount(cols, minlength=ncols)
        nb2 = nt2 = 0
        if col_per:
            nb2 = int(np.bincount(cols[z < np.float32(depth)],
                                  minlength=ncols).max())
            nt2 = int(np.bincount(cols[z > np.float32(lz - depth)],
                                  minlength=ncols).max())

        # exact cross-column rank margins in RANK space, ghost bands
        # included
        order = np.lexsort((z, cols))
        kc, kz = cols[order], z[order]
        starts_r = np.concatenate([[0], np.cumsum(counts)])
        rank_r = np.arange(len(kz)) - starts_r[kc]
        ext_col = [kc]
        ext_z = [kz]
        ext_rank = [rank_r]
        if col_per:
            bot = kz < np.float32(depth)
            ext_col.append(kc[bot])
            ext_z.append(kz[bot] + lz)
            ext_rank.append(counts[kc[bot]] + rank_r[bot])
            top = kz > np.float32(lz - depth)
            ext_col.append(kc[top])
            ext_z.append(kz[top] - lz)
            ext_rank.append(-(counts[kc[top]] - rank_r[top]))
        ec = np.concatenate(ext_col)
        ez = np.concatenate(ext_z)
        er = np.concatenate(ext_rank).astype(np.float64)
        stride_key = 2.0 * lz + 2.0 * depth + 4.0
        eorder = np.argsort(ec * stride_key + ez, kind="stable")
        ec, ez, er = ec[eorder], ez[eorder], er[eorder]
        ekeys = ec * stride_key + ez
        ec_s = np.concatenate([ec, [-1]])
        er_s = np.concatenate([er, [0.0]])

        if dim == 3:
            qcx, qcy = ec // nc[1], ec % nc[1]
        else:
            qcx, qcy = ec, np.zeros_like(ec)
        m_samp = len(ec)
        lo_ks, hi_ks = [], []
        col_valid, col_nbr = [], []
        cidx = np.arange(ncols)
        if dim == 3:
            ccx, ccy = cidx // nc[1], cidx % nc[1]
        else:
            ccx, ccy = cidx, np.zeros_like(cidx)
        for ox, oy in offsets:
            nx = qcx + ox
            ny = qcy + oy
            cnx = ccx + ox
            cny = ccy + oy
            if box.periodic[0]:
                nx = nx % nc[0]
                cnx = cnx % nc[0]
            if dim == 3 and box.periodic[1]:
                ny = ny % nc[1]
                cny = cny % nc[1]
            valid = (nx >= 0) & (nx < nc[0])
            cvalid = (cnx >= 0) & (cnx < nc[0])
            if dim == 3:
                valid &= (ny >= 0) & (ny < nc.get(1, 1))
                cvalid &= (cny >= 0) & (cny < nc.get(1, 1))
                ncq = nx * nc[1] + ny
                cnq = cnx * nc[1] + cny
            else:
                ncq = nx
                cnq = cnx
            ncq = np.where(valid, ncq, 0)
            col_nbr.append(np.where(cvalid, cnq, 0))
            col_valid.append(cvalid)
            ilo = np.searchsorted(ekeys, ncq * stride_key + (ez - side))
            in_col = ec_s[ilo] == ncq
            lo_ks.append(np.where(in_col & valid, er_s[ilo],
                                  np.inf).astype(np.float32))
            ihi = np.searchsorted(ekeys, ncq * stride_key + (ez + side),
                                  side="right") - 1
            in_col = ec_s[ihi] == ncq
            hi_ks.append(np.where(in_col & valid, er_s[ihi],
                                  -np.inf).astype(np.float32))
        colstart = np.searchsorted(ec, np.arange(ncols + 1))
        rmin = np.where(colstart[1:] > colstart[:-1],
                        er[np.minimum(colstart[:-1], m_samp - 1)], 0)
        rmax = np.where(colstart[1:] > colstart[:-1],
                        er[np.maximum(colstart[1:] - 1, 0)], 0)
        return dict(ec=ec, ez=ez, er=er, ekeys=ekeys, ec_s=ec_s, er_s=er_s,
                    stride_key=stride_key, lo_ks=lo_ks, hi_ks=hi_ks,
                    col_nbr=col_nbr, col_valid=col_valid,
                    colstart=colstart, rmin=rmin, rmax=rmax,
                    counts=counts, nb2=nb2, nt2=nt2, ncols=ncols)

    # (column count) x (ts, ch) enumeration; cheap mismatch proxy first
    nc0 = {a: max(int(length[a] // side), 1) for a in plane_axes}

    def proxy(nc):
        cols_p = None
        for a in plane_axes:
            cc = np.clip(((x[:, a] - lo[a]) / (length[a] / nc[a])
                          ).astype(np.int64), 0, nc[a] - 1)
            cols_p = cc if cols_p is None else cols_p * nc[a] + cc
        ncols_p = int(np.prod([nc[a] for a in plane_axes]))
        dens = np.bincount(cols_p, minlength=ncols_p) / max(lz, 1e-30)
        if dim == 3:
            d2 = dens.reshape(nc[0], nc[1])
        else:
            d2 = dens.reshape(nc[0], 1)
        worst = 0.0
        for ox in (-1, 0, 1):
            for oy in ((-1, 0, 1) if dim == 3 else (0,)):
                dn = np.roll(np.roll(d2, ox, 0), oy, 1)
                pair = side * np.maximum(d2, dn) + np.abs(d2 - dn) * lz
                worst = max(worst, float(pair.max()))
        return worst

    if plane_nc is not None:
        nc_list = [{a: int(v) for a, v in zip(plane_axes, plane_nc)}]
    else:
        lo_nc = {a: max(int(math.ceil(nc0[a] * 0.6)), 1)
                 for a in plane_axes}
        opts = []
        for k in range(nc0[plane_axes[0]] - lo_nc[plane_axes[0]] + 1):
            nc = {a: max(nc0[a] - k, 1) for a in plane_axes}
            opts.append((proxy(nc), k, nc))
        opts.sort(key=lambda t: (t[0], t[1]))
        nc_list = [t[2] for t in opts[:4]]
        if nc0 not in nc_list:
            nc_list.append(dict(nc0))
    best = None
    seen_nc = set()
    for nc in nc_list:
        key_nc = tuple(sorted(nc.items()))
        if key_nc in seen_nc:
            continue
        seen_nc.add(key_nc)
        ncols = int(np.prod([nc[a] for a in plane_axes]))
        if ncols >= (1 << 12):
            continue
        M = measure_nc(nc)
        max_cnt = int(M["counts"].max())
        nb2, nt2 = M["nb2"], M["nt2"]
        er = M["er"]
        ec_i = M["ec"].astype(np.int64)
        noffs = len(offsets)
        tb_opts = []
        for ts, ch in candidates:
            pref = _pref_t_blk(ts)
            for tb in {pref, max(pref // 2, 1), max(pref // 4, 1)}:
                tb_opts.append((ts, ch, tb))
        for ts, ch, t_blk in tb_opts:
            if ts % ch or ch > ts:
                continue
            B = ts * t_blk
            if best is not None and \
                    (ceil128(ch * (2 + ts // ch)) + _TILE_FIXED_LANES / ts) \
                    * (1 + 6.0 / B) > best[0][0]:
                continue
            head = int(math.ceil((nt2 * headroom + 4) / ch)) * ch \
                if col_per else 0
            tail = int(math.ceil((nb2 * headroom + 4) / ch)) * ch \
                if col_per else 0
            col_cap = int(math.ceil(
                (head + max_cnt * headroom + tail + ch) / B)) * B
            nblocks = col_cap // B
            # the reference's SMEM budget for its packed delta tables
            smem_bytes = ncols * len(offsets) * nblocks \
                * (32 // _delta_pack(nblocks) // 8)
            if smem_bytes > 512 * 1024:
                continue
            qslot = er + head
            tfloor = np.floor(qslot / ts) * ts

            # emulate the per-rebuild delta tables for THIS layout
            b_idx = np.arange(nblocks)
            rc = b_idx[None, :] * B + B // 2 - head
            rc_c = np.clip(rc, M["rmin"][:, None], M["rmax"][:, None])
            pos = M["colstart"][:-1][:, None] + (rc_c - M["rmin"][:, None])
            pos = np.clip(pos, 0, len(M["ez"]) - 1).astype(np.int64)
            zc = M["ez"][pos]
            blk_of = np.clip(((qslot) // B).astype(np.int64), 0, nblocks - 1)
            need_lo = 0.0
            need_hi = 0.0
            for k in range(noffs):
                ncq = M["col_nbr"][k][:, None]
                ilo = np.searchsorted(M["ekeys"],
                                      ncq * M["stride_key"] + zc)
                cs_n = M["colstart"][:-1][ncq[:, 0]][:, None]
                ce_n = M["colstart"][1:][ncq[:, 0]][:, None]
                ok = (ce_n > cs_n) & M["col_valid"][k][:, None]
                ilo = np.clip(ilo, cs_n, np.maximum(ce_n - 1, cs_n))
                r_nc = np.where(ok, M["er"][np.clip(ilo, 0, len(M["er"])
                                                    - 1)], rc_c)
                frac = (r_nc - rc_c) / B
                d = np.round(frac)
                risky = np.abs(frac - np.floor(frac) - 0.5) < 0.1
                d_up = np.where(risky, np.floor(frac) + 1, d)
                d_dn = np.where(risky, np.floor(frac), d)

                def clipped(dv):
                    dv = np.clip(dv, -b_idx[None, :],
                                 nblocks - 1 - b_idx[None, :])
                    return np.where(M["col_valid"][k][:, None], dv, 0.0)

                ds_up = clipped(d_up)[ec_i, blk_of] * B
                ds_dn = clipped(d_dn)[ec_i, blk_of] * B
                need_lo = max(need_lo, float(np.max(
                    tfloor + ds_up - (M["lo_ks"][k] + head))))
                need_hi = max(need_hi, float(np.max(
                    (M["hi_ks"][k] + head) - (tfloor + ts - 1) - ds_dn)))
            need_lo = max(need_lo, 0.0)
            need_hi = max(need_hi, 0.0)
            drift_rows = drift * skin * float(max_cnt) / max(lz, 1e-30)
            need_lo = max(need_lo + drift_rows, float(extra_rows[0]))
            need_hi = max(need_hi + drift_rows, float(extra_rows[1]))

            def chunks(need):
                nat = max(int(math.ceil(need / ch)), 1)
                if nat * ch - need < SLACK and drift_rows < SLACK:
                    nat += 1
                return nat

            nch = col_cap // ch
            mlo = min(chunks(need_lo), nch)
            mhi = min(chunks(need_hi), nch)
            w = ch * (mlo + ts // ch + mhi)
            if w > STRIP_W_CAP:
                continue
            cost = (ceil128(w) + _TILE_FIXED_LANES / ts) * (1 + 6.0 / B)
            key = (cost, -ncols, -B, -ts, -ch)
            if best is None or key < best[0]:
                best = (key, dict(nc), ts, ch, head, tail, col_cap,
                        mlo, mhi, t_blk)
    if best is None:
        return None
    _, nc, ts, ch, head, tail, col_cap, mlo, mhi, t_blk = best
    mlo, mhi = pad_window_to_vreg(ts, ch, mlo, mhi, col_cap // ch)

    if dim == 3:
        ncx, ncy = nc[0], nc[1]
        cell_xy = (length[0] / ncx, length[1] / ncy)
    else:
        ncx, ncy = nc[0], 1
        cell_xy = (length[0] / ncx, 0.0)
    return StripGeometry(
        ncx=int(ncx), ncy=int(ncy), col_cap=int(col_cap), head=int(head),
        tail=int(tail), mlo=mlo, mhi=mhi, dim=dim, periodic=box.periodic,
        lengths=tuple(float(v) for v in length),
        origin=tuple(float(v) for v in lo),
        cell_xy=tuple(float(v) for v in cell_xy),
        margin_dist=float(side), skin=float(skin), ts=int(ts), ch=int(ch),
        t_blk=int(t_blk))


# --------------------------------------------------------------------------
# rebuild: one key sort into dense z-ordered columns + seam ghosts
# --------------------------------------------------------------------------

def _fdiv(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / f32(s) as a true division. torch's CUDA path divides by a
    Python scalar as a multiply by its reciprocal, which can round
    differently at bin edges than the chooser's numpy division."""
    return a / torch.full((), s, dtype=torch.float32, device=a.device)


def column_id(x: torch.Tensor, geom: StripGeometry):
    """(N, 3) positions -> (column id, z offset in [0, Lz))."""
    dev = x.device
    origin = torch.tensor(geom.origin, dtype=torch.float32, device=dev)
    if geom.dim == 3:
        axes, ncs = (0, 1), (geom.ncx, geom.ncy)
        sizes = (geom.cell_xy[0], geom.cell_xy[1])
    else:
        axes, ncs = (0,), (geom.ncx,)
        sizes = (geom.cell_xy[0],)
    col = None
    for a, sz, n in zip(axes, sizes, ncs):
        cc = torch.floor(_fdiv(x[:, a] - origin[a], sz)).to(torch.int64)
        cc = torch.remainder(cc, n) if geom.periodic[a] \
            else torch.clamp(cc, 0, n - 1)
        col = cc if col is None else col * n + cc
    ca = geom.col_axis
    lz = geom.lengths[ca]
    z = torch.clamp(x[:, ca] - origin[ca], 0.0, lz * (1.0 - 1e-7))
    return col, z


def build_strips(state: ParticleState, geom: StripGeometry, box: Box,
                 nbuilds: torch.Tensor | None = None, extra=None,
                 keep_ghosts: bool = False, return_seam: bool = False):
    """Sort owned particles into dense z-ordered columns (slot = col*cap +
    head + rank), write the seam-ghost bands, and build the window-retarget
    tables and the coverage check — ``tpusph.ops.strip_pair.build_strips``
    step for step. Positions wrap here (Domain::pbc). Overflows (a column
    fuller than its budget, a seam band fuller than its reserve, or a
    window that no longer covers cutoff+skin) are counted, never dropped
    silently.

    For the bricks (``tpusph_torch.dist``): ``extra`` is a dict of (n,) /
    (n, S) integer marker tensors carried to the rows' slots (the halo
    bookkeeping; a seam-band slot carries the marker of the dead row the
    placement sent there); ``keep_ghosts`` sorts halo ghosts (alive,
    owned=False) in as regular rows instead of dropping them;
    ``return_seam`` also returns the seam-band copy map (src, dest with n
    = none, column-axis shift), which the bricks re-copy after every
    owner -> ghost refresh. Returns (state, GridData[, extra][, seam])."""
    n = state.capacity
    if n != geom.n_slots:
        raise ValueError(f"state capacity {n} != layout slots "
                         f"{geom.n_slots}")
    dev = state.device
    cap, head, ncols = geom.col_cap, geom.head, geom.ncols
    ca = geom.col_axis
    lz = geom.lengths[ca]
    depth = geom.ghost_depth

    state = dataclasses.replace(state, x=box.wrap(state.x))
    # earlier seam copies are dropped; with keep_ghosts the bricks have
    # killed them (and their stale halo ghosts) already, and the fresh
    # halo ghosts sort in as regular rows
    live = state.alive if keep_ghosts else (state.alive & state.owned)
    col, z = column_id(state.x, geom)
    zq = torch.clamp((z * (float(1 << 20) / lz)).to(torch.int64),
                     max=(1 << 20) - 1)
    key = torch.where(live, col, ncols) * (1 << 20) \
        + torch.where(live, zq, 0)

    idx = torch.arange(n, device=dev)
    key_s, perm1 = torch.sort(key, stable=True)
    live_s = key_s < ncols * (1 << 20)
    col_s = torch.clamp(key_s >> 20, max=ncols - 1)

    live_col = torch.where(live_s, col_s, ncols)
    starts_c = torch.searchsorted(live_col,
                                  torch.arange(ncols + 1, device=dev))
    counts = starts_c[1:] - starts_c[:-1]
    budget = cap - head - geom.tail
    count_eff = torch.clamp(counts, max=budget)
    overflow = (counts - count_eff).sum()
    change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        live_col[1:] != live_col[:-1]])
    run_start = torch.cummax(torch.where(change, idx, 0), dim=0).values
    rank = idx - run_start
    ok = live_s & (rank < budget)
    slot = col_s * cap + head + rank

    # destination permutation: dead/dropped rows take the unused slots in
    # ascending order
    pos_all = idx % cap
    count_rep = count_eff.repeat_interleave(cap)
    occ = (pos_all >= head) & (pos_all < head + count_rep)
    unused_sorted = torch.sort(occ.to(torch.int32), stable=True).indices
    cumok = torch.cumsum(ok.to(torch.int64), dim=0)
    d = idx - cumok
    comp_dead = unused_sorted[torch.clamp(d, 0, n - 1)]
    comp = torch.where(ok, slot, comp_dead)
    # comp is a bijection: sorting it yields, for every destination slot,
    # its source row in original order
    src0 = perm1[torch.sort(comp).indices]

    fmat = torch.cat(
        [state.x, state.v, state.vest, state.rho[:, None], state.e[:, None],
         state.cv[:, None], state.rmass[:, None], state.rho_c[:, None],
         state.e_c[:, None]], dim=1)[src0]
    imat = torch.stack(
        [state.type, state.tag, state.owned.to(torch.int32),
         state.mobile.to(torch.int32)], dim=1)[src0]
    imat[:, 0] = torch.where(occ, imat[:, 0], 0)
    # sentinel-fill dead slots before the seam copy (fmat columns: x 0:3,
    # v 3:6, vest 6:9, rho 9, e 10, cv 11, rmass 12, rho_c 13, e_c 14)
    dead_fill = torch.tensor(
        [dead_lane_fill(RX)] * 3 + [0.0] * 6
        + [dead_lane_fill(RRHO), 0.0, dead_lane_fill(RCV),
           dead_lane_fill(RM), 0.0, 0.0], dtype=torch.float32, device=dev)
    fmat = torch.where(occ[:, None], fmat, dead_fill[None, :])
    extra_out = None if extra is None else \
        {k: v[src0] for k, v in extra.items()}

    empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
    seam = (empty_i, empty_i, torch.zeros(0, dtype=torch.float32,
                                          device=dev))
    if geom.col_periodic and (head or geom.tail):
        gb = head + geom.tail
        k = ncols * gb
        jj = torch.arange(k, device=dev)
        gcol = jj // gb
        off = jj % gb
        cnt_k = count_eff[gcol]
        z_slot = fmat[:, ca] - geom.origin[ca]
        nb = torch.zeros(ncols + 1, dtype=torch.int64, device=dev).index_add_(
            0, torch.where(occ & (z_slot < depth), idx // cap, ncols),
            torch.ones_like(idx))[:ncols]
        nt = torch.zeros(ncols + 1, dtype=torch.int64, device=dev).index_add_(
            0, torch.where(occ & (z_slot > lz - depth), idx // cap, ncols),
            torch.ones_like(idx))[:ncols]
        is_top = off < head
        dest = torch.where(is_top, gcol * cap + off,
                           gcol * cap + head + cnt_k + (off - head))
        src = torch.where(is_top, dest + cnt_k, dest - cnt_k)
        valid = torch.where(is_top, off >= head - nt[gcol],
                            (off - head) < nb[gcol])
        overflow = overflow + torch.clamp(nt - head, min=0).sum() \
            + torch.clamp(nb - geom.tail, min=0).sum()
        src = torch.clamp(src, 0, n - 1)
        dest_w = torch.where(valid, dest, n)
        shift = torch.where(is_top, -lz, lz).to(torch.float32)
        g_f = fmat[src]
        g_f[:, ca] += shift
        fmat = _scatter_rows(fmat, dest_w, g_f, n)
        g_i = imat[src]
        g_i[:, 2] = 0                       # ghost copies: owned=False
        imat = _scatter_rows(imat, dest_w, g_i, n)
        seam = (src, dest_w, shift)

    z3 = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    zn = torch.zeros(n, dtype=torch.float32, device=dev)
    new_state = dataclasses.replace(
        state, x=fmat[:, 0:3].contiguous(), v=fmat[:, 3:6].contiguous(),
        vest=fmat[:, 6:9].contiguous(), rho=fmat[:, 9].contiguous(),
        e=fmat[:, 10].contiguous(), cv=fmat[:, 11].contiguous(),
        rmass=fmat[:, 12].contiguous(), rho_c=fmat[:, 13].contiguous(),
        e_c=fmat[:, 14].contiguous(), type=imat[:, 0].contiguous(),
        tag=imat[:, 1].contiguous(), owned=imat[:, 2] > 0,
        mobile=imat[:, 3] > 0, f=z3, drho=zn, de=zn.clone(), vir=zn.clone())

    # ---- window-retarget tables (delta): per (column, neighbour, block)
    # offsets in blocks that re-centre each window on the home block's z
    zs = new_state.x[:, ca] - geom.origin[ca]
    alive_slot = new_state.alive
    big = float(np.float32(8.0 * lz + 8.0))
    stride = geom.stride
    B = geom.block_rows
    nblocks = geom.nblocks
    slot_pos = idx % cap
    zfill = torch.where(slot_pos < head, -big, big)
    zcol = torch.where(alive_slot, zs, zfill).reshape(ncols, cap)
    alive2 = alive_slot.reshape(ncols, cap).to(torch.int32)
    lo_live = torch.argmax(alive2, dim=1)
    hi_live = cap - 1 - torch.argmax(torch.flip(alive2, dims=[1]), dim=1)
    center_slot = torch.arange(nblocks, device=dev) * B + B // 2
    cs = torch.minimum(torch.maximum(center_slot[None, :], lo_live[:, None]),
                       hi_live[:, None])
    zc = torch.gather(zcol, 1, cs)
    b_idx = torch.arange(nblocks, device=dev)
    perms, valids = _neighbor_tables(geom, dev)
    zps = [zcol[perm].contiguous() for perm in perms]
    deltas = []
    for zp, valid in zip(zps, valids):
        r_nc = torch.searchsorted(zp, zc.contiguous())
        d = torch.round(_fdiv((r_nc - cs).to(torch.float32), B)
                        ).to(torch.int64)
        d = torch.minimum(torch.maximum(d, -b_idx[None, :]),
                          nblocks - 1 - b_idx[None, :])
        deltas.append(torch.where(valid[:, None], d, 0))
    delta = torch.stack(deltas, dim=1).to(torch.int32)

    # ---- the rank-exact coverage check: each tile's delta-shifted window
    # must contain every neighbour-column slot within cutoff+skin in z; the
    # shortfall in rows is surfaced for the violation re-choice
    zf = torch.where(alive_slot, zs, big).reshape(ncols, geom.n32, geom.ch)
    zl = torch.where(alive_slot, zs, -big).reshape(ncols, geom.n32, geom.ch)
    zfirst = zf.amin(dim=2)
    zlast = zl.amax(dim=2)
    t_idx = torch.arange(geom.ntiles, device=dev)
    ce = geom.margin_dist
    tile_alive = zfirst[:, ::stride] < big * 0.5
    zf_self = zfirst[:, ::stride].contiguous()
    zl_self = zlast[:, stride - 1::stride].contiguous()
    win_lo0 = t_idx[None, :] * geom.ts - geom.ch * geom.mlo
    win_hi0 = t_idx[None, :] * geom.ts + geom.ts - 1 + geom.ch * geom.mhi
    short_lo = torch.zeros(zf_self.shape, dtype=torch.int64, device=dev)
    short_hi = torch.zeros_like(short_lo)
    NO_NEED = -(1 << 30)
    need_lo = torch.full(zf_self.shape, NO_NEED, dtype=torch.int64,
                         device=dev)
    need_hi = torch.full_like(need_lo, NO_NEED)
    for kk, (zp, valid) in enumerate(zip(zps, valids)):
        vmask = valid[:, None] & tile_alive
        d_rows = (delta[:, kk, :].to(torch.int64) * B).repeat_interleave(
            geom.t_blk, dim=1)
        lo_need = torch.searchsorted(zp, zf_self - ce)
        hi_need = torch.searchsorted(zp, zl_self + ce, right=True) - 1
        s_lo = torch.minimum(win_lo0 + d_rows, hi_need + 1) - lo_need
        s_hi = hi_need - torch.maximum(win_hi0 + d_rows, lo_need - 1)
        short_lo = torch.maximum(short_lo, torch.where(vmask, s_lo, 0))
        short_hi = torch.maximum(short_hi, torch.where(vmask, s_hi, 0))
        need_lo = torch.maximum(need_lo, torch.where(vmask, s_lo, NO_NEED))
        need_hi = torch.maximum(need_hi, torch.where(vmask, s_hi, NO_NEED))
    viol = ((short_lo > 0) | (short_hi > 0)).sum()
    margin_short = torch.stack([torch.clamp(short_lo.max(), min=0),
                                torch.clamp(short_hi.max(), min=0)])
    margin_need = torch.stack([need_lo.max(), need_hi.max()])
    overflow = (overflow + viol).reshape(1)

    if nbuilds is None:
        nbuilds = torch.zeros(1, dtype=torch.int64, device=dev)
    data = GridData(counts=counts, x_ref=new_state.x, overflow=overflow,
                    nbuilds=nbuilds + 1, delta=delta, seam_src=seam[0],
                    seam_dest=seam[1], seam_shift=seam[2],
                    margin_short=margin_short, margin_need=margin_need)
    ret = (new_state, data)
    if extra is not None:
        ret = ret + (extra_out,)
    if return_seam:
        ret = ret + (seam,)
    return ret


# --------------------------------------------------------------------------
# the sweeps
# --------------------------------------------------------------------------

class StripWindows(NamedTuple):
    """Per-geometry neighbour-column tables on the device: perm (ncols,
    nnbr) int32 j-column of each offset (-1 for a plane edge with no
    neighbour), shift (ncols, nnbr, 2) float32 plane image shift."""
    perm: torch.Tensor
    shift: torch.Tensor


@functools.lru_cache(maxsize=64)
def _neighbor_tables(geom: StripGeometry, device: torch.device):
    """Per offset the neighbour column of every column (int64, 0 where
    there is none) and its valid mask, on ``device``: built once per
    geometry and device, so a rebuild copies no host table."""
    perms = [_plane_neighbor_perm(geom, ox, oy)
             for ox, oy in _neighbor_offsets(geom)]
    return (tuple(torch.as_tensor(p, dtype=torch.int64, device=device)
                  for p, _ in perms),
            tuple(torch.as_tensor(v, device=device) for _, v in perms))


def strip_windows(geom: StripGeometry, device) -> StripWindows:
    cidx = np.arange(geom.ncols)
    perm, shift = [], []
    for ox, oy in _neighbor_offsets(geom):
        p, valid = _plane_neighbor_perm(geom, ox, oy)
        perm.append(np.where(valid, p, -1))
        shift.append(np.stack(_plane_shift(geom, ox, oy, cidx), axis=1))
    return StripWindows(
        perm=torch.as_tensor(np.stack(perm, 1).astype(np.int32),
                             device=device),
        shift=torch.as_tensor(np.stack(shift, 1).astype(np.float32),
                              device=device))


# (row group, window row) candidates per column chunk of the plain sweep:
# bounds its memory at any pool size
_PLAIN_CHUNK = 1 << 24
_GROUP = 16  # i rows per bounding box of the plain sweep's prefilter


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v.flatten()[idx] in idx's shape (index_select on flat indices: far
    cheaper on the CPU than multi-tensor advanced indexing)."""
    return v.reshape(-1).index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _window_slots(win: StripWindows, delta, geom: StripGeometry, c0: int,
                  c1: int):
    """The kernels' candidate windows of columns [c0, c1): per (column,
    tile) the nnbr*W window rows in (offset kk, row) order, as (jslot,
    ok) of shape (k, ntiles, nnbr*W) — the j slot (0 where ``ok`` is
    false: a row outside its column, or no neighbour column) — and the
    plane image shift of each window row, (k, nnbr*W, 2)."""
    dev = win.perm.device
    cap, ts, W = geom.col_cap, geom.ts, geom.w
    nnbr, ntiles, t_blk = geom.nnbr, geom.ntiles, geom.t_blk
    k, M = c1 - c0, nnbr * W
    t = torch.arange(ntiles, device=dev)
    b, tt = t // t_blk, t % t_blk
    pm = win.perm[c0:c1].long()                               # (k, nnbr)
    bb = torch.clamp(b + delta[c0:c1].long()[:, :, b], 0,
                     geom.nblocks - 1)                        # (k, nnbr, T)
    lo = (bb * t_blk + tt) * ts - geom.ch * geom.mlo
    jrow = lo[..., None] + torch.arange(W, device=dev)        # (k,nnbr,T,W)
    ok = (jrow >= 0) & (jrow < cap) & (pm >= 0)[:, :, None, None]
    jslot = torch.where(ok, pm.clamp(min=0)[:, :, None, None] * cap + jrow,
                        0)
    jslot = jslot.permute(0, 2, 1, 3).reshape(k, ntiles, M)
    ok = ok.permute(0, 2, 1, 3).reshape(k, ntiles, M)
    return jslot, ok, win.shift[c0:c1].repeat_interleave(W, dim=1)


def _window_hits(fld, win: StripWindows, delta, geom: StripGeometry,
                 c0: int, c1: int, cutmax2: float):
    """(i slot, j slot, sx, sy, m) of every pair of columns [c0, c1) that
    the kernel's windows hold with 1e-12 < rsq < cutmax2; m is the j row's
    index in its tile's window (``_window_slots``' order: offset kk =
    m // W).

    A bounding-box prefilter drops, per group of _GROUP alive i rows,
    window rows whose distance to the group's box reaches the cutoff. It
    is exact: float32 subtraction, squaring and addition are monotone, so a
    pair's rsq, computed in the same order, is never below its group's box
    distance."""
    dev = fld.device
    cap, ts = geom.col_cap, geom.ts
    ntiles = geom.ntiles
    k, M, ng = c1 - c0, geom.nnbr * geom.w, ts // _GROUP
    jslot, ok, shift = _window_slots(win, delta, geom, c0, c1)
    t = torch.arange(ntiles, device=dev)
    islot = ((torch.arange(c0, c1, device=dev) * cap)[:, None, None, None]
             + (t * ts)[None, :, None, None]
             + torch.arange(ts, device=dev).reshape(ng, _GROUP))
    alive_i = _take(fld[RTYPE], islot) > 0.5                  # (k,T,ng,G)
    xs, d2 = [], None
    for axis in range(3):
        xj = _take(fld[RX + axis], jslot)
        if axis < 2:
            xj = xj + shift[:, None, :, axis]
        xi = _take(fld[RX + axis], islot)
        bmin = torch.where(alive_i, xi, float("inf")).amin(-1)[..., None]
        bmax = torch.where(alive_i, xi, float("-inf")).amax(-1)[..., None]
        gap = torch.maximum(torch.clamp(bmin - xj[:, :, None, :], min=0.0),
                            torch.clamp(xj[:, :, None, :] - bmax, min=0.0))
        d2 = gap * gap if d2 is None else d2 + gap * gap
        xs.append(xj)
    keep = (ok[:, :, None, :] & (d2 < cutmax2)).reshape(-1).nonzero()[:, 0]
    del d2
    group, m = keep // M, keep % M            # group = (a*T + t)*ng + g
    tile_m = (group // ng) * M + m            # flat index into (k, T, M)
    ii = islot.reshape(-1, _GROUP).index_select(0, group)     # (Q, G)
    rsq = None
    for axis in range(3):
        dx = _take(fld[RX + axis], ii) - _take(xs[axis], tile_m)[:, None]
        rsq = dx * dx if rsq is None else rsq + dx * dx
    hit = ((rsq > 1e-12) & (rsq < cutmax2)).reshape(-1).nonzero()[:, 0]
    q = hit // _GROUP
    col_m = (group // (ng * ntiles)) * M + m  # flat index into (k, M)
    sxy = shift.reshape(-1, 2).index_select(0, col_m.index_select(0, q))
    return (ii.reshape(-1).index_select(0, hit),
            _take(jslot, tile_m).index_select(0, q), sxy[:, 0], sxy[:, 1],
            m.index_select(0, q))


def _window_pairs(fld, win: StripWindows, delta, geom: StripGeometry,
                  c0: int, c1: int, cutmax2: float):
    """``_window_hits`` with the pair's neighbour-offset index kk in place
    of its window row."""
    pi, pj, psx, psy, m = _window_hits(fld, win, delta, geom, c0, c1,
                                       cutmax2)
    return pi, pj, psx, psy, m // geom.w


def _column_step(geom: StripGeometry) -> int:
    """Columns per chunk of a plain sweep (bounds its temporaries)."""
    return max(1, _PLAIN_CHUNK * _GROUP // (geom.col_cap * geom.nnbr
                                             * geom.w))


def sum_pairs(out: torch.Tensor, sweep: str, fld: torch.Tensor,
              sel: torch.Tensor, tabs: DeviceTables, spec: PhysicsSpec,
              r0: int, r1: int, pi, pj, psx, psy, out_rows=None) -> None:
    """Add the physics of ``tile_physics`` over the pair list (pi, pj,
    image shift (psx, psy)), whose i slots lie in [r0, r1), into the
    sweep's output rows of ``out`` (or ``out_rows``); ``sel`` is
    fld[_FIELD_ROWS[sweep]]."""
    rows = _FIELD_ROWS[sweep]
    h_rows = tile_physics.hoist_i(
        {r: fld[r, r0:r1] for r in rows}, tabs.tab1, spec, sweep)
    h = {key: v.index_select(0, pi - r0) for key, v in h_rows.items()}
    fi = dict(zip(rows, sel.index_select(1, pi)))
    fj = dict(zip(rows, sel.index_select(1, pj)))
    # the pair geometry, with the same formula as the filter
    dx = (fi[RX] - (fj[RX] + psx), fi[RY] - (fj[RY] + psy),
          fi[RZ] - fj[RZ])
    rsq_p = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    lk = tile_physics.Lookups(tabs.tab2, tabs.tab1, spec,
                              fi[RTYPE].long(), fj[RTYPE].long())
    parts = tile_physics.tile_part_sums(fi, fj, h, dx, rsq_p, lk, spec,
                                        sweep)
    for row, p in zip(out_rows or _OUT_ROWS[sweep], parts):
        out[row].index_add_(0, pi, p)


def plain_sweep(sweep: str, fld: torch.Tensor, tabs: DeviceTables,
                win: StripWindows, delta: torch.Tensor, geom: StripGeometry,
                spec: PhysicsSpec) -> torch.Tensor:
    """The plain PyTorch version of one strip sweep, on any device.

    Same contract as the CUDA kernel: for i-slot s of column c, tile t =
    (s mod col_cap) / ts and block b = t / t_blk, the j rows of offset kk
    are those of tile bb*t_blk + t mod t_blk of column perm[c, kk], where
    bb = clip(b + delta[c, kk, b], 0, nblocks-1), over the rank window
    [ts*t' - ch*mlo, ts*t' + ts + ch*mhi) with rows outside the column
    skipped; positions take the plane image shift. Pairs with rsq <= 1e-12
    or beyond the sweep's largest cutoff are dropped first
    (``_window_pairs``), then the physics of ``tile_physics`` runs on the
    surviving pair list (``sum_pairs``). Returns the (8, n_slots) output
    matrix with the sweep's O* rows filled."""
    dev = fld.device
    n, cap = geom.n_slots, geom.col_cap
    out = torch.zeros(8, n, dtype=torch.float32, device=dev)
    cstep = _column_step(geom)
    sel = fld[list(_FIELD_ROWS[sweep])]                       # (R, n)
    for c0 in range(0, geom.ncols, cstep):
        c1 = min(c0 + cstep, geom.ncols)
        pi, pj, psx, psy, _ = _window_pairs(fld, win, delta, geom, c0, c1,
                                            tabs.cutmax2[sweep])
        # the kernel skips the capillary terms on tiles flagged <= 0.25;
        # they are exactly zero there (every candidate's colour gradient
        # is), so computing them here gives the same sums
        sum_pairs(out, sweep, fld, sel, tabs, spec, c0 * cap, c1 * cap, pi,
                  pj, psx, psy)
    if sweep == "rho":
        out[ORHO] += tile_physics.rho_self(fld, tabs.tab2, spec)
    elif sweep == "cgrad":
        # tiles whose candidate region holds one phase write zeros
        mixed = fld[RMIX] > 0.75
        for row in (OCGX, OCGY, ODE):
            out[row] = torch.where(mixed, out[row], 0.0)
    return out


def _warp_ids(slots: torch.Tensor, geom: StripGeometry) -> torch.Tensor:
    """The CUDA sweeps' warp of each i slot: 32 consecutive threads of a
    block of t_blk * ts rows, numbered over (column, block, warp)."""
    brows = geom.block_rows
    wpb = -(-brows // 32)
    return (slots // brows) * wpb + (slots % brows) // 32


def _warp_boxes(fld, geom: StripGeometry, c0: int, c1: int, rc: float,
                active=None):
    """Per warp of columns [c0, c1): the strip kernels' filter — the
    bounding box (lo, hi) of the warp's alive rows (of its ``active`` rows
    where given, an (n_slots,) mask), (warps, 3), and rp^2 with rp = rc +
    1e-5 * (rc + the box's largest coordinate magnitude), float32, each
    operation rounded once — whether the warp has such a row, and the
    first and last tile of its rows."""
    dev = fld.device
    brows, cap = geom.block_rows, geom.col_cap
    wpb = -(-brows // 32)
    nw = (c1 - c0) * geom.nblocks * wpb
    rows = torch.arange(c0 * cap, c1 * cap, device=dev)
    wid = _warp_ids(rows, geom) - _warp_ids(rows[:1], geom)
    alive = (fld[RTYPE] > 0.5 if active is None else active)[
        c0 * cap:c1 * cap]
    big = torch.tensor(float("inf"), device=dev)
    lo = torch.empty(nw, 3, device=dev)
    hi = torch.empty(nw, 3, device=dev)
    for a in range(3):
        x = fld[RX + a, c0 * cap:c1 * cap]
        lo[:, a] = torch.full((nw,), float("inf"), device=dev).scatter_reduce(
            0, wid, torch.where(alive, x, big), "amin")
        hi[:, a] = torch.full((nw,), -float("inf"), device=dev
                              ).scatter_reduce(0, wid, torch.where(
                                  alive, x, -big), "amax")
    has = torch.zeros(nw, dtype=torch.int32, device=dev).scatter_reduce(
        0, wid, alive.int(), "amax") > 0
    first = (torch.arange(nw, device=dev) % wpb) * 32
    last = torch.clamp(first + 31, max=brows - 1)
    return (lo, hi, box_r2(lo, hi, rc), has, first // geom.ts,
            last // geom.ts)


def box_r2(lo: torch.Tensor, hi: torch.Tensor, rc: float) -> torch.Tensor:
    """The kernels' filter radius squared of boxes (lo, hi), (B, 3): rp^2
    with rp = rc + 1e-5 * (rc + the box's largest coordinate magnitude),
    each float32 operation rounded once (csrc/warp_filter.cuh,
    WarpBox::set_radius). A box with no alive row (bounds at +-inf) gets
    an infinite radius: the counts leave such boxes out."""
    dev = lo.device
    rc32 = torch.tensor(rc, dtype=torch.float32, device=dev)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(1)
    rp = rc32 + torch.tensor(1e-5, dtype=torch.float32, device=dev) * (
        rc32 + mag)
    return rp * rp


def _box_d2(x, y, z, lo, hi):
    """Squared distance of (x, y, z) to the box [lo, hi], in the kernels'
    float32 order: (gx*gx + gy*gy) + gz*gz, gaps max(lo - x, x - hi, 0)."""
    g = [torch.clamp(torch.maximum(lo[a] - v, v - hi[a]), min=0.0)
         for a, v in enumerate((x, y, z))]
    return (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]


def warp_pass_counts(fld: torch.Tensor, win: StripWindows,
                     delta: torch.Tensor, geom: StripGeometry,
                     cut2: float, colors: torch.Tensor | None = None
                     ) -> dict:
    """The counts that decide the strip rho / force kernels' design, on any
    device; used by chip_smoke.py and the tests, never on the main path.
    With ``colors``, the (T1,) colour of each type (tab1's colour row),
    the colour-gradient kernel's counts instead (``_gated_pass_counts``:
    its rows are those of mixed tiles, its gate the colour gate).

    Over the alive i rows (seam ghosts included: the kernels sum them) and
    the warps of 32 rows that hold one:
      candidates      window rows tested per row in the one-pass scan: the
                      nnbr*W rows of each tile's windows inside their column;
      box_survivors   (warp, offset, row) where a row of the warp's union
                      window lies within the cutoff (and a rounding margin)
                      of the warp's box: the rows phase (a) passes to the
                      per-lane test (b);
      live_pairs      (i, j) with 1e-12 < rsq < cut2 (``_window_pairs``);
      old_passes      pair-body passes of the lockstep scan: (warp, offset,
                      row) where any of the warp's rows has a live pair;
      list_passes     pair-body passes with per-lane lists, each lane
                      running its own: per warp and offset the longest
                      lane list, summed;
      queue_passes    pair-body passes of the kernels' warp pair queue:
                      per warp and offset ceil(live pairs / 32), summed;
      live_outside_box  live pairs whose j row is not a box survivor of i's
                      warp (0: the filter is conservative)."""
    if colors is not None:
        from tpusph_torch.ops.cell_filter import _gate
        cols = colors.to(fld.device, torch.float32)
        return _gated_pass_counts(
            fld, win, delta, geom, cut2,
            (fld[RTYPE] > 0.5) & (fld[RMIX] > 0.75),
            lambda present: _gate(present, cols),
            lambda ti, tj: cols[ti] != cols[tj], cols.numel())
    dev = fld.device
    cap, ts, W, nnbr = geom.col_cap, geom.ts, geom.w, geom.nnbr
    t_blk, ch = geom.t_blk, geom.ch
    wpb = -(-geom.block_rows // 32)
    rc = float(np.sqrt(np.float32(cut2)))
    cut2 = float(np.float32(cut2))
    counts = dict(rows=0, warps=0, candidates=0, box_survivors=0,
                  live_pairs=0, old_passes=0, list_passes=0, queue_passes=0,
                  live_outside_box=0)
    # rows of a warp's union window: its tiles' windows, W + (tiles - 1) ts
    wu = W + ts * ((32 + ts - 2) // ts)
    cstep = max(1, _PLAIN_CHUNK // (geom.nblocks * wpb * nnbr * wu))
    cstep = min(cstep, _column_step(geom))
    alive = fld[RTYPE] > 0.5
    for c0 in range(0, geom.ncols, cstep):
        c1 = min(c0 + cstep, geom.ncols)
        k = c1 - c0
        lo, hi, r2, has, tA, tB = _warp_boxes(fld, geom, c0, c1, rc)
        nw = lo.shape[0]
        w0 = _warp_ids(torch.tensor([c0 * cap], device=dev), geom)
        # the one-pass scan's candidates: per tile, its window rows inside
        # the column, times the tile's alive rows
        _, ok, _ = _window_slots(win, delta, geom, c0, c1)
        a_tile = alive[c0 * cap:c1 * cap].reshape(k, geom.ntiles, ts).sum(-1)
        counts["rows"] += int(a_tile.sum())
        counts["candidates"] += int((ok.sum(-1) * a_tile).sum())
        counts["warps"] += int(has.sum())
        # phase (a): each warp's union window against its box
        wblk = torch.arange(nw, device=dev) // wpb           # (c, block)
        col, b = wblk // geom.nblocks + c0, wblk % geom.nblocks
        pm = win.perm[col].long()                            # (nw, nnbr)
        bb = torch.clamp(b[:, None] + delta[col, :, b].long(), 0,
                         geom.nblocks - 1)                   # (nw, nnbr)
        ulo = torch.clamp((bb * t_blk + tA[:, None]) * ts - ch * geom.mlo,
                          min=0)
        uhi = torch.clamp((bb * t_blk + tB[:, None]) * ts + ts
                          + ch * geom.mhi, max=cap)
        jrow = ulo[..., None] + torch.arange(wu, device=dev)  # (nw,nnbr,wu)
        inwin = (jrow < uhi[..., None]) & (pm >= 0)[..., None] \
            & has[:, None, None]
        jslot = torch.where(inwin, pm.clamp(min=0)[..., None] * cap + jrow, 0)
        sh = win.shift[col]                                  # (nw, nnbr, 2)
        xj = [_take(fld[RX + a], jslot) for a in range(3)]
        xj[0], xj[1] = xj[0] + sh[..., 0:1], xj[1] + sh[..., 1:2]
        d2 = _box_d2(*xj, [v[:, None, None] for v in lo.T],
                     [v[:, None, None] for v in hi.T])
        counts["box_survivors"] += int((inwin & (d2 < r2[:, None, None])
                                        ).sum())
        # the live pairs, and which of them phase (a) passes
        pi, pj, psx, psy, kk = _window_pairs(fld, win, delta, geom, c0, c1,
                                             cut2)
        counts["live_pairs"] += pi.numel()
        wi = _warp_ids(pi, geom) - w0
        d2 = _box_d2(fld[RX].index_select(0, pj) + psx,
                     fld[RY].index_select(0, pj) + psy,
                     fld[RZ].index_select(0, pj), lo[wi].T, hi[wi].T)
        counts["live_outside_box"] += int((d2 >= r2[wi]).sum())
        # body passes: lockstep (distinct live rows per warp and offset),
        # lane lists (the longest per warp and offset) and the queue
        key = (wi * nnbr + kk) * geom.n_slots + pj
        counts["old_passes"] += int(torch.unique(key).numel())
        lane_key, lane_n = torch.unique(pi * nnbr + kk, return_counts=True)
        wk = _warp_ids(lane_key // nnbr, geom) - w0
        longest = torch.zeros(nw * nnbr, dtype=lane_n.dtype, device=dev
                              ).scatter_reduce(0, wk * nnbr + lane_key % nnbr,
                                               lane_n, "amax")
        counts["list_passes"] += int(longest.sum())
        per_wk = torch.bincount(wi * nnbr + kk, minlength=nw * nnbr)
        counts["queue_passes"] += int(((per_wk + 31) // 32).sum())
    return counts


def vapor_pass_counts(fld: torch.Tensor, win: StripWindows,
                      delta: torch.Tensor, geom: StripGeometry, vtype: int,
                      cut: float) -> dict:
    """The counts of the vapor kernel's phases (``_gated_pass_counts``
    under its type gate — a j row is a candidate when its type lies in
    (vtype - 0.5, vtype + 0.5) — and the vapor's cutoff), on any device;
    used by chip_smoke.py and the tests, never on the main path. ``fld``
    as ``VaporKernel`` takes it."""
    T1 = max(int(fld[RTYPE].max()), vtype) + 1
    tv = torch.arange(T1, device=fld.device) == vtype
    return _gated_pass_counts(
        fld, win, delta, geom, _vapor_cut2(cut), fld[RTYPE] > 0.5,
        lambda present: tv.expand(present.shape[0], T1),
        lambda ti, tj: tj == vtype, T1)


def _gated_pass_counts(fld, win: StripWindows, delta, geom: StripGeometry,
                       cut2: float, active: torch.Tensor, keep, need,
                       T1: int) -> dict:
    """The counts of a gated strip kernel's phases (the colour gradient's
    and the vapor's, ``csrc/strip_sweeps.cu``), on any device. The kernel
    forms the sums of the ``active`` (n_slots,) rows; a block of them (and
    each warp) keeps the window rows of the types ``keep(present)`` gives
    for the (B, T1) set of its active rows' types (the gate, a (B, T1)
    mask); ``need(ti, tj)`` says which of the live pairs add anything.
    A block stages, per neighbour column, its union window, each row a
    candidate when it is alive, kept by the block's gate and inside the
    block's box (the union of its warps' boxes of active rows, radius
    sqrt(cut2)); each warp then tests the candidates against its own box
    and gate. Over the active rows and the blocks and warps that hold one:
      rows / warps / blocks   active rows, warps and blocks with one;
      gate_exits      active blocks with no candidate in any neighbour
                      column (they skip every one);
      candidates      window rows each active row tests in the one-pass
                      scan (nnbr*W per row, inside the column);
      staged_rows     window rows the active blocks read at staging, and
                      staged_with_terms those staged as candidates;
      box_survivors   (warp, offset, row) candidates inside the warp's box
                      and kept by its gate;
      live_pairs      (i, j), i active, with 1e-12 < rsq < cut2, and
                      needed_pairs those ``need`` keeps;
      old_passes      (warp, offset, row) where any lane has a live pair
                      (the lockstep scan's body passes);
      body_passes     those among the box survivors (the kernel's);
      live_outside_box  needed pairs whose j row fails the block's or the
                      warp's box or gate (0: the filter is conservative)."""
    dev = fld.device
    cap, ts, nnbr = geom.col_cap, geom.ts, geom.nnbr
    t_blk, ch, brows, nbk = geom.t_blk, geom.ch, geom.block_rows, \
        geom.nblocks
    wpb = -(-brows // 32)
    rc = float(np.sqrt(np.float32(cut2)))
    cut2 = float(np.float32(cut2))
    counts = dict(rows=0, warps=0, blocks=0, gate_exits=0, candidates=0,
                  staged_rows=0, staged_with_terms=0, box_survivors=0,
                  live_pairs=0, needed_pairs=0, old_passes=0,
                  body_passes=0, live_outside_box=0)
    bu = max(brows + ch * (geom.mlo + geom.mhi), 1)  # block union window
    wu = geom.w + ts * ((32 + ts - 2) // ts)         # a warp's, at most
    cstep = max(1, _PLAIN_CHUNK // (nbk * wpb * nnbr * max(bu, wu)))
    cstep = min(cstep, _column_step(geom))
    alive = fld[RTYPE] > 0.5
    typ = fld[RTYPE].long().clamp(0, T1 - 1)

    def staged_at(jslot, sh):
        """Positions of window rows (jslot) under their plane shifts."""
        xj = [_take(fld[RX + a], jslot) for a in range(3)]
        return [xj[0] + sh[..., 0:1], xj[1] + sh[..., 1:2], xj[2]]

    def inside(xj, lo, hi, r2):
        return _box_d2(*xj, [v[:, None, None] for v in lo.T],
                       [v[:, None, None] for v in hi.T]) < r2[:, None, None]

    for c0 in range(0, geom.ncols, cstep):
        c1 = min(c0 + cstep, geom.ncols)
        k = c1 - c0
        nb = k * nbk
        lo, hi, r2, has, tA, tB = _warp_boxes(fld, geom, c0, c1, rc, active)
        nw = lo.shape[0]
        w0 = _warp_ids(torch.tensor([c0 * cap], device=dev), geom)
        # the gates and boxes of the warps and of the blocks
        rows = torch.arange(c0 * cap, c1 * cap, device=dev)
        wid = _warp_ids(rows, geom) - w0
        act = active[c0 * cap:c1 * cap]
        present = torch.zeros(nw * T1, dtype=torch.bool, device=dev)
        present[(wid * T1 + typ[rows])[act]] = True
        present = present.reshape(nw, T1)
        wkeep = keep(present)
        bkeep = keep(present.reshape(nb, wpb, T1).any(1))
        blo = lo.reshape(nb, wpb, 3).amin(1)
        bhi = hi.reshape(nb, wpb, 3).amax(1)
        br2 = box_r2(blo, bhi, rc)
        bhas = has.reshape(nb, wpb).any(1)
        a_tile = act.reshape(k, geom.ntiles, ts).sum(-1)
        _, ok, _ = _window_slots(win, delta, geom, c0, c1)
        counts["rows"] += int(a_tile.sum())
        counts["candidates"] += int((ok.sum(-1) * a_tile).sum())
        counts["warps"] += int(has.sum())
        counts["blocks"] += int(bhas.sum())

        def block_cand(blk, jslot, xj):
            """Whether each window row is a candidate of block ``blk``."""
            kept = bkeep[blk[:, None, None], typ[jslot]]
            return alive[jslot] & kept & inside(xj, blo[blk], bhi[blk],
                                                br2[blk])

        # staging: each active block's union window per neighbour column
        bidx = torch.arange(nb, device=dev)
        col, b = bidx // nbk + c0, bidx % nbk
        pm = win.perm[col].long()                            # (nb, nnbr)
        bb = torch.clamp(b[:, None] + delta[col, :, b].long(), 0, nbk - 1)
        ulo = torch.clamp(bb * brows - ch * geom.mlo, min=0)
        uhi = torch.clamp((bb + 1) * brows + ch * geom.mhi, max=cap)
        jrow = ulo[..., None] + torch.arange(bu, device=dev)
        inwin = (jrow < uhi[..., None]) & (pm >= 0)[..., None] \
            & bhas[:, None, None]
        jslot = torch.where(inwin, pm.clamp(min=0)[..., None] * cap + jrow, 0)
        cand = inwin & block_cand(bidx, jslot, staged_at(jslot,
                                                         win.shift[col]))
        counts["staged_rows"] += int(inwin.sum())
        counts["staged_with_terms"] += int(cand.sum())
        counts["gate_exits"] += int((bhas & ~cand.any(2).any(1)).sum())
        # each active warp's union window against its box and gate
        wblk = torch.arange(nw, device=dev) // wpb
        col, b = wblk // nbk + c0, wblk % nbk
        pm = win.perm[col].long()
        bb = torch.clamp(b[:, None] + delta[col, :, b].long(), 0, nbk - 1)
        ulo = torch.clamp((bb * t_blk + tA[:, None]) * ts - ch * geom.mlo,
                          min=0)
        uhi = torch.clamp((bb * t_blk + tB[:, None]) * ts + ts
                          + ch * geom.mhi, max=cap)
        jrow = ulo[..., None] + torch.arange(wu, device=dev)
        inwin = (jrow < uhi[..., None]) & (pm >= 0)[..., None] \
            & has[:, None, None]
        jslot = torch.where(inwin, pm.clamp(min=0)[..., None] * cap + jrow, 0)
        xj = staged_at(jslot, win.shift[col])
        surv = (inwin & block_cand(wblk, jslot, xj)
                & wkeep[torch.arange(nw, device=dev)[:, None, None],
                        typ[jslot]]
                & inside(xj, lo, hi, r2))
        counts["box_survivors"] += int(surv.sum())
        # the live pairs of the active rows, and which of them phase (a)
        # passes
        pi, pj, psx, psy, kk = _window_pairs(fld, win, delta, geom, c0, c1,
                                             cut2)
        sel = active.index_select(0, pi)
        pi, pj, psx, psy, kk = (t[sel] for t in (pi, pj, psx, psy, kk))
        ti, tj = typ.index_select(0, pi), typ.index_select(0, pj)
        needed = need(ti, tj)
        counts["live_pairs"] += pi.numel()
        counts["needed_pairs"] += int(needed.sum())
        wi = _warp_ids(pi, geom) - w0
        bi = wi // wpb
        pos = [fld[RX].index_select(0, pj) + psx,
               fld[RY].index_select(0, pj) + psy, fld[RZ].index_select(0, pj)]
        kept = (alive.index_select(0, pj) & bkeep[bi, tj] & wkeep[wi, tj]
                & (_box_d2(*pos, blo[bi].T, bhi[bi].T) < br2[bi])
                & (_box_d2(*pos, lo[wi].T, hi[wi].T) < r2[wi]))
        counts["live_outside_box"] += int((needed & ~kept).sum())
        key = (wi * nnbr + kk) * geom.n_slots + pj
        counts["old_passes"] += int(torch.unique(key).numel())
        counts["body_passes"] += int(torch.unique(key[kept]).numel())
    return counts


def _window_checks(fld, win: StripWindows, delta, geom: StripGeometry):
    return (("fld", fld, (F_ROWS, geom.n_slots), torch.float32),
            ("perm", win.perm, (geom.ncols, geom.nnbr), torch.int32),
            ("shift", win.shift, (geom.ncols, geom.nnbr, 2), torch.float32),
            ("delta", delta, (geom.ncols, geom.nnbr, geom.nblocks),
             torch.int32))


def _geom_ints(geom: StripGeometry) -> dict:
    return dict(n_slots=geom.n_slots, ncols=geom.ncols, col_cap=geom.col_cap,
                ts=geom.ts, ch=geom.ch, t_blk=geom.t_blk,
                nblocks=geom.nblocks, mlo=geom.mlo, mhi=geom.mhi,
                nnbr=geom.nnbr)


class SweepKernel(cuda_build.LaunchCount):
    """Wrapper of one CUDA strip sweep (``launcher`` rho, cgrad or force),
    or of the one-pass colour-gradient scan (cgrad_scan), the check kernel
    on no path.

    Replaces ``tpusph.ops.strip_pair.make_strip_kernel(sweep=...)`` (the
    ``pl.pallas_call`` at strip_pair.py:1233). CPU tensors take the plain
    version (``plain_sweep``); CUDA tensors launch the kernel or raise.
    ``launches`` and ``by_card`` count kernel launches only.

    On the card the sweeps are bound by instruction throughput over the
    live pairs, a few percent of the nnbr*W window rows (2.3k-4.6k at the
    1M bench geometry) each i row's windows hold. Each block stages its
    union window once per neighbour column in shared memory, with the
    per-j terms (EOS, 1/rho, tension norms) computed there, and the
    smoothing kernels' per type-pair constants once per block. The sweeps
    then filter before they compute (``csrc/strip_sweeps.cu``): a warp
    tests each window row once against the bounding box of its 32 rows
    (distance below the cutoff), each lane tests the box's survivors
    exactly, rho and the colour gradient add a live pair at once, and
    force queues the warp's live pairs and runs them 32 a pass, each lane
    on any row's pair, each row adding its pairs in the one-pass scan's
    order (the same bits): the body's passes follow the warp's live pairs
    / 32 rather than every row any lane needs. The colour gradient, which
    sums the rows of mixed tiles only, also gates: a block stages as
    candidates only rows of a colour unlike one of its rows' and inside
    its box, skips a neighbour column with none, and each warp's box test
    applies its own gate. ``warp_pass_counts`` gives those counts on a
    layout. The registers, the shared memory and the measured times are in
    PERF.md.
    """

    def __init__(self, sweep: str, launcher: str | None = None):
        self.sweep = sweep
        self.launcher = launcher or sweep
        super().__init__()

    def __call__(self, fld: torch.Tensor, tabs: DeviceTables,
                 win: StripWindows, delta: torch.Tensor,
                 geom: StripGeometry, spec: PhysicsSpec) -> torch.Tensor:
        n, T1 = geom.n_slots, tabs.tab1.shape[1]
        check_inputs(f"{self.sweep} sweep", fld, _window_checks(
            fld, win, delta, geom) + (
                ("tab2", tabs.tab2, (8, T1, T1), torch.float32),
                ("tab1", tabs.tab1, (5, T1), torch.float32)))
        if fld.device.type == "cpu":
            return plain_sweep(self.sweep, fld, tabs, win, delta, geom, spec)
        out = torch.zeros(8, n, dtype=torch.float32, device=fld.device)
        cuda_build.launch(
            self.launcher, fld, win.perm, win.shift, delta, tabs.tab2,
            tabs.tab1, out, dim=geom.dim, kernel=spec.kernel,
            flags=spec_flags(spec), T1=T1, cutmax2=tabs.cutmax2[self.sweep],
            **_geom_ints(geom))
        self.count(fld.device)
        return out


rho_sweep = SweepKernel("rho")
cgrad_sweep = SweepKernel("cgrad")
force_sweep = SweepKernel("force")
SWEEPS = {"rho": rho_sweep, "cgrad": cgrad_sweep, "force": force_sweep}
cgrad_scan = SweepKernel("cgrad", "cgrad_scan")


# --------------------------------------------------------------------------
# the vapor sweep (fix phase_change interface query)
# --------------------------------------------------------------------------

VAPOR_BIG = 1e30   # rsq of "no candidate" in the vapor sweep's output


def _vapor_cut2(cut: float) -> float:
    """cut^2 as the float32 both versions compare rsq against."""
    return float(np.float32(cut * cut))


def _lex_argmin(pi: torch.Tensor, rsq: torch.Tensor, kk: torch.Tensor,
                sl: torch.Tensor, n: int):
    """Per row r of [0, n): (slot, rsq) of the pair that is the
    lexicographic minimum of (rsq, kk, slot) over the pairs with pi == r;
    (0, VAPOR_BIG) for a row with none."""
    dev = rsq.device
    mn = torch.full((n,), VAPOR_BIG, dtype=torch.float32, device=dev
                    ).scatter_reduce_(0, pi, rsq, "amin")
    tie = rsq == mn.index_select(0, pi)
    kmin = torch.full((n,), 1 << 30, dtype=kk.dtype, device=dev
                      ).scatter_reduce_(0, pi[tie], kk[tie], "amin")
    tie &= kk == kmin.index_select(0, pi)
    slot = torch.full((n,), VAPOR_BIG, dtype=torch.float32, device=dev
                      ).scatter_reduce_(0, pi[tie], sl[tie], "amin")
    slot = torch.where(mn < VAPOR_BIG, slot, 0.0)
    return slot, mn


def plain_vapor_sweep(fld: torch.Tensor, win: StripWindows,
                      delta: torch.Tensor, geom: StripGeometry, vtype: int,
                      cut: float) -> torch.Tensor:
    """The plain PyTorch version of the vapor sweep, on any device.

    Same windows as ``plain_sweep``. A pair is live when i is alive, j has
    type ``vtype``, and 1e-12 < rsq < cut^2, with rsq = (dx0*dx0 +
    dx1*dx1) + dx2*dx2 and dx = x_i - (x_j + image shift) — the kernel's
    formula and order, so both give the same rsq bit for bit. Field row
    RSLOT holds each slot sign-encoded: slot for an owned row, -(slot+1)
    for a seam ghost. Returns the (8, n_slots) output matrix:

      ORHO  count of live pairs          (0 with none)
      OCGX  nearest j's slot             (0)
      OCGY  nearest j's rsq              (VAPOR_BIG)
      OFX   nearest owned j's slot       (0)
      OFY   nearest owned j's rsq        (VAPOR_BIG)

    Tie rule (the TPU kernel's, strip_pair.py:1307-1318): per neighbour
    offset the smallest slot among the rows at the minimum rsq, and across
    offsets a strictly smaller rsq replaces the running best. The nearest
    is therefore the lexicographic minimum of (rsq, offset index kk,
    slot), and the nearest owned one the same over slot_enc >= 0."""
    dev = fld.device
    n, cap = geom.n_slots, geom.col_cap
    cut2 = _vapor_cut2(cut)
    out = torch.zeros(8, n, dtype=torch.float32, device=dev)
    out[OCGY] = VAPOR_BIG
    out[OFY] = VAPOR_BIG
    cstep = _column_step(geom)
    for c0 in range(0, geom.ncols, cstep):
        c1 = min(c0 + cstep, geom.ncols)
        pi, pj, psx, psy, kk = _window_pairs(fld, win, delta, geom, c0, c1,
                                             cut2)
        tj = fld[RTYPE].index_select(0, pj)
        keep = ((tj > vtype - 0.5) & (tj < vtype + 0.5)
                & (fld[RTYPE].index_select(0, pi) > 0.5))
        pi, pj, psx, psy, kk = (t[keep] for t in (pi, pj, psx, psy, kk))
        dx = [fld[RX + a].index_select(0, pi)
              - (fld[RX + a].index_select(0, pj) + s)
              for a, s in ((0, psx), (1, psy))]
        dx.append(fld[RZ].index_select(0, pi) - fld[RZ].index_select(0, pj))
        rsq = (dx[0] * dx[0] + dx[1] * dx[1]) + dx[2] * dx[2]
        live = (rsq > 1e-12) & (rsq < cut2)
        r0, m = c0 * cap, (c1 - c0) * cap
        li = pi[live] - r0
        rsq, kk, enc = rsq[live], kk[live], fld[RSLOT].index_select(
            0, pj[live])
        sl = torch.where(enc >= 0, enc, -enc - 1.0)
        out[ORHO, r0:r0 + m] = torch.zeros(m, device=dev).index_add_(
            0, li, torch.ones_like(rsq))
        out[OCGX, r0:r0 + m], out[OCGY, r0:r0 + m] = _lex_argmin(
            li, rsq, kk, sl, m)
        own = enc >= 0
        out[OFX, r0:r0 + m], out[OFY, r0:r0 + m] = _lex_argmin(
            li[own], rsq[own], kk[own], sl[own], m)
    return out


class VaporKernel(cuda_build.LaunchCount):
    """Wrapper of the CUDA vapor sweep (``launcher`` vapor), or of its
    one-pass scan (vapor_scan), the check kernel on no path.

    Replaces ``tpusph.ops.strip_pair.make_vapor_kernel`` (the
    ``pl.pallas_call`` at strip_pair.py:1348). CPU tensors take the plain
    version (``plain_vapor_sweep``); CUDA tensors launch the kernel or
    raise. ``launches`` and ``by_card`` count kernel launches only. The
    kernel writes the five output rows of every slot (0 / VAPOR_BIG where
    there is no vapour neighbour).

    On the card only the pairs with a vapour row within the cutoff add
    anything, and the vapour rows are a small part of any window. The
    kernel (``csrc/strip_sweeps.cu``) stages a window row as a candidate
    only when it is of type ``vtype`` and inside the box of the block's
    alive rows (radius the cutoff), skips a neighbour column with none,
    then tests the candidates against each warp's box and each lane's
    exact rsq; both running argmins live in registers.
    ``vapor_pass_counts`` gives those counts on a layout."""

    def __init__(self, launcher: str = "vapor"):
        self.launcher = launcher
        super().__init__()

    def __call__(self, fld: torch.Tensor, win: StripWindows,
                 delta: torch.Tensor, geom: StripGeometry, vtype: int,
                 cut: float) -> torch.Tensor:
        check_inputs("vapor sweep", fld,
                      _window_checks(fld, win, delta, geom))
        n = geom.n_slots
        if n >= 1 << 24:
            raise ValueError(f"vapor sweep: {n} slots; slots travel as "
                             "float32 and must stay below 2**24")
        if cut > geom.margin_dist + 1e-9:
            raise ValueError(f"vapor sweep: cut {cut} beyond the windows' "
                             f"reach {geom.margin_dist}")
        if fld.device.type == "cpu":
            return plain_vapor_sweep(fld, win, delta, geom, vtype, cut)
        out = torch.zeros(8, n, dtype=torch.float32, device=fld.device)
        cuda_build.launch_vapor(self.launcher, fld, win.perm, win.shift,
                                delta, out, vtype=int(vtype),
                                cut2=_vapor_cut2(cut), **_geom_ints(geom))
        self.count(fld.device)
        return out


vapor_sweep = VaporKernel()
vapor_scan = VaporKernel("vapor_scan")
# every kernel wrapper of the strip backend, by name (launch counts), and
# the one-pass check kernels, which no path launches
KERNELS = {**SWEEPS, "vapor": vapor_sweep}
SCANS = {"cgrad": cgrad_scan, "vapor": vapor_scan}


def _window_reduce(arr: torch.Tensor, k: int, op, fill: float
                   ) -> torch.Tensor:
    """``op`` (``torch.maximum`` / ``torch.minimum``) over every k
    consecutive chunks of each row of ``arr`` (ncols, n), padded with k
    ``fill`` chunks on both sides: (ncols, n + k + 1), entry p reduces
    padded chunks [p, p + k), i.e. chunks [p - k, p) of ``arr``. A window
    that starts at or below -k or at or above n holds fill alone. Doubling:
    ceil(log2 k) ops; overlapping halves are harmless (op is idempotent)."""
    m = torch.nn.functional.pad(arr, (k, k), value=fill)
    span = 1
    while 2 * span <= k:
        m = op(m[:, :-span], m[:, span:])
        span *= 2
    if span < k:
        m = op(m[:, :span - k], m[:, k - span:])
    return m


# --------------------------------------------------------------------------
# backend
# --------------------------------------------------------------------------

class StripBackend(BandBackend):
    """Strip backend: the rebuild, the per-step seam refresh, and the
    three sweeps over the strip layout; the pool resize and the fused force
    stage are the band backend's. Single device."""

    name = "strip"

    def __init__(self, geom: StripGeometry, ntypes: int,
                 rebuild_every: int = 0, device="cpu"):
        super().__init__(geom, ntypes, rebuild_every)
        self.win = strip_windows(geom, device)
        # the mixed flag's per-geometry tables: each offset's neighbour
        # column (valid mask; base row of its reduced chunks), and each
        # tile's window start before ``delta``, as (nblocks, t_blk), in the
        # reduced rows (``_window_reduce``)
        k = geom.mlo + geom.stride + geom.mhi
        perm = self.win.perm.transpose(0, 1).long()[..., None, None]
        self._mix_valid = (perm >= 0).reshape(geom.nnbr, geom.ncols, 1)
        self._mix_base = perm.clamp(min=0) * (geom.n32 + k + 1)
        t = torch.arange(geom.ntiles, device=perm.device)
        self._mix_t0 = (geom.stride * t - geom.mlo + k).reshape(
            geom.nblocks, geom.t_blk)

    def _sweep(self, sweep, fld, tabs, spec, aux):
        return SWEEPS[sweep](fld, tabs, self.win, aux.delta, self.geom, spec)

    def _mixed_flags(self, type_f: torch.Tensor, aux: GridData):
        """(n_slots,) f32 three-valued flag per tile (see the reference's
        ``StripBackend._mixed_flags``): 1.0 — the tile's candidate region
        holds more than one phase (the cgrad sweep runs); 0.5 — one phase,
        but some candidate tile is mixed (the force sweep keeps its
        capillary terms); 0.0 — no mixed tile within one window reach
        (capillary terms are exactly zero).

        The reference loops over the window's chunks and the neighbour
        offsets inside ``jit``; here each window reduction is a doubling
        max / min over the chunk axis (``_window_reduce``) and one gather
        of every (offset, column, tile) window start, so the operator count
        does not grow with the window's chunk count. Max and min pick one
        of their inputs, so the flag is the reference's bit for bit."""
        geom = self.geom
        ty = type_f.reshape(geom.ncols, geom.n32, geom.ch)
        tmax_c = ty.amax(dim=2)
        tmin_c = torch.where(ty > 0, ty, 99.0).amin(dim=2)
        # per (offset, column, tile) flat start of the window in the
        # reduced rows of the offset's neighbour column
        k = geom.mlo + geom.stride + geom.mhi
        dch = aux.delta.long().transpose(0, 1)[..., None] * (
            geom.block_rows // geom.ch)
        start = torch.clamp(self._mix_t0 + dch, 0, geom.n32 + k)
        idx = (self._mix_base + start).reshape(-1)

        def win_pass(arr, op, fill):
            red = _window_reduce(arr, k, op, fill)
            v = red.reshape(-1).index_select(0, idx).reshape(
                geom.nnbr, geom.ncols, geom.ntiles)
            v = torch.where(self._mix_valid, v, fill)
            return v.amax(dim=0) if op is torch.maximum else v.amin(dim=0)

        gmax = win_pass(tmax_c, torch.maximum, 0.0)
        gmin = win_pass(tmin_c, torch.minimum, 99.0)
        mixed = (gmax > gmin + 0.5) & (gmin < 90.0)
        mixed_c = mixed.to(torch.float32).repeat_interleave(geom.stride,
                                                            dim=1)
        st_need = win_pass(mixed_c, torch.maximum, 0.0)
        flag = torch.maximum(mixed.to(torch.float32),
                             0.5 * (st_need > 0.5).to(torch.float32))
        return flag.reshape(-1).repeat_interleave(geom.ts)

    def _attach_mix(self, state: ParticleState, aux: GridData) -> GridData:
        """The mixed-phase flag, once per rebuild (types change only at a
        rebuild on this slice)."""
        return dataclasses.replace(
            aux, mix=self._mixed_flags(state.type.to(torch.float32), aux))

    def init_aux(self, state: ParticleState, box: Box):
        state, aux = build_strips(self.resize(state), self.geom, box)
        return state, self._attach_mix(state, aux)

    def vapor_neighbor(self, state: ParticleState, box: Box, vtype: int,
                       cut: float, aux: GridData):
        """fix phase_change interface query over the strip windows: per
        pool row (count, nearest, rsq, near_owned, rsq_owned) of the
        type-``vtype`` neighbours within ``cut`` (clipped to the windows'
        reach, cutoff + skin), with ``inf`` rsq where there is none. A
        nearest seam ghost is resolved to its source row, so grow mode
        targets the owned particle (``tpusph``'s strip_pair.py:1494-1503).
        """
        geom = self.geom
        n = geom.n_slots
        cut = float(min(cut, geom.margin_dist))
        fld = pack_fields(state)
        slot = torch.arange(n, dtype=torch.float32, device=state.device)
        # sign-encoded slot: >= 0 owned, -(slot+1) seam ghost
        fld[RSLOT] = torch.where(state.owned, slot, -slot - 1.0)
        out = vapor_sweep(fld, self.win, aux.delta, geom, vtype, cut)
        count = out[ORHO].to(torch.int64)
        nearest = out[OCGX].clamp(0, n - 1).to(torch.int64)
        inf = torch.full((), float("inf"), device=state.device)
        rsq = torch.where(count > 0, out[OCGY], inf)
        near_o = out[OFX].clamp(0, n - 1).to(torch.int64)
        rsq_o = torch.where(out[OFY] < 1e29, out[OFY], inf)
        if aux.seam_src.numel() > 0:
            owner_of = _scatter_rows(torch.arange(n, device=state.device),
                                     aux.seam_dest, aux.seam_src, n)
            resolved = owner_of.index_select(0, nearest)
            better = state.owned.index_select(0, resolved) & (rsq < rsq_o)
            near_o = torch.where(better, resolved, near_o)
            rsq_o = torch.where(better, rsq, rsq_o)
        return count, nearest, rsq, near_o, rsq_o

    def refresh_seam(self, state: ParticleState, aux: GridData
                     ) -> ParticleState:
        """Re-copy the seam-ghost bands from their source rows EVERY step
        (the forward_comm analog): ghost copies must never self-evolve
        between rebuilds (band-edge ghosts have truncated neighbourhoods,
        which breaks action-reaction at the seam). Copies x (column axis
        shifted by +-L), vest, rho and e."""
        src, dest, shift = aux.seam_src, aux.seam_dest, aux.seam_shift
        if src.numel() == 0:
            return state
        ca = self.geom.col_axis
        mat = torch.cat([state.x, state.vest, state.rho[:, None],
                         state.e[:, None]], dim=1)
        g = mat[src]
        g[:, ca] += shift
        mat = _scatter_rows(mat, dest, g, state.capacity)
        return dataclasses.replace(
            state, x=mat[:, 0:3].contiguous(), vest=mat[:, 3:6].contiguous(),
            rho=mat[:, 6].contiguous(), e=mat[:, 7].contiguous())

    def prepare(self, state: ParticleState, aux: GridData, istep: int,
                box: Box):
        """skin/2 trigger (or every ``rebuild_every`` steps), the rebuild
        when it fires, then the seam refresh. Returns (state, aux,
        rebuilt)."""
        rebuilt = (self.rebuild_every > 0 and istep % self.rebuild_every == 0
                   ) or needs_rebuild(state, aux.x_ref, self.geom.skin)
        if rebuilt:
            state, aux2 = build_strips(state, self.geom, box,
                                       nbuilds=aux.nbuilds)
            aux = self._attach_mix(state, aux2)
        return self.refresh_seam(state, aux), aux, rebuilt
