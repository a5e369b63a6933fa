"""The compacted force sweep on torch — the counterpart of
``tpusph/ops/mxu_compact.py`` (see its module docstring for the design):
a force sweep over the strip windows in which each i-tile first keeps only
the window rows within the largest cutoff of its bounding box, then runs
the force physics on those survivors alone. Its CUDA kernel is
``csrc/compact_force.cu``.

The reference packs the survivors with one-hot MXU gathers and a
triangular prefix matmul, in bf16x3 passes, and shifts positions to the
tile's bbox centre so those passes stay value-faithful. A CUDA block
compacts with warp ballots into shared memory, where a copy is exact, so
neither the gathers nor the centre shift are carried over.

What it keeps: the strip sweep's windows (``StripWindows`` and the
``delta`` tables), the reference's survivor order (offset kk, then window
row) and its overflow cap P with the per-tile overflow count in output
row OCNT, and ``measure_union_cap``, the host-side P. Like the reference
it has no virial row, and like the band and column sweeps it runs the
capillary terms on every pair (no RMIX gate): they are exactly zero where
the strip skips them.

It is on no path of ``Simulation``: ``tpusph_torch.proto_mxu_compact``
measures it against the strip force sweep on the same inputs, as
``tools/proto_mxu_compact.py`` does in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusph_torch.ops import cuda_build
from tpusph_torch.ops.band_pair import check_inputs, spec_flags
from tpusph_torch.ops.rows import ODE, ODRHO, OFX, OFY, OFZ, RTYPE, RX
from tpusph_torch.ops.strip_pair import (
    StripGeometry, StripWindows, _box_d2, _column_step, _geom_ints, _take,
    _window_checks, _window_hits, _window_slots, box_r2, sum_pairs,
)
from tpusph_torch.params import DeviceTables, PhysicsSpec

BIG = 1e30
OCNT = 7  # output row: per-tile compaction overflow count (rows 5-6 zero)
# the filtered kernel's window rows a compaction step and staged rows a
# chunk (csrc/compact_force.cu's kStep and kStage)
COMPACT_STEP = 128
COMPACT_STAGE = 128


def measure_union_cap(x: np.ndarray, geom: StripGeometry, box, cut: float,
                      headroom: float = 1.3) -> int:
    """Host-side P: max over (column, tile z-slab) of the candidate-union
    count — particles within ``cut`` of the tile's column cell x z-extent
    box — x headroom, padded to a multiple of 128 (the reference's
    ``measure_union_cap``, float64 numpy, line for line). ``x`` holds the
    alive rows' current positions."""
    lo = box.lo.cpu() if isinstance(box.lo, torch.Tensor) else box.lo
    lo = np.asarray(lo, np.float64)
    x = np.asarray(x, np.float64)
    cellx, celly = geom.cell_xy
    cx = np.clip(((x[:, 0] - lo[0]) / cellx).astype(int), 0, geom.ncx - 1)
    if geom.dim == 3:
        cy = np.clip(((x[:, 1] - lo[1]) / celly).astype(int), 0,
                     geom.ncy - 1)
    else:
        cy = np.zeros(len(x), int)
    z = x[:, geom.col_axis] - lo[geom.col_axis]
    lz = geom.lengths[geom.col_axis]
    # z-extent of one tile at mean density
    rows_per_z = len(x) / max(geom.ncols, 1) / max(lz, 1e-30)
    tile_z = geom.ts / max(rows_per_z, 1e-30)
    nz = max(int(np.ceil(lz / max(tile_z, 1e-30))), 1)
    tz = np.clip((z / tile_z).astype(int), 0, nz - 1)
    # the real ball-box test against each tile box, by binning over the
    # 3x3 column x +-k slab reach (a particle added to every box in reach
    # regardless of distance overcounts the union ~2-3x)
    kx = int(np.ceil(cut / cellx)) if cellx > 0 else 0
    ky = int(np.ceil(cut / celly)) if geom.dim == 3 and celly > 0 else 0
    kz = int(np.ceil(cut / max(tile_z, 1e-30)))
    ncy = max(geom.ncy, 1)
    counts = np.zeros((geom.ncx, ncy, nz), np.int64)
    xp = x[:, 0] - lo[0]
    yp = (x[:, 1] - lo[1]) if geom.dim == 3 else np.zeros(len(x))
    cut2 = cut * cut

    def axdist(p, blo, size):
        return np.maximum(np.maximum(blo - p, p - (blo + size)), 0.0)

    for dx in range(-kx, kx + 1):
        for dy in range(-ky, ky + 1):
            for dz in range(-kz, kz + 1):
                tx, ty, tzz = cx + dx, cy + dy, tz + dz
                dxc = axdist(xp, tx * cellx, cellx)
                dyc = (axdist(yp, ty * celly, celly)
                       if geom.dim == 3 else 0.0)
                dzc = axdist(z, tzz * tile_z, tile_z)
                ok = dxc * dxc + dyc * dyc + dzc * dzc < cut2
                if geom.periodic[0]:
                    tx = tx % geom.ncx
                if geom.dim == 3 and geom.periodic[1]:
                    ty = ty % ncy
                if geom.col_periodic:
                    tzz = tzz % nz
                ok &= (tx >= 0) & (tx < geom.ncx) & (ty >= 0) \
                    & (ty < ncy) & (tzz >= 0) & (tzz < nz)
                np.add.at(counts, (tx[ok], ty[ok], tzz[ok]), 1)
    best = int(counts.max())
    return int(-(-int(best * headroom) // 128) * 128)


def compact_cut2(cut: float) -> float:
    """cut^2 as the float32 the ball-box filter compares against (the
    reference's Python float cut*cut, taken to float32 by the compare)."""
    return float(np.float32(cut * cut))


def tile_survivors(fld: torch.Tensor, win: StripWindows, delta,
                   geom: StripGeometry, c0: int, c1: int, cut: float):
    """The ball-box filter of columns [c0, c1): per (column, tile) and
    window row in ``_window_slots``' order (offset kk, then row), whether
    the row survives — it is in its column, alive (type > 0.5), and its
    squared distance to the bounding box of the tile's alive rows' current
    positions is below cut^2 (axis gaps summed x, y, z as the kernel sums
    them) — and whether the tile has an alive row. Shapes (k, ntiles,
    nnbr*W) and (k, ntiles)."""
    dev = fld.device
    cap, ts = geom.col_cap, geom.ts
    jslot, ok, shift = _window_slots(win, delta, geom, c0, c1)
    islot = ((torch.arange(c0, c1, device=dev) * cap)[:, None, None]
             + (torch.arange(geom.ntiles, device=dev) * ts)[None, :, None]
             + torch.arange(ts, device=dev))                  # (k, T, ts)
    alive_i = _take(fld[RTYPE], islot) > 0.5
    d2 = None
    for axis in range(3):
        xi = _take(fld[RX + axis], islot)
        bmin = torch.where(alive_i, xi, BIG).amin(-1, keepdim=True)
        bmax = torch.where(alive_i, xi, -BIG).amax(-1, keepdim=True)
        xj = _take(fld[RX + axis], jslot)
        if axis < 2:
            xj = xj + shift[:, None, :, axis]
        gap = torch.clamp(torch.maximum(bmin - xj, xj - bmax), min=0.0)
        d2 = gap * gap if d2 is None else d2 + gap * gap
    keep = ok & (_take(fld[RTYPE], jslot) > 0.5) & (d2 < compact_cut2(cut))
    return keep, alive_i.any(-1)


def plain_compact_force(fld: torch.Tensor, tabs: DeviceTables,
                        win: StripWindows, delta: torch.Tensor,
                        geom: StripGeometry, spec: PhysicsSpec, P: int,
                        cut: float) -> torch.Tensor:
    """The plain PyTorch version of the compacted force sweep, on any
    device.

    Same windows as ``strip_pair.plain_sweep``. Per i-tile the survivors of
    ``tile_survivors`` are numbered in (kk, row) order and the first P are
    kept; the pairs (alive i of the tile, kept j) with 1e-12 < rsq below
    the force sweep's largest cutoff go through the force physics of
    ``tile_physics``, capillary terms on every pair and no virial. Returns
    the (8, n_slots) output matrix: rows OFX..ODE, rows 5-6 zero, and on
    every row of a tile with an alive row OCNT = max(survivors - P, 0)
    (0 on a tile without one)."""
    dev = fld.device
    cap, ts = geom.col_cap, geom.ts
    M = geom.nnbr * geom.w
    spec = dataclasses.replace(spec, virial=False)
    out = torch.zeros(8, geom.n_slots, dtype=torch.float32, device=dev)
    for c0 in range(0, geom.ncols, _column_step(geom)):
        c1 = min(c0 + _column_step(geom), geom.ncols)
        r0 = c0 * cap
        keep, live = tile_survivors(fld, win, delta, geom, c0, c1, cut)
        kept = keep & (keep.cumsum(-1) <= P)
        over = torch.where(live, (keep.sum(-1) - P).clamp(min=0), 0)
        out[OCNT, r0:c1 * cap] = over.to(torch.float32).repeat_interleave(
            ts, dim=1).reshape(-1)
        pi, pj, psx, psy, m = _window_hits(fld, win, delta, geom, c0, c1,
                                           tabs.cutmax2["force"])
        tile = (pi - r0) // ts
        sel = kept.reshape(-1).index_select(0, tile * M + m)
        pi, pj, psx, psy = (t[sel] for t in (pi, pj, psx, psy))
        sum_pairs(out, "force", fld, fld, tabs, spec, r0, c1 * cap, pi, pj,
                  psx, psy, out_rows=(OFX, OFY, OFZ, ODRHO, ODE))
    return out


def compact_pass_counts(fld: torch.Tensor, win: StripWindows,
                        delta: torch.Tensor, geom: StripGeometry, P: int,
                        cut: float, cutmax2: float,
                        radius_scale: float = 1.0) -> dict:
    """The counts that decide the compacted kernel's design, on any
    device: the host copy of its filter (``csrc/compact_force.cu``), used
    by chip_smoke.py and the tests, never on a path. Its warps are 32
    consecutive rows of a tile (the last one partial where ts is not a
    multiple of 32); ``radius_scale`` scales the warp box's cutoff (1: the
    kernel's).
      tiles           tiles with an alive row (the others write zeros);
      steps           their compaction steps (barriers), COMPACT_STEP
                      window rows each, per offset from the clipped window;
      survivors       their ball-box survivors (``tile_survivors``), and
                      kept the first P of each tile's;
      chunks          non-empty chunks the warps sum: the kept rows in
                      order, a step's joining the chunk unless it would
                      overfill COMPACT_STAGE rows (then a new chunk);
      warps           warps with an alive row;
      box_survivors   (warp, kept row) where the row lies within the cutoff
                      plus the float32 margin of the box of the warp's alive
                      rows (``box_r2``): what phase (a) of filter_window
                      passes to the lanes' exact tests;
      live_pairs      (alive i, kept j) with 1e-12 < rsq < cutmax2;
      lockstep_passes body passes of the one-pass check kernel: (warp,
                      kept row) where any of the warp's rows has a live
                      pair;
      queue_passes    body passes of the warp pair queue: per warp and
                      chunk ceil(live pairs / the warp's lanes), summed;
      live_outside_box  live pairs whose j row is not a box survivor of i's
                      warp (0: the filter is conservative)."""
    dev = fld.device
    cap, ts, W, nnbr = geom.col_cap, geom.ts, geom.w, geom.nnbr
    T, M, nw = geom.ntiles, nnbr * W, -(-ts // 32)
    rc = float(np.sqrt(np.float32(cutmax2))) * radius_scale
    cutmax2 = float(np.float32(cutmax2))
    counts = dict.fromkeys(
        ("tiles", "steps", "survivors", "kept", "chunks", "warps",
         "box_survivors", "live_pairs", "lockstep_passes", "queue_passes",
         "live_outside_box"), 0)
    nlanes = torch.clamp(ts - 32 * torch.arange(nw, device=dev), max=32)
    cstep = _column_step(geom)
    for c0 in range(0, geom.ncols, cstep):
        c1 = min(c0 + cstep, geom.ncols)
        k, r0 = c1 - c0, c0 * cap
        keep, live = tile_survivors(fld, win, delta, geom, c0, c1, cut)
        kept = keep & (keep.cumsum(-1) <= P)
        counts["tiles"] += int(live.sum())
        counts["survivors"] += int(keep.sum())
        counts["kept"] += int(kept.sum())
        # the compaction's steps, and the chunk each kept row is summed in
        jslot, ok, shift = _window_slots(win, delta, geom, c0, c1)
        okw = ok.reshape(k, T, nnbr, W)
        nst = -(-okw.sum(-1) // COMPACT_STEP)                  # (k, T, nnbr)
        pos = (okw.cumsum(-1) - 1).clamp(min=0) // COMPACT_STEP
        gstep = ((nst.cumsum(-1) - nst)[..., None] + pos).reshape(k, T, M)
        counts["steps"] += int((nst.sum(-1) * live).sum())
        S = int(nst.sum(-1).max())
        nkeep = torch.zeros(k, T, S + 1, dtype=torch.long, device=dev
                            ).scatter_add_(2, gstep, kept.long())
        staged = torch.zeros(k, T, dtype=torch.long, device=dev)
        flushes = torch.zeros_like(staged)
        chunk_of = torch.zeros_like(nkeep)
        for step in range(S):
            full = staged + nkeep[..., step] > COMPACT_STAGE
            flushes += full
            staged = torch.where(full, 0, staged) + nkeep[..., step]
            chunk_of[..., step] = flushes
        counts["chunks"] += int((flushes + (staged > 0)).sum())
        chunk = chunk_of.gather(2, gstep).reshape(-1)
        # the warps' boxes and their survivors among the kept rows
        islot = (r0 + (torch.arange(k, device=dev) * cap)[:, None, None]
                 + (torch.arange(T, device=dev) * ts)[None, :, None]
                 + torch.arange(ts, device=dev))               # (k, T, ts)
        pad = (0, nw * 32 - ts)
        alive = torch.nn.functional.pad(_take(fld[RTYPE], islot) > 0.5,
                                        pad).reshape(k, T, nw, 32)
        lo, hi, xj = [], [], []
        for axis in range(3):
            xi = torch.nn.functional.pad(_take(fld[RX + axis], islot), pad
                                         ).reshape(k, T, nw, 32)
            lo.append(torch.where(alive, xi, float("inf")).amin(-1))
            hi.append(torch.where(alive, xi, -float("inf")).amax(-1))
            x = _take(fld[RX + axis], jslot)
            xj.append(x + shift[:, None, :, axis] if axis < 2 else x)
        has = alive.any(-1)                                    # (k, T, nw)
        r2 = box_r2(torch.stack(lo, -1).reshape(-1, 3),
                    torch.stack(hi, -1).reshape(-1, 3), rc).reshape(k, T, nw)
        d2 = _box_d2(*[x[:, :, None, :] for x in xj],
                     [v[..., None] for v in lo], [v[..., None] for v in hi])
        inbox = (d2 < r2[..., None]) & kept[:, :, None, :] & has[..., None]
        counts["warps"] += int(has.sum())
        counts["box_survivors"] += int(inbox.sum())
        # the live pairs of the kept rows, their warp and chunk
        pi, _, _, _, m = _window_hits(fld, win, delta, geom, c0, c1, cutmax2)
        tile = (pi - r0) // ts
        sel = kept.reshape(-1).index_select(0, tile * M + m)
        pi, m, tile = pi[sel], m[sel], tile[sel]
        wt = tile * nw + ((pi - r0) % ts) // 32               # (tile, warp)
        counts["live_pairs"] += pi.numel()
        counts["live_outside_box"] += int(
            (~inbox.reshape(-1).index_select(0, wt * M + m)).sum())
        counts["lockstep_passes"] += int(torch.unique(wt * M + m).numel())
        nch = S + 1
        key, npairs = torch.unique(
            wt * nch + chunk.index_select(0, tile * M + m),
            return_counts=True)
        lanes = nlanes[(key // nch) % nw]
        counts["queue_passes"] += int(((npairs + lanes - 1) // lanes).sum())
    return counts


class CompactForceKernel(cuda_build.LaunchCount):
    """Wrapper of the CUDA compacted force sweep (``launcher`` force:
    ``compact_force_launch``) or of its one-pass check kernel (force_scan:
    ``compact_force_scan_launch``, on no path).

    Replaces ``tpusph.ops.mxu_compact.make_compact_force_kernel`` (the
    ``pl.pallas_call`` at mxu_compact.py:277). CPU tensors take the plain
    version (``plain_compact_force``); CUDA tensors launch the kernel or
    raise. ``launches`` and ``by_card`` count kernel launches only.

    On the card the strip force sweep is bound by rejecting candidates:
    each i-row scans nnbr*W window rows (~3.5k at W 384), ~3% of them
    live. Here one block of 64 threads per tile scans each window row once
    for the whole tile (four loads and a ball-box test), compacts the
    survivors in order by warp ballots, and stages them in shared memory
    in fixed chunks, so shared memory does not grow with P. The kernel
    then sums each chunk through the strip force's warp box filter and
    warp pair queue (``csrc/warp_filter.cuh``): each warp tests the chunk
    against the box of its rows, each lane the box's survivors exactly,
    and the live pairs run 32 a pass, each row adding its pairs in the
    check kernel's order (its bits). The check kernel runs the pair test
    and, in lockstep, the body for every kept survivor in every row;
    ``compact_pass_counts`` counts both on a layout."""

    def __init__(self, launcher: str = "force"):
        self.launcher = launcher
        super().__init__()

    def __call__(self, fld: torch.Tensor, tabs: DeviceTables,
                 win: StripWindows, delta: torch.Tensor, geom: StripGeometry,
                 spec: PhysicsSpec, P: int, cut: float) -> torch.Tensor:
        T1 = tabs.tab1.shape[1]
        check_inputs("compact force sweep", fld, _window_checks(
            fld, win, delta, geom) + (
                ("tab2", tabs.tab2, (8, T1, T1), torch.float32),
                ("tab1", tabs.tab1, (5, T1), torch.float32)))
        if not 0 <= P < 1 << 30:
            raise ValueError(f"compact force sweep: P {P} out of range")
        if fld.device.type == "cpu":
            return plain_compact_force(fld, tabs, win, delta, geom, spec, P,
                                       cut)
        out = torch.empty(8, geom.n_slots, dtype=torch.float32,
                          device=fld.device)
        cuda_build.launch_compact(
            self.launcher, fld, win.perm, win.shift, delta, tabs.tab2,
            tabs.tab1, out, dim=geom.dim, kernel=spec.kernel,
            flags=spec_flags(spec), T1=T1, P=int(P),
            cutmax2=tabs.cutmax2["force"], cut2=compact_cut2(cut),
            **_geom_ints(geom))
        self.count(fld.device)
        return out


compact_force = CompactForceKernel()
compact_force_scan = CompactForceKernel("force_scan")
# the kernel wrappers of this module (launch counts): the sweep, and its
# one-pass check kernel, which no path launches
KERNELS = {"force": compact_force}
SCANS = {"force": compact_force_scan}
