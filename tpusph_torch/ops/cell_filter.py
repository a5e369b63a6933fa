"""The counts that decide the design of the column and band kernels'
filtered sweep (``csrc/cell_sweep.cuh``), on any device: the counterpart of
``strip_pair.warp_pass_counts`` for the two cell layouts. Used by
chip_smoke.py and the tests, never on the main path.

Both layouts are the band's shape (``as_band``): the column grid is the
band layout with G = 1, k = 1, c = cap and nsub_pad = ncz, so the counts
take the kernel's windows from ``band_pair._band_windows`` for either. The
two differ in how the kernel finds a staged sub-cell's live reach: on the
band by reading every slot's type, on the column grid by a binary search
for the cell's alive prefix (``alive_prefix``), which the layout's
invariant makes its reach.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusph_torch.ops.band_pair import BandGeometry, _band_windows
from tpusph_torch.ops.pallas_pair import ColumnGrid
from tpusph_torch.ops.rows import RTYPE, RX
from tpusph_torch.ops.strip_pair import _box_d2, box_r2

# the kernel's constants (csrc/cell_sweep.cuh): i slots per block (a chunk
# of the group), staged rows per round by sweep (CellBuild), and the colour
# gate's type bits (csrc/warp_filter.cuh kGateBits: the last bit stands for
# every type from it up)
CELL_THREADS = 128
STAGE_ROWS = {"force": 256, "rho": 512, "cgrad": 512}
GATE_BITS = 31
# (warp lane, candidate) entries per chunk of the counts
_CHUNK = 1 << 23


def as_band(layout) -> BandGeometry:
    """The band view of a column grid (G 1, k 1, c cap, nsub_pad ncz);
    a band geometry as it is."""
    if isinstance(layout, BandGeometry):
        return layout
    cg: ColumnGrid = layout
    return BandGeometry(
        ncx=cg.ncx, ncy=cg.ncy, nsub=cg.ncz, G=1, c=cg.cap, k=1, dim=cg.dim,
        periodic=cg.periodic, lengths=cg.lengths, origin=(0.0, 0.0, 0.0),
        cell_xy=(0.0, 0.0), s_sub=0.0, skin=0.0)


def block_threads(geom: BandGeometry) -> int:
    """Threads of the kernel's block: a chunk of up to CELL_THREADS slots
    of a group, a whole number of warps."""
    return min(CELL_THREADS, -(-geom.gc // 32) * 32)


def alive_prefix(typ: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's binary search (``alive_prefix`` in csrc/cell_sweep.cuh)
    on each row of ``typ`` (M, c), the types of a cell's c slots: (the
    length of its alive prefix, the types read to find it), each (M,).
    Where the alive slots are a prefix, the length is one past the last
    alive slot."""
    m, c = typ.shape
    lo = torch.zeros(m, dtype=torch.long, device=typ.device)
    hi = torch.full_like(lo, c)
    reads = torch.zeros_like(lo)
    while True:
        act = lo < hi
        if not bool(act.any()):
            return lo, reads
        mid = (lo + hi) // 2
        up = typ.gather(1, mid.clamp(max=c - 1)[:, None])[:, 0] > 0.5
        reads += act.long()
        lo = torch.where(act & up, mid + 1, lo)
        hi = torch.where(act & ~up, mid, hi)


def _boxes(x, alive, rc):
    """Bounding boxes of the alive rows along dim 1 of x (B, L, 3), alive
    (B, L), and their filter radius squared (``strip_pair.box_r2``)."""
    lo = torch.where(alive[..., None], x, float("inf")).amin(1)
    hi = torch.where(alive[..., None], x, float("-inf")).amax(1)
    return lo, hi, box_r2(lo, hi, rc)


def _gate(present: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """The colour gate of sets of i-row types (``present`` (B, T1) bool):
    (B, T1) bool, True where a j row of that type is kept, i.e. its colour
    minus the colour of some type of the set is not 0 (``pair_body``'s
    own test; ``unlike_types`` in csrc/warp_filter.cuh, whose types from
    GATE_BITS up keep every row)."""
    diff = (colors[:, None] - colors[None, :]) != 0          # [tj, ti]
    keep = (present[:, None, :] & diff[None]).any(-1)
    if colors.numel() > GATE_BITS:
        keep[:, GATE_BITS:] = True
        keep |= present[:, GATE_BITS:].any(1, keepdim=True)
    return keep


def cell_pass_counts(fld: torch.Tensor, layout, cut2: float,
                     sweep: str = "force",
                     colors: torch.Tensor | None = None) -> dict:
    """The counts of the phases of the column (``layout`` a ``ColumnGrid``)
    or band (a ``BandGeometry``) kernel of ``sweep`` ("force": the queued
    force sweep; "rho", "cgrad": the rho / colour-gradient sweep, which
    adds each live pair at once; cgrad takes ``colors``, the (T1,) colour
    of each type, tab1's colour row), under its blocks (a chunk of
    ``block_threads`` slots of a group), warps (32 consecutive slots of a
    chunk) and staging rounds (at most STAGE_ROWS[sweep] rows of a
    neighbour column's staged sub-cells, in (sub-cell, rank) order, each
    sub-cell to its live reach). A j row is a candidate of a block when it
    is alive and, for cgrad, of a type the block's colour gate keeps (its
    colour differs from one of the block's alive rows'); the live reach is
    one past the last candidate rank:
      rows / warps    alive i rows / warps that hold one;
      reach_reads     types the alive blocks read to find their staged
                      sub-cells' live reach: the band every slot of each
                      (c a sub-cell); the column grid each cell's binary
                      search for its alive prefix, and for cgrad then
                      each prefix slot (the gate's ballot pass);
      ballot_reads    what a ballot pass over every slot reads (the band's
                      reach_reads; the column grid's before the search);
      blocks          blocks launched; blocks_alive: those with an alive
                      row (the rest exit at their first barrier);
                      gate_exits: alive blocks with no candidate in any
                      neighbour column (cgrad: they exit unwritten);
      candidates      rows the one-pass scan tests per alive row: each
                      staged sub-cell to its live reach;
      staged_rows     rows the alive blocks stage (every block its group's
                      window to its live reach), and staged_with_terms the
                      candidates inside the block's box, whose per-j terms
                      the block computes;
      rounds          (alive block, neighbour column) staging rounds, and
                      multi_round_windows those with more than one;
      box_survivors   (warp, neighbour column, row) where a staged
                      candidate survives the warp's box test (cgrad: and
                      the warp's colour gate);
      live_pairs      (i, j) with both alive and 1e-12 < rsq < cut2;
      needed_pairs    the live pairs a sweep adds something for: all of
                      them, cgrad those of unlike colour;
      old_passes      pair-body passes of the lockstep scan: (warp,
                      neighbour column, row) where any lane has a live
                      pair;
      body_passes     the kernel's pair-body passes: force the warp pair
                      queue's, per warp, neighbour column and round
                      ceil(live pairs / 32) (= queue_passes); rho and
                      cgrad the box survivors where any lane has a live
                      pair;
      most_window_pairs  the most live pairs one warp has in one neighbour
                      column (beyond the queue's 128 it flushes inside it);
      live_outside_box  needed pairs whose j row fails its warp's or its
                      block's box or colour gate (0: the filter is
                      conservative)."""
    geom = as_band(layout)
    dev = fld.device
    G, c, k, nnbr = geom.G, geom.c, geom.k, geom.nnbr
    nsw, gc = G + 2 * k, geom.gc
    S = nnbr * nsw
    T = block_threads(geom)
    wpc = T // 32                                  # warps per chunk
    nch = -(-gc // T)                              # chunks per group
    nwg = nch * wpc                                # warps per group
    nblk = geom.ncols * geom.ngroups
    ld = min(nsw * c, STAGE_ROWS[sweep])
    rc = float(np.sqrt(np.float32(cut2)))
    cut2 = float(np.float32(cut2))
    gated = sweep == "cgrad"
    if gated and colors is None:
        raise ValueError("the colour gradient's counts need the colours")
    counts = dict(rows=0, warps=0, blocks=nblk * nch, blocks_alive=0,
                  reach_reads=0, ballot_reads=0, gate_exits=0,
                  candidates=0, staged_rows=0,
                  staged_with_terms=0, rounds=0, multi_round_windows=0,
                  box_survivors=0, live_pairs=0, needed_pairs=0,
                  old_passes=0, queue_passes=0, body_passes=0,
                  most_window_pairs=0, live_outside_box=0)

    alive = fld[RTYPE] > 0.5
    typ = fld[RTYPE].long()
    # each sub-cell's live reach (the column grid's: its alive prefix) and
    # the types read to find it, and each block's staged sub-cells'
    if isinstance(layout, BandGeometry):
        reach = (alive.reshape(-1, c).long()
                 * torch.arange(1, c + 1, device=dev)).amax(1)
        reads = torch.full_like(reach, c)
    else:
        reach, reads = alive_prefix(fld[RTYPE].reshape(-1, c))
        if gated:
            reads = reads + reach
    wbase, wshift = (torch.as_tensor(a, device=dev)
                     for a in _band_windows(geom))          # (nblk, S(, 3))
    valid = wbase >= 0
    reach_s = torch.where(valid, reach[wbase.clamp(min=0) // c], 0)
    reads_s = torch.where(valid, reads[wbase.clamp(min=0) // c], 0)
    R = max(int(reach.max()), 1)

    # the i rows of each group, padded to its chunks' warps
    s_g = torch.arange(nwg * 32, device=dev)
    islot = torch.arange(nblk, device=dev)[:, None] * gc + s_g.clamp(
        max=gc - 1)
    alive_i = alive[islot] & (s_g < gc)                    # (nblk, nwg*32)
    xi = torch.stack([fld[RX + a][islot] for a in range(3)], -1)
    wlo, whi, wr2 = _boxes(xi.reshape(nblk * nwg, 32, 3),
                           alive_i.reshape(nblk * nwg, 32), rc)
    blo, bhi, br2 = _boxes(xi.reshape(nblk * nch, T, 3),
                           alive_i.reshape(nblk * nch, T), rc)
    warp_alive = alive_i.reshape(nblk * nwg, 32).any(1)
    chunk_alive = alive_i.reshape(nblk * nch, T).any(1)
    # the colour gates of the chunks and the warps (all types kept but
    # for cgrad)
    T1 = int(typ.max()) + 1 if colors is None else colors.numel()
    present = torch.zeros(nblk * nwg, T1, dtype=torch.long,
                          device=dev).index_put_(
        (torch.arange(nblk * nwg, device=dev)[:, None].expand(-1, 32),
         typ[islot].reshape(nblk * nwg, 32)),
        alive_i.reshape(nblk * nwg, 32).long(), accumulate=True) > 0
    if gated:
        wkeep = _gate(present, colors.to(dev, torch.float32))
        ckeep = _gate(present.reshape(nblk * nch, wpc, T1).any(1),
                      colors.to(dev, torch.float32))
    else:
        wkeep = torch.ones(nblk * nwg, T1, dtype=torch.bool, device=dev)
        ckeep = torch.ones(nblk * nch, T1, dtype=torch.bool, device=dev)
    counts["rows"] = int(alive_i.sum())
    counts["warps"] = int(warp_alive.sum())
    counts["blocks_alive"] = int(chunk_alive.sum())
    blk_alive = chunk_alive.reshape(nblk, nch).sum(1)
    counts["reach_reads"] = int((blk_alive * reads_s.sum(1)).sum())
    counts["ballot_reads"] = int((blk_alive * valid.sum(1)).sum()) * c
    counts["candidates"] = int((alive_i.sum(1) * reach_s.sum(1)).sum())

    r = torch.arange(R, device=dev)
    kk_of = (torch.arange(S, device=dev) // nsw)[:, None]  # (S, 1)

    def candidates(blk, keep):
        """(candidate, staged position (3 x (B, S, R)), type) of the
        blocks' staged rows under the gates ``keep`` (B, T1)."""
        ok = r < reach_s[blk][..., None]
        jslot = torch.where(ok, wbase[blk].clamp(min=0)[..., None] + r, 0)
        xj = [fld[RX + a][jslot] + wshift[blk][..., a, None]
              for a in range(3)]
        tj = typ[jslot]
        kept = keep.gather(1, tj.reshape(len(blk), -1)).reshape(tj.shape)
        return ok & alive[jslot] & kept, xj, tj

    def live_reach(cand):
        """One past the last candidate rank of each staged sub-cell
        (B, S), and their running sum within each neighbour column."""
        gr = (cand.long() * (r + 1)).amax(-1)
        per = gr.reshape(-1, nnbr, nsw)
        return gr, (per.cumsum(-1) - per).reshape(-1, S)

    def inside(xj, lo, hi, r2):
        return _box_d2(*xj, [v[:, None, None] for v in lo.T],
                       [v[:, None, None] for v in hi.T]) < r2[:, None, None]

    # block-level: exits, the rows staged and those with their terms
    step = max(1, _CHUNK // (S * R))
    ids = chunk_alive.nonzero()[:, 0]
    for q0 in range(0, ids.numel(), step):
        ch = ids[q0:q0 + step]
        cand, xj, _ = candidates(ch // nch, ckeep[ch])
        gr, _ = live_reach(cand)
        total = gr.reshape(-1, nnbr, nsw).sum(-1)          # (B, nnbr)
        rounds = -(-total // ld)
        counts["gate_exits"] += int((total.sum(1) == 0).sum())
        counts["staged_rows"] += int(gr.sum())
        counts["rounds"] += int(rounds.sum())
        counts["multi_round_windows"] += int((rounds > 1).sum())
        counts["staged_with_terms"] += int(
            (cand & inside(xj, blo[ch], bhi[ch], br2[ch])).sum())

    # warp-level: box survivors, live pairs and passes
    maxr = max(-(-nsw * R // ld), 1)
    step = max(1, _CHUNK // (32 * S * R))
    ids = warp_alive.nonzero()[:, 0]
    cols = colors.to(dev, torch.float32) if gated else None
    for q0 in range(0, ids.numel(), step):
        w = ids[q0:q0 + step]
        blk, wg = w // nwg, w % nwg
        ch = blk * nch + wg // wpc
        cand, xj, tj = candidates(blk, ckeep[ch])
        _, off = live_reach(cand)
        wgate = wkeep[w].gather(1, tj.reshape(len(w), -1)).reshape(tj.shape)
        surv = (cand & wgate & inside(xj, blo[ch], bhi[ch], br2[ch])
                & inside(xj, wlo[w], whi[w], wr2[w]))
        counts["box_survivors"] += int(surv.sum())
        lane = wg[:, None] * 32 + torch.arange(32, device=dev)
        ai = alive_i[blk[:, None], lane]                     # (A, 32)
        xw = xi[blk[:, None], lane]                          # (A, 32, 3)
        rsq = None
        for a in range(3):
            d = xw[..., a][:, :, None, None] - xj[a][:, None]
            rsq = d * d if rsq is None else rsq + d * d
        ok = r < reach_s[blk][..., None]
        jalive = ok & alive[torch.where(
            ok, wbase[blk].clamp(min=0)[..., None] + r, 0)]
        live = (ai[:, :, None, None] & jalive[:, None] & (rsq > 1e-12)
                & (rsq < cut2))                              # (A,32,S,R)
        del rsq
        if gated:
            ti = typ[islot[blk[:, None], lane]]              # (A, 32)
            need = live & ((cols[ti][:, :, None, None]
                            - cols[tj][:, None]) != 0)
        else:
            need = live
        counts["live_pairs"] += int(live.sum())
        counts["needed_pairs"] += int(need.sum())
        counts["live_outside_box"] += int((need & ~surv[:, None]).sum())
        counts["old_passes"] += int(live.any(1).sum())
        npair = live.sum(1)                                  # (A, S, R)
        rnd = torch.clamp((off[..., None] + r) // ld, max=maxr - 1)
        key = kk_of * maxr + rnd
        per = torch.zeros(w.numel(), nnbr * maxr, dtype=torch.long,
                          device=dev).scatter_add_(
            1, key.reshape(w.numel(), -1),
            (npair * surv).reshape(w.numel(), -1))
        counts["queue_passes"] += int(((per + 31) // 32).sum())
        counts["body_passes"] += int((live.any(1) & surv).sum())
        per_kk_pairs = npair.reshape(w.numel(), nnbr, -1).sum(-1)
        counts["most_window_pairs"] = max(counts["most_window_pairs"],
                                          int(per_kk_pairs.max()))
    if sweep == "force":
        counts["body_passes"] = counts["queue_passes"]
    return counts
