"""The cell-grid lifecycle on torch — the part of ``tpusph/ops/cellgrid.py``
that the column kernel's backend (``ops/pallas_pair.PallasBackend``)
delegates to: the neighbour and shift tables, the initial sort, the
per-step rebuild decision, and the phase-change vapor query.

The cell grid's own XLA sweeps (``rho_summation``, ``color_gradient``,
``force``) need ``ops/pair_terms.py``, which is not ported; the column
kernel computes those sweeps on the same layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusph_torch import grid as gridlib
from tpusph_torch.grid import CellGridData, GridGeometry
from tpusph_torch.state import Box, ParticleState

# (candidate, i slot) entries per chunk of the vapor query: bounds its
# temporaries (about 60 bytes an entry, so ~1 GB) at any pool size
_VAPOR_CHUNK = 1 << 24


def _rsq_fma(d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor):
    """d0*d0 + d1*d1 + d2*d2 in float32 as the reference's XLA code forms
    it on the CPU: the three-term reduction contracts into two fused
    multiply-adds, fma(d2, d2, fma(d1, d1, d0*d0)). Each fma is taken in
    float64 (the products of float32 values are exact there) and rounded
    to float32, so the query's rsq, and with it every tie, is the
    reference's."""
    t = (d0 * d0).double()
    a = (t + d1.double() * d1.double()).float().double()
    return (a + d2.double() * d2.double()).float()


class CellGridBackend:
    """Owns the static cell geometry and its device tables."""

    def __init__(self, geom: GridGeometry, rebuild_every: int = 0,
                 device="cpu"):
        self.geom = geom
        flat, shift = gridlib.neighbor_cell_ids(geom)
        self.nbr_flat = torch.as_tensor(flat.astype(np.int64), device=device)
        self.nbr_shift = torch.as_tensor(shift, device=device)
        self.rebuild_every = rebuild_every  # 0 = displacement-triggered

    # -- lifecycle ---------------------------------------------------------

    def init_aux(self, state: ParticleState, box: Box):
        state = dataclasses.replace(state, x=box.wrap(state.x))
        return gridlib.build(state, self.geom)

    def prepare(self, state: ParticleState, aux: CellGridData, istep: int,
                box: Box):
        """Neighbor::decide + Domain::pbc + re-sort when the skin/2 trigger
        (or ``rebuild_every``) fires. Returns (state, aux, rebuilt)."""
        rebuilt = (self.rebuild_every > 0 and istep % self.rebuild_every == 0
                   ) or gridlib.needs_rebuild(state, aux.x_ref,
                                              self.geom.skin)
        if rebuilt:
            state = dataclasses.replace(state, x=box.wrap(state.x))
            state, aux = gridlib.build(state, self.geom,
                                       nbuilds=aux.nbuilds)
        return state, aux, rebuilt

    # -- the fix phase_change interface query -------------------------------

    def vapor_neighbor(self, state: ParticleState, box: Box, vtype: int,
                       cut: float, aux: CellGridData):
        """Per sorted row (count, nearest, rsq, near_owned, rsq_owned) of the
        type-``vtype`` neighbours within ``cut``, as
        ``tpusph.ops.cellgrid.CellGridBackend.vapor_neighbor`` computes them
        over the cell windows, value for value:

          * a candidate is a row of a stencil cell with rank < cap; a pair
            needs i != j unless the stencil entry carries an image shift;
          * the nearest is the first minimum of rsq in (stencil offset,
            rank) order (``jnp.argmin``), the nearest owned the same over
            owned candidates;
          * an alive row with no candidate gets rsq inf, rsq_owned inf, and
            for both nearest rows the first candidate row of its first
            stencil cell; a row outside the windows (dead, or beyond the
            cell cap) gets 0, 0, inf, 0, 0.

        Plain PyTorch, as the reference's query is XLA. Only vapour rows
        are candidates, so the work is (27 or 9) x vapour rows x cap
        (candidate, i slot) entries, taken in chunks of ``_VAPOR_CHUNK``
        entries: the temporaries stay under ~1 GB at any pool size."""
        geom = self.geom
        dev = state.device
        n, cap, ncells = state.capacity, geom.cap, geom.total_cells
        S = self.nbr_flat.shape[1]
        cut2 = float(np.float32(cut * cut))
        starts, counts = aux.starts, aux.counts
        in_win = (aux.cell_id < ncells) & (aux.rank < cap)
        ok_i = state.alive & in_win

        # candidate triples (cell c, stencil entry s, vapour row v), in
        # (c, s, rank of v) order: the reference's candidate order per cell
        vap = in_win & (state.type == vtype)
        vcnt = torch.zeros(ncells + 1, dtype=torch.int64, device=dev
                           ).index_add_(0, torch.where(vap, aux.cell_id,
                                                       ncells),
                                        torch.ones(n, dtype=torch.int64,
                                                   device=dev))
        vcnt[ncells] = 0                # the sentinel cell holds no one
        vrows = torch.nonzero(vap)[:, 0]     # sorted rows: by cell, by rank
        vstart = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(vcnt, 0)])
        jc = self.nbr_flat.reshape(-1)                    # (ncells*S,)
        per_cs = vcnt.index_select(0, jc)
        cs = torch.repeat_interleave(
            torch.arange(ncells * S, device=dev), per_cs)
        first = torch.cumsum(per_cs, 0) - per_cs
        t = torch.arange(cs.numel(), device=dev) - first.index_select(0, cs)
        v_of = vrows.index_select(0, vstart.index_select(
            0, jc.index_select(0, cs)) + t)
        c_of, s_of = cs // S, cs % S

        L = box.length
        k = torch.arange(cap, device=dev)
        count = torch.zeros(n, dtype=torch.int64, device=dev)
        best = {key: (torch.full((n,), float("inf"), device=dev),
                      torch.full((n,), -1, dtype=torch.int64, device=dev))
                for key in ("all", "owned")}
        step = max(1, _VAPOR_CHUNK // cap)
        for q0 in range(0, cs.numel(), step):
            q1 = min(q0 + step, cs.numel())
            c, s, v = c_of[q0:q1], s_of[q0:q1], v_of[q0:q1]
            shift = self.nbr_shift[c, s]                  # (Q, 3)
            imaged = (shift != 0.0).any(-1)
            xj = state.x.index_select(0, v) + shift * L
            irow = starts.index_select(0, c)[:, None] + k  # (Q, cap)
            ivalid = k < counts.index_select(0, c)[:, None]
            irow = torch.clamp(irow, max=n - 1)
            xi = state.x[irow]                            # (Q, cap, 3)
            d = xi - xj[:, None, :]
            rsq = _rsq_fma(d[..., 0], d[..., 1], d[..., 2])
            live = (ivalid & ((irow != v[:, None]) | imaged[:, None])
                    & (rsq < cut2))
            pi = irow[live]
            pr = rsq[live]
            pq = (torch.arange(q0, q1, device=dev)[:, None]
                  .expand(-1, cap)[live])
            count.index_add_(0, pi, torch.ones_like(pi))
            own = state.owned.index_select(0, v)[:, None].expand(-1, cap)
            for key, sel in (("all", None), ("owned", own[live])):
                ci, cr, cq = (pi, pr, pq) if sel is None else \
                    (pi[sel], pr[sel], pq[sel])
                mn, qb = best[key]
                # this chunk's first minimum per row (smallest q at the
                # least rsq); a later chunk wins only on a strictly smaller
                # rsq, as jnp.argmin keeps the first minimum
                cmn = torch.full((n,), float("inf"), device=dev
                                 ).scatter_reduce_(0, ci, cr, "amin")
                tie = cr == cmn.index_select(0, ci)
                cqb = torch.full((n,), 1 << 62, dtype=torch.int64,
                                 device=dev
                                 ).scatter_reduce_(0, ci[tie], cq[tie],
                                                   "amin")
                better = cmn < mn
                best[key] = (torch.where(better, cmn, mn),
                             torch.where(better, cqb, qb))

        # no candidate: the first candidate row of the first stencil cell
        cell = torch.clamp(aux.cell_id, max=ncells - 1)
        j0 = torch.clamp(starts.index_select(0, torch.clamp(
            self.nbr_flat[cell, 0], max=ncells)), max=n - 1)
        inf = torch.full((), float("inf"), device=dev)
        v_pad = torch.cat([v_of, v_of.new_zeros(1)])
        outs = []
        for key in ("all", "owned"):
            mn, qb = best[key]
            found = qb >= 0
            row = torch.where(found, v_pad.index_select(
                0, torch.where(found, qb, v_of.numel())), j0)
            outs.append((torch.where(ok_i, row, 0),
                         torch.where(ok_i, mn, inf if key == "all" else 0.0)))
        (nearest, rsq), (near_o, rsq_o) = outs
        count = torch.where(ok_i, count, 0)
        rsq = torch.where(count > 0, rsq, inf)
        return count, nearest, rsq, near_o, rsq_o
