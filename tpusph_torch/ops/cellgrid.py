"""The cell-grid backend on torch — the counterpart of
``tpusph/ops/cellgrid.py``: the neighbour and shift tables, the initial
sort, the per-step rebuild decision, the three pair sweeps
(``rho_summation``, ``color_gradient``, ``force``) and the phase-change
vapor query. The column kernel's backend (``ops/pallas_pair.PallasBackend``)
delegates its lifecycle and vapor query here.

The reference's sweeps are XLA, not Pallas, so plain PyTorch is their port:
per block of cells, the 27 (3D) / 9 (2D) neighbour-cell windows (at most
``cap`` rows each, with their periodic image shift) against the cell's own
rows, the pair terms of ``ops/pair_terms.py`` on the pairs within the
sweep's largest cutoff, summed into the i rows. A particle sees its own periodic
image in a box under two cells wide. ``api.Simulation`` takes it for
``backend_name = "cellgrid"``, for runs with more than 6 particle types,
and inside each brick of a CPU run in bricks (``tpusph_torch.dist``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch import grid as gridlib
from tpusph_torch import kernels
from tpusph_torch.forces import drive_stage
from tpusph_torch.grid import CellGridData, GridGeometry
from tpusph_torch.ops import pair_terms
from tpusph_torch.ops.rows import TABLES_2D
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState

# (candidate, i slot) entries per chunk of the vapor query: bounds its
# temporaries (about 60 bytes an entry, so ~1 GB) at any pool size
_VAPOR_CHUNK = 1 << 24
# (i slot, j window row) entries per block of cells of a pair search:
# bounds the block's (cells, K, 27 K) product temporaries, K the fullest
# cell's count
_SWEEP_CHUNK = 1 << 22
# pairs at rsq >= cutmax2 * (1 + margin) contribute exactly zero
_CUT_MARGIN = 1e-5


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


class CellPairs(NamedTuple):
    """Candidate pairs of the cell windows: i slot (cell * cap + rank), i
    and j rows, dx = x_i - (x_j + image offset) and rsq = |dx|^2."""
    islot: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    dx: torch.Tensor
    rsq: torch.Tensor

    def within(self, cut2: float) -> "CellPairs":
        """The pairs that can contribute to a sweep of largest cutoff
        squared ``cut2``."""
        keep = self.rsq < cut2 * (1.0 + _CUT_MARGIN)
        return CellPairs(*(t[keep] for t in self))


class CellGridBackend:
    """Owns the static cell geometry and its device tables; ``force_stage``
    (the backend surface ``Runner`` calls) needs the ``box``."""

    def __init__(self, geom: GridGeometry, rebuild_every: int = 0,
                 device="cpu", box: Box | None = None):
        self.geom = geom
        # the box the force stage's sweeps take their image shifts from
        self.box = box
        flat, shift = gridlib.neighbor_cell_ids(geom)
        self.nbr_flat = torch.as_tensor(flat.astype(np.int64), device=device)
        self.nbr_shift = torch.as_tensor(shift, device=device)
        # each cell's centre (the pair search takes positions about it)
        ijk = np.stack(np.unravel_index(np.arange(geom.total_cells),
                                        geom.ncells), -1)
        self.cell_center = torch.as_tensor(
            (np.asarray(geom.origin) + (ijk + 0.5)
             * np.asarray(geom.cell_size)).astype(np.float32), device=device)
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

    # -- the sweeps ----------------------------------------------------------

    def _windows(self, aux: CellGridData, c0: int, c1: int, box_len,
                 reach: int):
        """For the cells [c0, c1) (``tpusph``'s ``_cell_windows``, batched,
        over the first ``reach`` ranks of every cell: no cell holds more):
        (i_rows, i_valid) (C, K) of their own rows and (j_rows, j_valid,
        j_off, j_imaged) (C, J) of the stencil candidates, J = S * K, with
        each candidate's image offset (C, J, 3)."""
        ncells = self.geom.total_cells
        n = aux.cell_id.shape[0]
        dev = aux.starts.device
        counts_ext = torch.cat([aux.counts, aux.counts.new_zeros(1)])
        c = torch.arange(c0, c1, device=dev)
        k = torch.arange(reach, device=dev)
        i_valid = k[None, :] < counts_ext[c][:, None]
        i_rows = torch.clamp(aux.starts[c][:, None] + k, 0, n - 1)
        j_cells = self.nbr_flat[c]                        # (C, S)
        j_shift = self.nbr_shift[c]                       # (C, S, 3)
        j_valid = k < counts_ext[j_cells][..., None]      # (C, S, K)
        j_rows = torch.clamp(
            aux.starts[torch.clamp(j_cells, max=ncells)][..., None] + k,
            0, n - 1)
        C, S = j_cells.shape
        j_off = (j_shift * box_len)[:, :, None, :].expand(C, S, reach, 3)
        j_imaged = (j_shift != 0.0).any(-1)[..., None].expand(C, S, reach)
        return (i_rows, i_valid, j_rows.reshape(C, -1),
                j_valid.reshape(C, -1), j_off.reshape(C, -1, 3),
                j_imaged.reshape(C, -1))

    def pairs(self, state: ParticleState, aux: CellGridData, box: Box,
              cut2: float) -> "CellPairs":
        """The candidate pairs of every cell window whose rsq is under
        ``cut2`` (with a 1e-5 margin). A pair needs both rows in their
        windows (rank < cap) and i != j unless the stencil entry carries an
        image shift; dx = x_i - (x_j + image offset) and rsq = |dx|^2 are
        formed per pair as the reference forms them. The pairs are found
        per block of cells by a float32 matrix product of positions taken
        about each cell's centre, with a margin above its rounding, so the
        product keeps a superset; only ranks below the fullest cell's count
        are looked at."""
        geom = self.geom
        ncells = geom.total_cells
        S = self.nbr_flat.shape[1]
        reach = min(int(aux.counts.max()) if aux.counts.numel() else 0,
                    geom.cap)
        dev = state.device
        if reach == 0:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            zf = torch.zeros(0, dtype=torch.float32, device=dev)
            return CellPairs(z, z, z, zf.reshape(0, 3), zf)
        box_len = box.length
        x = state.x
        step = max(1, _SWEEP_CHUNK // (reach * S * reach))
        lim = cut2 * (1.0 + _CUT_MARGIN)
        out = []
        for c0 in range(0, ncells, step):
            c1 = min(c0 + step, ncells)
            i_rows, i_valid, j_rows, j_valid, j_off, j_img = self._windows(
                aux, c0, c1, box_len, reach)
            ctr = self.cell_center[c0:c1, None, :]
            a = x[i_rows] - ctr                           # (C, K, 3)
            b = x[j_rows] + j_off - ctr                   # (C, J, 3)
            na = torch.where(i_valid, (a * a).sum(-1), float("inf"))
            nb = torch.where(j_valid, (b * b).sum(-1), float("inf"))
            scale = float(torch.where(i_valid, na, 0.0).max()
                          + torch.where(j_valid, nb, 0.0).max())
            # |a|^2 + |b|^2 - 2 a.b in one product: rows outside the
            # windows carry an infinite norm and are never kept
            one_a, one_b = torch.ones_like(na), torch.ones_like(nb)
            ua = torch.cat([a, na[..., None], one_a[..., None]], -1)
            ub = torch.cat([-2.0 * b, one_b[..., None], nb[..., None]], -1)
            approx = torch.bmm(ua, ub.transpose(1, 2))
            cc, ki, jj = (approx < lim + 1e-5 * scale + 1e-6).nonzero(
                as_tuple=True)
            irow, jrow = i_rows[cc, ki], j_rows[cc, jj]
            d = x[irow] - (x[jrow] + j_off[cc, jj])
            rsq = (d * d).sum(-1)
            live = (rsq < lim) & ((irow != jrow) | j_img[cc, jj])
            out.append((((cc + c0) * geom.cap + ki)[live], irow[live],
                        jrow[live], d[live], rsq[live]))
        return CellPairs(*(torch.cat(t) for t in zip(*out)))

    def _to_rows(self, state: ParticleState, aux: CellGridData,
                 islot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """Per-pair values summed into their i slot, then gathered to the
        sorted rows (``tpusph``'s ``_sweep`` scatter-back): a row outside
        the windows (dead, or rank >= cap) reads 0."""
        geom = self.geom
        nslot = geom.total_cells * geom.cap
        acc = torch.zeros((nslot + 1,) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        acc.index_add_(0, islot, vals)
        ok = state.alive & (aux.rank < geom.cap) \
            & (aux.cell_id < geom.total_cells)
        pos = torch.where(ok, aux.cell_id * geom.cap + aux.rank, nslot)
        out = acc[pos]
        okb = ok.reshape(ok.shape + (1,) * (out.dim() - 1))
        return torch.where(okb, out, 0.0)

    @staticmethod
    def _sides(state: ParticleState, irow, jrow):
        fields = dict(vest=state.vest, rho=state.rho, e=state.e,
                      cv=state.cv, rmass=state.rmass,
                      type=state.type.long())
        return ({k: v[irow] for k, v in fields.items()},
                {k: v[jrow] for k, v in fields.items()})

    def _sweep_pairs(self, state, aux, box, cut2, pairs):
        if pairs is None:
            return self.pairs(state, aux, box, cut2)
        return pairs.within(cut2)

    def rho_summation(self, state: ParticleState, tabs: DeviceTables,
                      spec: PhysicsSpec, box: Box, aux: CellGridData,
                      pairs: "CellPairs | None" = None) -> torch.Tensor:
        """sph/rhosum over the cell windows, the self term added per row
        (``tpusph``'s ``CellGridBackend.rho_summation``). ``pairs``: the
        pairs of the same positions at a cutoff at least the sweep's."""
        islot, irow, jrow, _, rsq = self._sweep_pairs(
            state, aux, box, tabs.cutmax2["rho"], pairs)
        cut_rho = tabs.tab2[TABLES_2D.index("cut_rho")]
        t = state.type.long()
        cut_ij = cut_rho[t[irow], t[jrow]]
        r = torch.sqrt(torch.clamp(rsq, min=0.0))
        contrib = pair_terms.rho_summation_pair(
            dict(rmass=state.rmass[jrow]), r, cut_ij, rsq < cut_ij * cut_ij,
            spec)
        rho = self._to_rows(state, aux, islot, contrib)
        self_cut = cut_rho[t, t]
        w0 = kernels.kernel_w(spec.kernel, spec.dim)(
            torch.zeros_like(self_cut), torch.clamp(self_cut, min=1e-30))
        sm = 1.0 if spec.rhosum_nd else state.rmass
        rho = rho + torch.where(state.alive & (self_cut > 0.0), sm * w0,
                                0.0)
        if spec.rhosum_nd:
            rho = rho * state.rmass
        return torch.where(state.alive, rho, state.rho)

    def color_gradient(self, state: ParticleState, tabs: DeviceTables,
                       spec: PhysicsSpec, box: Box, aux: CellGridData,
                       pairs: "CellPairs | None" = None) -> torch.Tensor:
        """sph/colorgradient over the cell windows: (n, 3)."""
        islot, irow, jrow, dx, rsq = self._sweep_pairs(
            state, aux, box, tabs.cutmax2["cgrad"], pairs)
        pi, pj = self._sides(state, irow, jrow)
        r = torch.sqrt(torch.clamp(rsq, min=1e-30))
        coefs = pair_terms.make_pair_coefs(tabs, pi["type"], pj["type"])
        contrib = pair_terms.color_gradient_pair(
            pi, pj, dx, r, coefs, torch.ones_like(rsq, dtype=torch.bool),
            spec)
        cg = self._to_rows(state, aux, islot, contrib)
        return torch.where(state.alive[:, None], cg, 0.0)

    def force(self, state: ParticleState, tabs: DeviceTables,
              spec: PhysicsSpec, box: Box, aux: CellGridData,
              cg: torch.Tensor | None = None,
              pairs: "CellPairs | None" = None):
        """The fused force sweep over the cell windows: (f, drho, de[,
        vir])."""
        if spec.surface_tension and cg is None:
            cg = self.color_gradient(state, tabs, spec, box, aux, pairs)
        islot, irow, jrow, dx, rsq = self._sweep_pairs(
            state, aux, box, tabs.cutmax2["force"], pairs)
        pi, pj = self._sides(state, irow, jrow)
        kw = dict(cg_i=cg[irow], cg_j=cg[jrow]) if spec.surface_tension \
            else {}
        coefs = pair_terms.make_pair_coefs(tabs, pi["type"], pj["type"])
        out = pair_terms.force_pair(
            pi, pj, dx, rsq, torch.ones_like(rsq, dtype=torch.bool), coefs,
            spec, **kw)
        names = ("f", "drho", "de") + (("vir",) if spec.virial else ())
        return tuple(self._to_rows(state, aux, islot, out[k])
                     for k in names)

    def force_stage_steps(self, state: ParticleState, tabs: DeviceTables,
                          spec: PhysicsSpec, aux: CellGridData, istep: int,
                          halo_points: bool = False):
        """The force stage as a generator (``tpusph.forces.
        compute_forces`` over the three sweeps): with ``halo_points`` it
        yields the fresh rho (n,) and colour gradient (n, 3) and goes on
        with the fields it is sent back (``forces.drive_stage``); returns
        the state with fresh f, drho, de (and rho when rhosum fires)."""
        box = self.box
        # positions do not change between the sweeps: one pair search at
        # the largest cutoff of the stage
        cut2 = max([tabs.cutmax2["force"]]
                   + ([tabs.cutmax2["rho"]] if spec.rhosum_every > 0
                      else [])
                   + ([tabs.cutmax2["cgrad"]] if spec.surface_tension
                      else []))
        pairs = self.pairs(state, aux, box, cut2)
        if spec.rhosum_every > 0:
            rho = self.rho_summation(state, tabs, spec, box, aux, pairs)
            if halo_points:
                rho = yield rho
            if istep % spec.rhosum_every == 0:
                state = dataclasses.replace(state, rho=rho)
        cg = None
        if spec.surface_tension:
            cg = self.color_gradient(state, tabs, spec, box, aux, pairs)
            if halo_points:
                cg = yield cg
        out = self.force(state, tabs, spec, box, aux, cg=cg, pairs=pairs)
        upd = dict(f=out[0], drho=out[1], de=out[2])
        if spec.virial:
            upd["vir"] = out[3]
        if spec.gravity:
            gmask = (state.alive & state.mobile)[:, None]
            upd["f"] = upd["f"] + torch.where(
                gmask, state.rmass[:, None] * tabs.gravity[None, :], 0.0)
        return dataclasses.replace(state, **upd)

    def force_stage(self, state: ParticleState, tabs: DeviceTables,
                    spec: PhysicsSpec, aux: CellGridData, istep: int,
                    halo=None) -> ParticleState:
        """rho (when rhosum fires) -> colour gradient -> force, then
        gravity. ``halo``: a field -> field callable applied to the fresh
        rho and colour gradient before the next sweep reads them (the
        bricks' mid-force owner -> ghost refresh)."""
        return drive_stage(self.force_stage_steps(
            state, tabs, spec, aux, istep, halo_points=halo is not None),
            halo)

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
