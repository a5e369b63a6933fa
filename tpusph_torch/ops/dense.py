"""The dense O(N^2) backend — the counterpart of ``tpusph/ops/dense.py``,
the engine ``Simulation``'s ``auto`` takes at 2,048 particles or fewer and
the correctness oracle of the faster backends.

The reference's dense rung is XLA, not Pallas, so plain PyTorch is its
port. Every pair is visited with the cutoff masking inside the pair terms
(``ops/pair_terms.py``), i.e. the physics of a LAMMPS run with an infinite
neighbour list. The pair terms are evaluated only on the pairs that can
contribute (both alive, i != j, rsq below the sweep's largest cutoff
squared with a 1e-5 margin); every other pair contributes an exact zero.
Those pairs are found once per force stage (positions do not change
between its sweeps) over blocks of i rows, so memory stays O(block x N),
by a float32 matrix product: each periodic coordinate is embedded on a
circle of circumference L, so the squared chord distance is at most the
minimum-image rsq, and with a margin above the product's rounding the
prefilter keeps a superset. dx and rsq are then formed per pair as the
unpruned sweep forms them. A row's terms are scattered into a (block, N)
matrix, zero off the candidate pairs, and summed over j, as the reference
sums its masked pair matrix; the same code runs on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from tpusph_torch import kernels
from tpusph_torch.ops import pair_terms
from tpusph_torch.ops.rows import TABLES_2D
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState

# (i, j) entries per row block: bounds the (block, N) temporaries
_BLOCK_PAIRS = 1 << 21
# pairs at rsq >= cutmax2 * (1 + margin) contribute exactly zero
_CUT_MARGIN = 1e-5
# the float32 chord product's rounding, relative to the largest squared
# feature norm (a 6-term dot product and two norms: well under 1e-6)
_CHORD_ROUNDING = 4e-6


def _fields(state: ParticleState) -> dict:
    return dict(x=state.x, vest=state.vest, rho=state.rho, e=state.e,
                cv=state.cv, rmass=state.rmass, type=state.type.long())


def _row_blocks(n: int):
    b = max(1, min(n, _BLOCK_PAIRS // max(n, 1)))
    return [(i0, min(i0 + b, n)) for i0 in range(0, n, b)]


class PairList(NamedTuple):
    """The candidate pairs, sorted by (i, j): i and j rows, dx = x_i - x_j
    (minimum image) and rsq = |dx|^2."""
    i: torch.Tensor
    j: torch.Tensor
    dx: torch.Tensor
    rsq: torch.Tensor

    def within(self, cut2: float) -> "PairList":
        """The pairs that can contribute to a sweep of largest cutoff
        squared ``cut2``."""
        keep = self.rsq < cut2 * (1.0 + _CUT_MARGIN)
        return PairList(*(t[keep] for t in self))


def _embed(state: ParticleState, box: Box):
    """(n, F) float32 features whose squared distances are at most the
    minimum-image rsq: a periodic coordinate becomes a point on a circle of
    circumference L (chord <= arc), an open one stays (centred on the
    box). Also the margin that covers the product form's rounding."""
    x = state.x.double()
    lo = box.lo.double()
    length = box.length.double()
    cols = []
    for d in range(3):
        if box.periodic[d]:
            a = (2.0 * math.pi) * (x[:, d] - lo[d]) / length[d]
            r = length[d] / (2.0 * math.pi)
            cols += [r * torch.cos(a), r * torch.sin(a)]
        else:
            cols.append(x[:, d] - lo[d] - 0.5 * length[d])
    feat = torch.stack(cols, 1).float()
    sq = (feat * feat).sum(1)
    scale = float(sq.max()) if sq.numel() else 0.0
    return feat, sq, _CHORD_ROUNDING * scale


def pair_list(state: ParticleState, box: Box, cut2: float) -> PairList:
    """Every pair (both alive, i != j) with rsq < cut2 (1 + margin)."""
    x = state.x
    dev = x.device
    n = state.capacity
    feat, sq, slack = _embed(state, box)
    alive = state.alive
    jj = torch.arange(n, device=dev)
    ii, js = [], []
    for i0, i1 in _row_blocks(n):
        chord2 = sq[i0:i1, None] + sq[None, :] \
            - 2.0 * (feat[i0:i1] @ feat.T)
        keep = (alive[i0:i1, None] & alive[None, :]
                & (jj[i0:i1, None] != jj[None, :])
                & (chord2 < cut2 * (1.0 + 10 * _CUT_MARGIN) + slack))
        ib, jb = keep.nonzero(as_tuple=True)
        ii.append(ib + i0)
        js.append(jb)
    i, j = torch.cat(ii), torch.cat(js)
    dx = box.min_image(x[i] - x[j])
    rsq = (dx * dx).sum(-1)
    return PairList(i, j, dx, rsq).within(cut2)


def _row_sum(val: torch.Tensor, pl: PairList, n: int) -> torch.Tensor:
    """(n, ...) sums of the per-pair values into their i rows: per block
    of i rows, a (block, N) matrix of the values, zero off the pairs,
    summed over j."""
    out = torch.zeros((n,) + tuple(val.shape[1:]), dtype=val.dtype,
                      device=val.device)
    blocks = _row_blocks(n)
    bounds = torch.searchsorted(pl.i, torch.tensor(
        [i0 for i0, _ in blocks] + [n], device=val.device)).tolist()
    for k, (i0, i1) in enumerate(blocks):
        a, b = bounds[k], bounds[k + 1]
        full = torch.zeros((i1 - i0, n) + tuple(val.shape[1:]),
                           dtype=val.dtype, device=val.device)
        full[pl.i[a:b] - i0, pl.j[a:b]] = val[a:b]
        out[i0:i1] = full.sum(1)
    return out


def _sides(fields: dict, pl: PairList):
    pi = {k: v[pl.i] for k, v in fields.items()}
    pj = {k: v[pl.j] for k, v in fields.items()}
    return pi, pj


def rho_summation(state: ParticleState, tabs: DeviceTables,
                  spec: PhysicsSpec, box: Box,
                  pairs: PairList | None = None) -> torch.Tensor:
    """sph/rhosum: rho_i = sum_j m_j W(r_ij), the self term included
    (pair_sph_rhosum seeds with m_i W(0)); the number-density form
    multiplies the whole sum by m_i. ``pairs``: a pair list of the same
    positions at a cutoff at least the sweep's."""
    n = state.capacity
    cut2 = tabs.cutmax2["rho"]
    pl = pair_list(state, box, cut2) if pairs is None \
        else pairs.within(cut2)
    fields = _fields(state)
    cut_rho = tabs.tab2[TABLES_2D.index("cut_rho")]
    pi, pj = _sides(fields, pl)
    cut_ij = cut_rho[pi["type"], pj["type"]]
    r = torch.sqrt(torch.clamp(pl.rsq, min=0.0))
    contrib = pair_terms.rho_summation_pair(
        pj, r, cut_ij, pl.rsq < cut_ij * cut_ij, spec)
    rho = _row_sum(contrib, pl, n)
    t = fields["type"]
    self_cut = cut_rho[t, t]
    w0 = kernels.kernel_w(spec.kernel, spec.dim)(
        torch.zeros_like(self_cut), torch.clamp(self_cut, min=1e-30))
    sm = 1.0 if spec.rhosum_nd else state.rmass
    rho = rho + torch.where(state.alive & (self_cut > 0.0), sm * w0, 0.0)
    if spec.rhosum_nd:
        rho = rho * state.rmass
    return torch.where(state.alive, rho, state.rho)


def color_gradient(state: ParticleState, tabs: DeviceTables,
                   spec: PhysicsSpec, box: Box,
                   pairs: PairList | None = None) -> torch.Tensor:
    """sph/colorgradient: the per-particle CSF colour gradient (n, 3)."""
    cut2 = tabs.cutmax2["cgrad"]
    pl = pair_list(state, box, cut2) if pairs is None \
        else pairs.within(cut2)
    pi, pj = _sides(_fields(state), pl)
    r = torch.sqrt(torch.clamp(pl.rsq, min=1e-30))
    coefs = pair_terms.make_pair_coefs(tabs, pi["type"], pj["type"])
    contrib = pair_terms.color_gradient_pair(
        pi, pj, pl.dx, r, coefs, torch.ones_like(pl.rsq, dtype=torch.bool),
        spec)
    cg = _row_sum(contrib, pl, state.capacity)
    return torch.where(state.alive[:, None], cg, 0.0)


def force(state: ParticleState, tabs: DeviceTables, spec: PhysicsSpec,
          box: Box, cg: torch.Tensor | None = None,
          pairs: PairList | None = None):
    """The fused force sweep: (f, drho, de[, vir]) for every alive
    particle."""
    if spec.surface_tension and cg is None:
        cg = color_gradient(state, tabs, spec, box, pairs)
    cut2 = tabs.cutmax2["force"]
    pl = pair_list(state, box, cut2) if pairs is None \
        else pairs.within(cut2)
    pi, pj = _sides(_fields(state), pl)
    kw = dict(cg_i=cg[pl.i], cg_j=cg[pl.j]) if spec.surface_tension else {}
    coefs = pair_terms.make_pair_coefs(tabs, pi["type"], pj["type"])
    out = pair_terms.force_pair(
        pi, pj, pl.dx, pl.rsq, torch.ones_like(pl.rsq, dtype=torch.bool),
        coefs, spec, **kw)
    n = state.capacity
    alive = state.alive
    outs = (torch.where(alive[:, None], _row_sum(out["f"], pl, n), 0.0),
            torch.where(alive, _row_sum(out["drho"], pl, n), 0.0),
            torch.where(alive, _row_sum(out["de"], pl, n), 0.0))
    if spec.virial:
        outs = outs + (torch.where(alive, _row_sum(out["vir"], pl, n),
                                   0.0),)
    return outs


@dataclasses.dataclass(frozen=True)
class DenseAux:
    """The dense backend's per-run data: no layout, so no overflow and no
    rebuild (both counters stay 0 for the host checks)."""
    overflow: torch.Tensor
    nbuilds: torch.Tensor


class DenseBackend:
    """The dense rung with the backend surface ``Runner`` and
    ``forces.compute_forces`` call (``init_aux`` / ``prepare`` /
    ``force_stage``). It has no ``vapor_neighbor``: fix phase_change takes
    the dense vapor query (``phase_change._vapor_neighbor_dense``), as the
    reference does."""

    def __init__(self, box: Box):
        self.box = box

    def init_aux(self, state: ParticleState, box: Box):
        zero = torch.zeros(1, dtype=torch.int32, device=state.device)
        return state, DenseAux(overflow=zero, nbuilds=zero.clone())

    def prepare(self, state: ParticleState, aux: DenseAux, istep: int,
                box: Box):
        """Per-step hook (Domain::pbc): the dense backend has no cell
        topology to keep stale, so positions wrap every step. Returns
        (state, aux, rebuilt)."""
        return dataclasses.replace(state, x=box.wrap(state.x)), aux, False

    def force_stage(self, state: ParticleState, tabs: DeviceTables,
                    spec: PhysicsSpec, aux: DenseAux,
                    istep: int) -> ParticleState:
        """rho (when rhosum fires this step) -> colour gradient -> force,
        then gravity (``tpusph.forces.compute_forces`` over the dense
        module)."""
        box = self.box
        rhosum = spec.rhosum_every > 0 and istep % spec.rhosum_every == 0
        cut2 = max([tabs.cutmax2["force"]]
                   + ([tabs.cutmax2["rho"]] if rhosum else [])
                   + ([tabs.cutmax2["cgrad"]] if spec.surface_tension
                      else []))
        pairs = pair_list(state, box, cut2)
        if rhosum:
            state = dataclasses.replace(
                state, rho=rho_summation(state, tabs, spec, box, pairs))
        cg = color_gradient(state, tabs, spec, box, pairs) \
            if spec.surface_tension else None
        out = force(state, tabs, spec, box, cg=cg, pairs=pairs)
        f, drho, de = out[:3]
        upd = dict(f=f, drho=drho, de=de)
        if spec.virial:
            upd["vir"] = out[3]
        if spec.gravity:
            gmask = (state.alive & state.mobile)[:, None]
            upd["f"] = f + torch.where(
                gmask, state.rmass[:, None] * tabs.gravity[None, :], 0.0)
        return dataclasses.replace(state, **upd)
