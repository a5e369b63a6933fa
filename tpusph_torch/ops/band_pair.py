"""What the strip backend inherits from ``tpusph/ops/band_pair.py``: the
sentinel-dead slot contract, the packed field matrix, the pool resize, the
neighbour-column offsets and image shifts, and the fused force stage (rho
sweep -> rho patch -> colour-gradient sweep -> cg patch -> force sweep ->
gravity). The skin/2 rebuild trigger lives in ``tpusph_torch.grid``.

The reference re-packs an i-array and a materialized window array for its
TPU kernels and patches rows of both after each sweep. The port has no
window array: the sweeps read their windows straight from the slot-major
field matrix, so a patch is a plain write of one of its rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusph_torch.ops.rows import (
    F_ROWS, OCGX, OCGY, ODE, ODRHO, OFX, OFZ, ORHO, OVIR, RCGX, RCGZ, RCV,
    RE, RM, RMIX, RRHO, RTYPE, RVX, RVZ, RX, RZ,
)
from tpusph_torch.params import PhysicsSpec
from tpusph_torch.state import ParticleState

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


def _neighbor_offsets(geom):
    if geom.dim == 3:
        return [(ox, oy) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]
    return [(ox, 0) for ox in (-1, 0, 1)]


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


class BandBackend:
    """The lifecycle the strip backend shares with the reference's band
    backend: pool resize and the fused force stage. Subclasses provide
    ``_sweep(sweep, fld, tabs, spec, aux)`` returning the (8, n_slots)
    output matrix."""

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
                f"strip backend: {tail_alive} alive particles beyond the "
                f"{n}-slot layout capacity")
        return ParticleState(**{f.name: getattr(state, f.name)[:n]
                                for f in dataclasses.fields(state)})

    def force_stage(self, state: ParticleState, tabs, spec: PhysicsSpec,
                    aux, istep: int) -> ParticleState:
        """rho sweep -> rho patch -> cgrad sweep -> cg patch -> force sweep
        -> gravity. ``tabs`` is ``PairTables.stacked``'s device tables."""
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
            fld[RRHO] = rho
        if spec.surface_tension:
            out = self._sweep("cgrad", fld, tabs, spec, aux)
            cg = torch.stack([out[OCGX], out[OCGY], out[ODE]])
            fld[RCGX:RCGZ + 1] = torch.where(alive, cg, 0.0)
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
