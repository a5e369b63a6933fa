"""The aux carried between steps, and the sorted cell grid — the
counterpart of ``tpusph/grid.py``.

Three layouts carry their own aux: the strip backend's ``GridData`` (the
strip subset of the reference's ``GridData``), the band backend's
``BandData`` (the fields the reference's ``band_pair.build_slots`` fills)
and the cell grid's ``CellGridData`` (its cell fields). All carry
``x_ref``, ``overflow`` and ``nbuilds``, which the runner
(freeze-on-overflow), the phase-change hook (the ``x_ref`` bump that
forces a rebuild) and ``Simulation`` read.

The cell grid keeps particles sorted by cell id (cells of side >= cutoff +
skin); a sweep finds a particle's candidates in the 27 (3D) / 9 (2D)
neighbour cells, each holding at most ``cap`` rows. ``build`` equals the
reference's exactly — the same sorted order, counts, starts and ranks —
because the phase-change event rule reads sorted-row indices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpusph_torch.state import Box, ParticleState


@dataclasses.dataclass(frozen=True)
class GridData:
    """Per-rebuild device data of the strip layout."""
    counts: torch.Tensor        # (ncols,) i64 live particles per column
    x_ref: torch.Tensor         # (N, 3) positions at build (skin trigger)
    overflow: torch.Tensor      # (1,) i64 dropped rows + window violations
    nbuilds: torch.Tensor       # (1,) i64 cumulative rebuild count
    # (ncols, nnbr, nblocks) i32 window-retarget offsets in blocks
    delta: torch.Tensor
    # seam-ghost copy map: source row, destination row, column-axis shift;
    # re-copied EVERY step (StripBackend.refresh_seam)
    seam_src: torch.Tensor
    seam_dest: torch.Tensor
    seam_shift: torch.Tensor
    # (2,) worst coverage shortfall in rows (below, above), clipped at 0
    margin_short: torch.Tensor
    # (2,) unclipped worst need-minus-window in rows (negative = slack)
    margin_need: torch.Tensor
    # per-slot three-valued mixed-phase flag (StripBackend._mixed_flags)
    mix: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class BandData:
    """Per-rebuild device data of the band's slot-resident layout (slot =
    sub-cell * c + rank)."""
    cell_id: torch.Tensor       # (N,) i64 sub-cell of each slot; dead -> ncells
    starts: torch.Tensor        # (ncells+1,) i64 first slot of each sub-cell
    counts: torch.Tensor        # (ncells,) i64 particles binned per sub-cell
    rank: torch.Tensor          # (N,) i64 slot within its sub-cell
    x_ref: torch.Tensor         # (N, 3) positions at build (skin trigger)
    overflow: torch.Tensor      # (1,) i64 particles dropped (rank >= c)
    nbuilds: torch.Tensor       # (1,) i64 cumulative rebuild count
    # the band has no mixed-phase flag: its sweeps always run the
    # colour-gradient and capillary terms (the shared force stage reads it)
    mix: None = None


@dataclasses.dataclass(frozen=True)
class CellGridData:
    """Per-build device data of the cell grid, over the SORTED order."""
    cell_id: torch.Tensor       # (N,) i64 cell of each row; dead -> ncells
    starts: torch.Tensor        # (ncells+1,) i64 first row of each cell
    counts: torch.Tensor        # (ncells,) i64 occupancy
    rank: torch.Tensor          # (N,) i64 index within its cell
    x_ref: torch.Tensor         # (N, 3) positions at build (skin trigger)
    overflow: torch.Tensor      # (1,) i64 rows beyond cap in any cell
    nbuilds: torch.Tensor       # (1,) i64 cumulative rebuild count


class GridGeometry(NamedTuple):
    """Static cell-grid geometry (``tpusph.grid.GridGeometry``)."""
    ncells: Tuple[int, int, int]   # cells per axis (z = 1 in 2D)
    cell_size: Tuple[float, float, float]
    origin: Tuple[float, float, float]
    cap: int                       # max particles per cell
    dim: int
    periodic: Tuple[bool, bool, bool]
    skin: float

    @property
    def total_cells(self) -> int:
        return self.ncells[0] * self.ncells[1] * self.ncells[2]

    @property
    def nstencil(self) -> int:
        return 27 if self.dim == 3 else 9


def make_geometry(box: Box, cutoff: float, dim: int, skin: float = 0.0,
                  cap: int | None = None,
                  avg_per_cell: float | None = None) -> GridGeometry:
    """Host-side geometry (Neighbor::setup_bins): cell side >= cutoff +
    skin, stretched to tile the box; ``cap`` defaults as the reference's.
    The arithmetic is the reference's numpy, on the box's float32 bounds,
    so the geometry equals it field for field."""
    lo = box.lo.cpu().numpy()
    hi = box.hi.cpu().numpy()
    length = hi - lo
    side = cutoff + skin
    if side <= 0:
        raise ValueError("cutoff + skin must be positive")
    nc = np.maximum(np.floor(length / side).astype(int), 1)
    if dim == 2:
        nc[2] = 1
    size = length / nc
    if dim == 2:
        size[2] = max(length[2], 1.0)
    if cap is None:
        if avg_per_cell is not None:
            cap = int(math.ceil(avg_per_cell * 1.8 / 8.0) * 8)
        else:
            cap = 64 if dim == 3 else 32
    return GridGeometry(
        ncells=tuple(int(v) for v in nc),
        cell_size=tuple(float(v) for v in size),
        origin=tuple(float(v) for v in lo),
        cap=int(cap), dim=dim, periodic=box.periodic, skin=float(skin))


def cell_coords(x: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """(N, 3) positions -> (N, 3) integer cell coordinates, clamped on
    non-periodic axes, wrapped on periodic ones. The float32 divide is a
    tensor-by-tensor true division, as the reference's, so a position on a
    cell edge bins the same way."""
    dev = x.device
    origin = torch.tensor(geom.origin, dtype=torch.float32, device=dev)
    size = torch.tensor(geom.cell_size, dtype=torch.float32, device=dev)
    nc = torch.tensor(geom.ncells, dtype=torch.int64, device=dev)
    c = torch.floor((x - origin) / size).to(torch.int64)
    per = torch.tensor(geom.periodic, device=dev)
    return torch.where(per, torch.remainder(c, nc),
                       torch.minimum(torch.clamp(c, min=0), nc - 1))


def flat_cell_id(coords: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    _, ncy, ncz = geom.ncells
    return (coords[..., 0] * ncy + coords[..., 1]) * ncz + coords[..., 2]


def build(state: ParticleState, geom: GridGeometry, extra=None,
          nbuilds: torch.Tensor | None = None):
    """Sort particles by cell id (stable) and build the cell index
    (Neighbor::build + the atom sort). Dead rows take the sentinel cell
    (= total_cells) and sort to the end. Returns (state, CellGridData).

    ``extra``: a dict of tensors with a leading (N,) row axis, permuted as
    the rows are (the bricks carry their halo markers through the sort
    with it); then returns (state, CellGridData, extra permuted)."""
    n = state.capacity
    dev = state.device
    ncells = geom.total_cells
    cid = flat_cell_id(cell_coords(state.x, geom), geom)
    cid = torch.where(state.alive, cid, ncells)
    cid, perm = torch.sort(cid, stable=True)
    state = state.permute(perm)
    if extra is not None:
        extra = {k: v[perm] for k, v in extra.items()}
    counts = torch.zeros(ncells + 1, dtype=torch.int64, device=dev
                         ).index_add_(0, cid, torch.ones_like(cid))[:ncells]
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)])
    idx = torch.arange(n, device=dev)
    rank = idx - starts[torch.clamp(cid, max=ncells - 1)]
    rank = torch.where(cid < ncells, rank, idx - starts[ncells])
    overflow = torch.clamp(counts - geom.cap, min=0).sum().reshape(1)
    if nbuilds is None:
        nbuilds = torch.zeros(1, dtype=torch.int64, device=dev)
    data = CellGridData(cell_id=cid, starts=starts, counts=counts,
                        rank=rank, x_ref=state.x, overflow=overflow,
                        nbuilds=nbuilds + 1)
    if extra is not None:
        return state, data, extra
    return state, data


def needs_rebuild(state: ParticleState, x_ref: torch.Tensor,
                  skin: float) -> bool:
    """Neighbor::decide() displacement trigger (skin/2); one host sync."""
    if skin <= 0.0:
        return True
    disp = state.x - x_ref
    d2 = torch.where(state.alive[:, None], disp * disp, 0.0).sum(-1)
    return bool(d2.max() > (0.5 * skin) ** 2)


def stencil_offsets(geom: GridGeometry) -> np.ndarray:
    """The (S, 3) neighbour-cell offsets: the full 27 (3D) / 9 (2D)
    stencil, in the reference's order."""
    r = (-1, 0, 1)
    if geom.dim == 3:
        offs = [(i, j, k) for i in r for j in r for k in r]
    else:
        offs = [(i, j, 0) for i in r for j in r]
    return np.asarray(offs, np.int32)


def neighbor_cell_ids(geom: GridGeometry) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (ncells, S) neighbour cell ids and (ncells, S, 3) image
    shifts in box lengths (``tpusph.grid.neighbor_cell_ids``, line for
    line). Out-of-range neighbours on non-periodic axes map to the
    sentinel cell (ncells), which holds no particle."""
    ncx, ncy, ncz = geom.ncells
    ncells = geom.total_cells
    offs = stencil_offsets(geom)
    cx, cy, cz = np.meshgrid(np.arange(ncx), np.arange(ncy), np.arange(ncz),
                             indexing="ij")
    coords = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)
    nbr = coords[:, None, :] + offs[None, :, :]
    nc = np.array([ncx, ncy, ncz])
    per = np.array(geom.periodic)
    wrapped = np.mod(nbr, nc)
    # box lengths to ADD to the neighbour cell's positions to bring them
    # next to this cell
    shift = np.where(per, np.floor_divide(nbr, nc).astype(np.float32), 0.0)
    out_of_range = (~per) & ((nbr < 0) | (nbr >= nc))
    valid = ~np.any(out_of_range, axis=-1)
    nbr_clamped = np.where(per, wrapped, np.clip(nbr, 0, nc - 1))
    flat = (nbr_clamped[..., 0] * ncy + nbr_clamped[..., 1]) * ncz \
        + nbr_clamped[..., 2]
    flat = np.where(valid, flat, ncells).astype(np.int32)
    return flat, shift.astype(np.float32)
