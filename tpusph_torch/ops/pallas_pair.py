"""The column kernel's backend on torch — the counterpart of
``tpusph/ops/pallas_pair.py``: the column layout (``ColumnGrid``,
``pack_dense``, ``unpack_dense``), the rho / colour-gradient / force sweeps
over cell columns as hand-written CUDA kernels (``csrc/column_sweeps.cu``)
with their plain PyTorch version, and ``PallasBackend``, which runs them
on the sorted cell grid (``ops/cellgrid.py``).

The port's idiom replaces the reference's dense (ncols, ncz, F, cap) array
with one (F_ROWS, n_slots) field matrix: slot = cell * cap + rank with
cell = column * ncz + cz (the reference's flat cell id), empty slots zero
with type 0; and one (8, n_slots) output matrix. The all-dead sentinel
column the reference appends for a non-periodic plane edge becomes an
index test in the kernel. The reference's one-hot MXU coefficient lookups
become table reads from shared memory.

The reached configurations: a phase-change run that cannot strip (the
``auto`` ladder in ``api.Simulation``), and any run with
``backend_name = "pallas"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch.forces import drive_stage
from tpusph_torch.grid import CellGridData, GridGeometry
from tpusph_torch.ops import cuda_build
from tpusph_torch.ops.band_pair import (
    _live_pairs, check_inputs, live_reach, pack_fields, plain_pair_sweep,
    spec_flags,
)
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.ops.rows import (
    F_ROWS, OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, OVIR, RCGX, RCGZ,
    RM, RRHO, RTYPE,
)
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState

# largest cell capacity the kernels take (one thread per slot of a cell)
MAX_CAP = 512


class ColumnGrid(NamedTuple):
    """Static column geometry derived from GridGeometry
    (``tpusph.ops.pallas_pair.ColumnGrid``)."""
    ncx: int
    ncy: int          # 1 in 2D
    ncz: int          # cells per column (innermost axis)
    cap: int
    dim: int
    periodic: tuple
    lengths: tuple    # box lengths (Lx, Ly, Lz)
    col_axis: int     # 2 in 3D, 1 in 2D

    @property
    def ncols(self) -> int:
        return self.ncx * self.ncy if self.dim == 3 else self.ncx

    @property
    def nnbr(self) -> int:
        return 9 if self.dim == 3 else 3

    @property
    def col_cap(self) -> int:
        return self.ncz * self.cap

    @property
    def n_slots(self) -> int:
        return self.ncols * self.col_cap


def make_column_grid(geom: GridGeometry, box: Box) -> ColumnGrid:
    ncx, ncy, ncz = geom.ncells
    L = tuple(float(v) for v in (box.hi - box.lo).cpu().numpy())
    if geom.dim == 3:
        return ColumnGrid(ncx, ncy, ncz, geom.cap, 3, geom.periodic, L, 2)
    # 2D: the grid is (ncx, ncy, 1); columns run along y
    return ColumnGrid(ncx, 1, ncy, geom.cap, 2, geom.periodic, L, 1)


# --------------------------------------------------------------------------
# packing: sorted rows <-> the slot-major field and output matrices
# --------------------------------------------------------------------------

def pack_dense(state: ParticleState, data: CellGridData, cg: ColumnGrid):
    """(fld, flat_pos, ok): the (F_ROWS, n_slots) field matrix of the
    sorted rows at slot cell_id * cap + rank, empty slots zero; each row's
    slot, and whether the row has one (alive, in a cell, rank < cap). The
    colour-gradient rows start at zero (the force stage patches them)."""
    n = cg.n_slots
    ok = state.alive & (data.rank < cg.cap) & (data.cell_id < cg.ncols
                                                * cg.ncz)
    flat_pos = torch.where(ok, data.cell_id * cg.cap + data.rank, n)
    fld = torch.zeros(F_ROWS, n + 1, dtype=torch.float32,
                      device=state.device)
    fld[:, flat_pos] = torch.where(ok, pack_fields(state), 0.0)
    return fld[:, :n].contiguous(), flat_pos, ok


def _patch_rows(fld: torch.Tensor, rows, flat_pos: torch.Tensor,
                vals: torch.Tensor):
    """fld[rows[r], slot of each sorted row] = vals[r]; rows without a slot
    (flat_pos = n_slots) are dropped."""
    n = fld.shape[1]
    for r, v in zip(rows, vals):
        ext = torch.cat([fld[r], fld.new_zeros(1)])
        ext[flat_pos] = v
        fld[r] = ext[:n]


def unpack_dense(out: torch.Tensor, flat_pos: torch.Tensor, ok, rows):
    """The (8, n_slots) output rows ``rows`` gathered back to the sorted
    rows; rows without a slot read 0."""
    safe = torch.where(ok, flat_pos, 0)
    return [torch.where(ok, out[r].index_select(0, safe), 0.0)
            for r in rows]


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _column_neighbors(cg: ColumnGrid):
    """Host-side (ncells, S) neighbour cell (-1: none past a non-periodic
    edge) and (ncells, S, 3) float32 image shift of each of the 27 (3D) /
    9 (2D) neighbour cells the kernel visits: +-L where the neighbour wraps
    across a periodic axis, so x_j + shift sits next to the cell."""
    if cg.dim == 3:
        nc = np.array([cg.ncx, cg.ncy, cg.ncz])
        offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)]
    else:
        nc = np.array([cg.ncx, cg.ncz, 1])
        offs = [(a, b, 0) for a in (-1, 0, 1) for b in (-1, 0, 1)]
    per = np.array(cg.periodic)
    L = np.asarray(cg.lengths, np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(v) for v in nc],
                                  indexing="ij"), -1).reshape(-1, 3)
    nbr = coords[:, None, :] + np.asarray(offs)[None, :, :]
    lo, hi = nbr < 0, nbr >= nc
    valid = ~np.any((lo | hi) & ~per, axis=-1)
    shift = np.where(per & lo, -L, np.where(per & hi, L, np.float32(0.0)))
    w = np.mod(nbr, nc)
    cell = (w[..., 0] * nc[1] + w[..., 1]) * nc[2] + w[..., 2]
    return (np.where(valid, cell, -1).astype(np.int64),
            shift.astype(np.float32))


def _column_pairs(fld: torch.Tensor, cg: ColumnGrid, c0: int, c1: int,
                  cutmax2: float, reach: int):
    """The live pairs (``band_pair._live_pairs``) of the i cells [c0, c1)
    over the kernel's 27 (3D) / 9 (2D) neighbour cells with their image
    shift. Only ranks below ``reach`` (``live_reach``) are looked at."""
    dev = fld.device
    cap = cg.cap
    jcell, shift = (torch.as_tensor(a, device=dev)
                    for a in _column_neighbors(cg))
    k = torch.arange(reach, device=dev)
    islot = torch.arange(c0, c1, device=dev)[:, None] * cap + k  # (C, reach)
    jc = jcell[c0:c1]                                         # (C, S)
    jslot = (jc.clamp(min=0)[:, :, None] * cap + k).flatten(1)  # (C, M)
    jok = (jc >= 0)[:, :, None].expand(-1, -1, reach).flatten(1)
    return _live_pairs(fld, islot, jslot, jok,
                       shift[c0:c1].repeat_interleave(reach, dim=1), cutmax2)


def plain_column_sweep(sweep: str, fld: torch.Tensor, tabs: DeviceTables,
                       cg: ColumnGrid, spec: PhysicsSpec) -> torch.Tensor:
    """The plain PyTorch version of one column sweep, on any device.

    Same contract as the CUDA kernel: for i slot s of cell c, the
    candidates are the slots of the 27 (3D) / 9 (2D) neighbour cells, with
    their image shift; a pair needs both types alive and 1e-12 < rsq (the
    TPU kernel's mask), and pairs beyond the sweep's largest cutoff are
    dropped first (``_column_pairs``); then ``plain_pair_sweep``, whose
    rho sweep adds the self term. Returns the (8, n_slots) output matrix
    with the sweep's O* rows filled on alive slots, zero elsewhere."""
    reach = live_reach(fld, cg.cap)
    return plain_pair_sweep(
        sweep, fld, tabs, spec, cg.ncols * cg.ncz, cg.cap,
        reach * reach * 3 * cg.nnbr,
        lambda c0, c1, cut2: _column_pairs(fld, cg, c0, c1, cut2, reach))


class ColumnSweepKernel(cuda_build.LaunchCount):
    """Wrapper of one CUDA column sweep (``column_{launcher}_launch``).

    Replaces ``tpusph.ops.pallas_pair.make_column_kernel(sweep=...)`` (the
    ``pl.pallas_call`` at pallas_pair.py:542). CPU tensors take the plain
    version (``plain_column_sweep``); CUDA tensors launch the kernel or
    raise. ``launches`` and ``by_card`` count kernel launches only.

    On the card the sweeps are bound by instruction throughput: each i row
    has 27 cells of candidates (~1,700 rows to the cells' live reach at the
    1M bench's ~64 rows a cell), ~110 of them within the cutoff. All three
    sweeps filter before they compute (``csrc/cell_sweep.cuh``, the band's
    kernel on the column layout): a block per cell and chunk of up to 128
    ranks, so the chunks past a cell's alive rows exit at once and a cap
    set by one dense cell costs the other cells nothing. A cell's alive
    rows are a prefix of its ranks (``grid.build`` sorts them first,
    ``pack_dense`` drops the rest, an insertion forces a rebuild first), so
    the block finds each staged cell's live reach by a binary search over
    its types, not by reading the cap. Per neighbour column the three
    cells are staged to their reach; a warp's box filter and each lane's
    exact test of the survivors follow. Force runs a warp pair queue, the
    body 32 live pairs a pass; rho and the colour gradient add each live
    pair at once, and the colour gradient stages only rows of a colour
    unlike one of the block's alive rows (its ballot pass over the alive
    prefixes only), so a block far from an interface exits unwritten.
    Each row adds its pairs in the one-pass scan's order (the same bits);
    ``cell_filter.cell_pass_counts`` gives the phases' counts. The
    one-pass scans are ``column_rho_scan``, ``column_cgrad_scan`` and
    ``column_force_scan`` (``SCANS``, launchers ``*_scan``), check
    kernels that no path launches: the filtered sweeps are held to them
    bit for bit on the card."""

    def __init__(self, sweep: str, launcher: str | None = None):
        self.sweep = sweep
        self.launcher = launcher or sweep
        super().__init__()

    def __call__(self, fld: torch.Tensor, tabs: DeviceTables,
                 cg: ColumnGrid, spec: PhysicsSpec) -> torch.Tensor:
        n, T1 = cg.n_slots, tabs.tab1.shape[1]
        check_inputs(f"column {self.launcher} sweep", fld, (
            ("fld", fld, (F_ROWS, n), torch.float32),
            ("tab2", tabs.tab2, (8, T1, T1), torch.float32),
            ("tab1", tabs.tab1, (5, T1), torch.float32)))
        if not 1 <= cg.cap <= MAX_CAP:
            raise ValueError(f"column {self.launcher} sweep: cell capacity "
                             f"{cg.cap} outside [1, {MAX_CAP}]")
        if fld.device.type == "cpu":
            return plain_column_sweep(self.sweep, fld, tabs, cg, spec)
        out = torch.zeros(8, n, dtype=torch.float32, device=fld.device)
        per = cg.periodic
        cuda_build.launch_column(
            self.launcher, fld, tabs.tab2, tabs.tab1, out, n_slots=n,
            ncx=cg.ncx, ncy=cg.ncy, ncz=cg.ncz, cap=cg.cap, dim=cg.dim,
            per_x=int(per[0]), per_y=int(cg.dim == 3 and per[1]),
            per_col=int(per[cg.col_axis]), kernel=spec.kernel,
            flags=spec_flags(spec), T1=T1, lx=cg.lengths[0],
            ly=cg.lengths[1], lcol=cg.lengths[cg.col_axis],
            cutmax2=tabs.cutmax2[self.sweep])
        self.count(fld.device)
        return out


column_rho = ColumnSweepKernel("rho")
column_cgrad = ColumnSweepKernel("cgrad")
column_force = ColumnSweepKernel("force")
# every kernel wrapper of the column backend, by sweep (launch counts)
KERNELS = {"rho": column_rho, "cgrad": column_cgrad, "force": column_force}
# the one-pass scans: on no path, the filtered sweeps' bitwise checks
column_rho_scan = ColumnSweepKernel("rho", "rho_scan")
column_cgrad_scan = ColumnSweepKernel("cgrad", "cgrad_scan")
column_force_scan = ColumnSweepKernel("force", "force_scan")
SCANS = {"rho": column_rho_scan, "cgrad": column_cgrad_scan,
         "force": column_force_scan}


# --------------------------------------------------------------------------
# backend
# --------------------------------------------------------------------------

class PallasBackend:
    """The column kernel's backend: the cell-grid lifecycle (sort,
    rebuild, vapor query) and the fused force stage over the column
    layout. The pool keeps its capacity (the cell grid is not slot
    resident). Single device."""

    def __init__(self, geom: GridGeometry, box: Box, ntypes: int,
                 rebuild_every: int = 0, device="cpu"):
        self.geom = geom
        self.ntypes = ntypes
        self._cells = CellGridBackend(geom, rebuild_every, device)
        self.colgrid = make_column_grid(geom, box)

    def init_aux(self, state: ParticleState, box: Box):
        return self._cells.init_aux(state, box)

    def prepare(self, state: ParticleState, aux: CellGridData, istep: int,
                box: Box):
        return self._cells.prepare(state, aux, istep, box)

    def vapor_neighbor(self, state: ParticleState, box: Box, vtype: int,
                       cut: float, aux: CellGridData):
        return self._cells.vapor_neighbor(state, box, vtype, cut, aux)

    def force_stage_steps(self, state: ParticleState, tabs: DeviceTables,
                          spec: PhysicsSpec, aux: CellGridData, istep: int,
                          halo_points: bool = False):
        """One pack, then rho sweep -> rho patch -> cgrad sweep -> cg patch
        -> force sweep on the field matrix, the outputs gathered back to
        the sorted rows, then gravity (``tpusph``'s
        ``PallasBackend.force_stage``). The rho sweep folds the self term
        in, where the reference adds it per type after the kernel.

        A generator (``forces.drive_stage``): with ``halo_points`` it
        yields the fresh rho (n,) of the sorted rows (every step of a
        rhosum run) and their colour gradient (n, 3), and patches the
        fields it is sent back into the field matrix before the next sweep
        (the reference's bricks run its per-sweep methods with a halo
        refresh between them)."""
        cg = self.colgrid
        alive = state.alive
        fld, flat_pos, ok = pack_dense(state, aux, cg)
        rho = state.rho
        if spec.rhosum_every > 0:
            total = column_rho(fld, tabs, cg, spec)[ORHO]
            if spec.rhosum_nd:
                total = total * fld[RM]
            if istep % spec.rhosum_every == 0:
                fld[RRHO] = torch.where(fld[RTYPE] > 0.5, total, fld[RRHO])
                (new,) = unpack_dense(fld, flat_pos, ok, (RRHO,))
                rho = torch.where(ok, new, state.rho)
            if halo_points:
                rho = yield rho
                _patch_rows(fld, (RRHO,), flat_pos, rho[None, :])
        if spec.surface_tension:
            out = column_cgrad(fld, tabs, cg, spec)
            fld[RCGX:RCGZ + 1] = out[[OCGX, OCGY, ODE]]
            if halo_points:
                cgr = torch.stack(unpack_dense(out, flat_pos, ok,
                                               (OCGX, OCGY, ODE)), 1)
                cgr = yield cgr
                _patch_rows(fld, (RCGX, RCGX + 1, RCGZ), flat_pos, cgr.T)
        out = column_force(fld, tabs, cg, spec)
        rows = (OFX, OFY, OFZ, ODRHO, ODE) + ((OVIR,) if spec.virial
                                                  else ())
        got = unpack_dense(out, flat_pos, ok, rows)
        upd = dict(
            rho=rho,
            f=torch.where(alive[:, None], torch.stack(got[:3], 1), 0.0),
            drho=torch.where(alive, got[3], 0.0),
            de=torch.where(alive, got[4], 0.0))
        if spec.virial:
            upd["vir"] = torch.where(alive, got[5], 0.0)
        if spec.gravity:
            gmask = (alive & state.mobile)[:, None]
            upd["f"] = upd["f"] + torch.where(
                gmask, state.rmass[:, None] * tabs.gravity[None, :], 0.0)
        return dataclasses.replace(state, **upd)

    def force_stage(self, state: ParticleState, tabs: DeviceTables,
                    spec: PhysicsSpec, aux: CellGridData, istep: int,
                    halo=None) -> ParticleState:
        """``force_stage_steps`` run to its end; ``halo``: a field ->
        field callable applied to the fresh rho and colour gradient before
        the next sweep reads them (the bricks' mid-force owner -> ghost
        refresh)."""
        return drive_stage(self.force_stage_steps(
            state, tabs, spec, aux, istep, halo_points=halo is not None),
            halo)
