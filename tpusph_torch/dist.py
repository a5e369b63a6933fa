"""Spatial domain decomposition into bricks with halo exchange — the
counterpart of ``tpusph/dist.py`` (the reference's MPI brick decomposition
and halo exchange: comm.cpp setup / forward_comm / exchange / borders,
procgrid; SURVEY.md §2.5, §5.7).

Design
------
The box is split into ``shape[k]`` bricks along each decomposed spatial
axis ``axes[k]``; the linear brick id is row-major over ``shape``. Every
brick stores positions BRICK-LOCAL along every decomposed axis (x_local =
x_global - brick offset), so a payload moving up an axis subtracts the
sender's width and one moving down adds the receiver's, across the
periodic seam too, and every brick runs the same code.

The reference is single-controller: one program drives every brick
through ``shard_map``, and a ring transfer is a ``lax.ppermute`` over the
linear brick index. The port keeps that shape: one process holds the
bricks as a list of per-brick ``ParticleState``s and aux objects, each on
its own ``torch.device`` (``set_mesh`` places them round-robin over every
visible card: one brick per card on a node of four, all on ``cuda:0``
where one card is visible; all on ``cpu`` in the CPU tests), and
``_shift_axis`` is a rotation of that list by the axis stride, each
received tensor moved with ``.to(dst_device)`` (a plain hand-over on the
same device; between two cards PyTorch orders the copy after the work
queued on both cards' current streams). Each brick's kernels launch on
its own card (``cuda_build._call`` enters the card's device guard), and
the plain tensor ops follow their tensors. A ``torch.distributed``
transport under the same interface (one process per card) is later work.

Comm is staged per axis, as the reference's six-direction sends: exchange
and borders run axis 0 first, then axis 1 (whose edge slabs include axis-0
ghosts), so corner neighbours are resolved in two hops without diagonal
sends.

  Comm::exchange   (migration)   -> masked fixed-capacity pack + shift
  Comm::borders    (ghost setup) -> edge-slab pack + shift; ghosts merged
                                    into the local pool as owned=False
  Comm::forward_comm (each step) -> gather at persistent send rows + shift
                                    + scatter to persistent ghost rows
                                    (x, vest, rho, e in one (n, 8) matrix)
  Pair::pack_forward_comm        -> owner -> ghost refresh of rho and the
                                    colour gradient between the sweeps
  Comm::reverse_comm             -> none: no Newton halving, owners compute
                                    full sums from ghosts

A rebuild (exchange + borders + sort) fires when ANY brick's largest
displacement exceeds skin/2 (the reference's psum'd trigger). Between
rebuilds the send-row / ghost-row correspondence is persistent; the sort
carries it as marker columns (``grid.build`` / ``build_strips``'s
``extra``). All buffers have a fixed capacity with overflow counted on the
device: a selection is a cumsum rank and a scatter into a buffer one row
longer than the capacity, whose last row is dropped (``jnp.nonzero(size=)``
and ``.at[].set(mode="drop")`` in the reference).

Inside each brick runs an inner backend: the strip (its CUDA kernels on
the card), the column kernel, or the cell grid's plain sweeps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpusph_torch import grid as gridlib
from tpusph_torch import integrate
from tpusph_torch.ops.band_pair import _scatter_rows
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.runner import _mark, _PhaseTimer
from tpusph_torch.state import Box, ParticleState, state_from_numpy

# the payload of borders and migration; rho_c / e_c, the Kahan
# compensations, migrate with their particle
_ALL_FIELDS = ("x", "v", "vest", "f", "rho", "drho", "e", "de", "cv",
               "rmass", "type", "tag", "mobile", "rho_c", "e_c")


class BrickSpec(NamedTuple):
    """Static decomposition geometry (``tpusph.dist.BrickSpec``).
    ``shape[k]`` bricks along spatial axis ``axes[k]``; the linear brick id
    is row-major over ``shape``."""
    ndev: int
    axes: Tuple[int, ...]      # decomposed spatial axes, e.g. (0,) or (0, 1)
    shape: Tuple[int, ...]     # bricks per decomposed axis; prod == ndev
    lo: Tuple[float, ...]      # global box lo along each decomposed axis
    width: Tuple[float, ...]   # brick width along each decomposed axis
    margin: float              # halo margin = cutoff + skin
    ghost_cap: int             # max ghosts per side
    migrate_cap: int           # max migrants per side per rebuild
    periodic: Tuple[bool, ...]  # global periodicity along each decomposed axis
    # non-uniform brick boundaries per axis (balance.cpp analog): relative
    # to ``lo[k]``, length shape[k]+1, cuts[0]=0, cuts[-1]=axis length.
    # None = uniform bricks of ``width[k]``.
    cuts: Tuple[Tuple[float, ...], ...] | None = None

    @property
    def naxes(self) -> int:
        return len(self.axes)

    def widths_of(self, k: int) -> np.ndarray:
        """Per-brick widths along decomposed axis k (host array)."""
        if self.cuts is None:
            return np.full(self.shape[k], self.width[k])
        return np.diff(np.asarray(self.cuts[k], np.float64))

    def offsets_of(self, k: int) -> np.ndarray:
        """Per-brick frame origin along axis k, relative to lo[k]."""
        if self.cuts is None:
            return np.arange(self.shape[k]) * self.width[k]
        return np.asarray(self.cuts[k][:-1], np.float64)

    def max_width(self, k: int) -> float:
        return float(self.widths_of(k).max())

    @property
    def axis_dim(self) -> int:
        return self.axes[0]

    def coords_of(self, b):
        """Linear brick id -> per-decomposed-axis coordinates. Row-major:
        axis 0 slowest."""
        out = []
        for k in range(self.naxes - 1, -1, -1):
            out.append(b % self.shape[k])
            b = b // self.shape[k]
        return tuple(reversed(out))

    def stride(self, k: int) -> int:
        """Linear-index stride of one step along decomposed axis k."""
        s = 1
        for kk in range(k + 1, self.naxes):
            s *= self.shape[kk]
        return s


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t,
                      np.float64)


def local_box(spec: BrickSpec, box_global: Box, device=None) -> Box:
    """The per-brick local box: [-margin, width+margin) and non-periodic
    along decomposed axes (ghosts materialize cross-brick images
    explicitly), global extent and periodicity elsewhere. Sized for the
    widest brick (non-uniform cuts leave narrow bricks with empty
    space)."""
    lo = _host(box_global.lo).copy()
    hi = _host(box_global.hi).copy()
    per = list(box_global.periodic)
    for k, ax in enumerate(spec.axes):
        lo[ax] = -spec.margin
        hi[ax] = spec.max_width(k) + spec.margin
        per[ax] = False
    dev = box_global.lo.device if device is None else device
    return Box.create(lo, hi, tuple(per), device=dev)


def brick_local_positions(x: np.ndarray, spec: BrickSpec, box_global: Box):
    """Each brick's particle view INCLUDING its margin ghosts, in
    brick-local coordinates: the worst-case occupancy input for the shared
    strip geometry choice (every brick runs one layout)."""
    x = np.asarray(x, np.float64)
    lo_g, hi_g = _host(box_global.lo), _host(box_global.hi)
    views = []
    for b in range(spec.ndev):
        coords = spec.coords_of(b)
        member = np.ones(len(x), bool)
        local = x.copy()
        for k, ax in enumerate(spec.axes):
            off = spec.offsets_of(k)[coords[k]]
            w_b = spec.widths_of(k)[coords[k]]
            rel = x[:, ax] - spec.lo[k]
            if spec.periodic[k]:
                length = float(hi_g[ax] - lo_g[ax])
                rel_m = np.mod(rel - (off - spec.margin), length)
                member &= rel_m < w_b + 2 * spec.margin
                local[:, ax] = rel_m - spec.margin
            else:
                member &= (rel >= off - spec.margin) & \
                    (rel < off + w_b + spec.margin)
                local[:, ax] = rel - off
        views.append(local[member].astype(np.float32))
    return views


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def _shift_axis(arrs: list, spec: BrickSpec, k: int, direction: int,
                devices: list) -> list:
    """The ring transfer along decomposed axis k: with direction +1 brick
    i's entry goes to its coordinate+1 neighbour (wrapping); entries are
    tensors or dicts of tensors, moved to the receiver's device."""
    sk = spec.shape[k]
    stride = spec.stride(k)
    out = [None] * spec.ndev
    for i in range(spec.ndev):
        c = (i // stride) % sk
        j = i + ((c + direction) % sk - c) * stride
        a = arrs[i]
        out[j] = ({f: _to(v, devices[j]) for f, v in a.items()}
                  if isinstance(a, dict) else _to(a, devices[j]))
    return out


def _select_rows(mask: torch.Tensor, cap: int):
    """First ``cap`` set rows of mask -> (rows (cap,) with n past the
    last, count (1,), overflow (1,)), without a host sync."""
    n = mask.shape[0]
    dev = mask.device
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    rows = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    rows.scatter_(0, torch.where(mask & (rank < cap), rank, cap),
                  torch.arange(n, device=dev))
    total = mask.sum().reshape(1)
    return rows[:cap], torch.clamp(total, max=cap), \
        torch.clamp(total - cap, min=0)


def _pack_rows(state: ParticleState, rows: torch.Tensor,
               count: torch.Tensor) -> dict:
    """Gather the full payload at ``rows``; entries >= count are dead."""
    cap = rows.shape[0]
    valid = torch.arange(cap, device=rows.device) < count
    r = torch.clamp(rows, 0, state.capacity - 1)
    out = {}
    for f in _ALL_FIELDS:
        v = getattr(state, f)[r]
        mask = valid if v.dim() == 1 else valid[:, None]
        out[f] = torch.where(mask, v, torch.zeros_like(v))
    return out


def _merge_payload(state: ParticleState, payload: dict, owned_val: bool,
                   used_dead: int = 0):
    """Activate dead slots for the payload's valid rows (type > 0). Dead
    slots are consumed in ascending row order from offset ``used_dead``,
    so successive merges use disjoint slots and keep buffer order (the
    ghost bookkeeping after the sort relies on it). Returns (state,
    overflow (1,))."""
    n = state.capacity
    dev = state.device
    g = payload["type"].shape[0]
    dead = ~state.alive
    rank_dead = torch.cumsum(dead.to(torch.int64), 0) - 1
    dead_idx = torch.full((n + 1,), n, dtype=torch.int64, device=dev
                          ).scatter_(0, torch.where(dead, rank_dead, n),
                                     torch.arange(n, device=dev))[:n]
    slot = torch.arange(g, device=dev) + used_dead
    valid = payload["type"] > 0
    can = valid & (slot < dead.sum())
    target = torch.where(can, dead_idx[torch.clamp(slot, 0, n - 1)], n)
    new = {f: _scatter_rows(getattr(state, f), target, payload[f], n)
           for f in _ALL_FIELDS}
    new["owned"] = _scatter_rows(
        state.owned, target,
        torch.full((g,), owned_val, dtype=torch.bool, device=dev), n)
    overflow = (valid & ~can).sum().reshape(1)
    return dataclasses.replace(state, **new), overflow


@dataclasses.dataclass(frozen=True)
class BrickAux:
    """One brick's distribution state (``tpusph.dist.DistAux``). Side
    arrays are stacked (2*naxes, ...): side 2k = axis-k lo side, 2k+1 = hi
    side. send_rows[s]: my edge rows packed for the side-s neighbour;
    ghost_rows[s]: my rows holding ghosts received from it. seam_*: the
    strip inner's seam-band copy map (size 0 for other inners), re-copied
    after every owner -> ghost refresh."""
    grid: object                # the inner backend's aux
    send_rows: torch.Tensor     # (S, G) i64
    n_send: torch.Tensor        # (S,) i64
    ghost_rows: torch.Tensor    # (S, G) i64
    n_ghost: torch.Tensor       # (S,) i64
    overflow: torch.Tensor      # (1,) i64 cumulative, the inner's included
    seam_src: torch.Tensor
    seam_dest: torch.Tensor
    seam_shift: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistAux:
    """Every brick's aux, with the host-facing counters over all bricks:
    ``overflow`` (ndev,), ``nbuilds`` (1,) (the bricks rebuild together),
    and for the strip inner ``margin_short`` / ``margin_need`` (ndev, 2)."""
    bricks: tuple

    def _stack(self, name):
        dev = self.bricks[0].overflow.device
        return torch.stack([_to(getattr(b.grid, name), dev)
                            for b in self.bricks])

    @property
    def overflow(self) -> torch.Tensor:
        dev = self.bricks[0].overflow.device
        return torch.cat([_to(b.overflow, dev) for b in self.bricks])

    @property
    def nbuilds(self) -> torch.Tensor:
        return self._stack("nbuilds").max().reshape(1)

    @property
    def margin_short(self):
        if getattr(self.bricks[0].grid, "margin_short", None) is None:
            return None
        return self._stack("margin_short")

    @property
    def margin_need(self):
        # only the strip inner's aux has it (AttributeError otherwise)
        return self._stack("margin_need")


class DistBackend:
    """The comm stack over a list of bricks, each with an inner backend:
    ``StripBackend`` (``strip_geom``), ``PallasBackend`` (``use_pallas``)
    or ``CellGridBackend``. One inner per distinct device (its tables live
    there)."""

    def __init__(self, spec: BrickSpec, box_global: Box, dim: int,
                 cutoff: float, skin: float, cap: int | None = None,
                 rebuild_every: int = 0,
                 use_pallas: bool = False, ntypes: int = 1,
                 strip_geom=None, devices=("cpu",)):
        self.spec = spec
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != spec.ndev:
            raise ValueError(f"{len(self.devices)} devices for "
                             f"{spec.ndev} bricks")
        self.box_global = box_global
        self._skin = float(skin)
        self.rebuild_every = rebuild_every
        self._wtab = [np.asarray(spec.widths_of(k), np.float32)
                      for k in range(spec.naxes)]
        self._coords = [spec.coords_of(b) for b in range(spec.ndev)]
        self.strip_geom = strip_geom
        self.geom = None
        self._box_by_dev, self._inner_by_dev = {}, {}
        for dev in self.devices:
            key = str(dev)
            if key in self._inner_by_dev:
                continue
            box_l = local_box(spec, box_global, dev)
            self._box_by_dev[key] = box_l
            if strip_geom is not None:
                from tpusph_torch.ops.strip_pair import StripBackend
                self.mode = "strip"
                inner = StripBackend(strip_geom, ntypes=ntypes, device=dev)
            else:
                self.geom = gridlib.make_geometry(box_l, cutoff, dim,
                                                  skin=skin, cap=cap)
                if use_pallas:
                    from tpusph_torch.ops.pallas_pair import PallasBackend
                    self.mode = "pallas"
                    inner = PallasBackend(self.geom, box_l, ntypes=ntypes,
                                          device=dev)
                else:
                    self.mode = "cellgrid"
                    inner = CellGridBackend(self.geom, device=dev, box=box_l)
            self._inner_by_dev[key] = inner
        self.inner = self._inner_by_dev[str(self.devices[0])]

    def inner_of(self, b: int):
        return self._inner_by_dev[str(self.devices[b])]

    def box_of(self, b: int) -> Box:
        return self._box_by_dev[str(self.devices[b])]

    def _w_me(self, b: int, k: int) -> float:
        """Brick b's width along axis k (a float32 value)."""
        return float(self._wtab[k][self._coords[b][k]])

    def _w_nbr(self, b: int, k: int, direction: int) -> float:
        """The width of brick b's axis-k neighbour in ``direction``: the
        frame shift a payload needs when moving to that neighbour."""
        sk = self.spec.shape[k]
        return float(self._wtab[k][(self._coords[b][k] + direction) % sk])

    def _shift(self, arrs, k, direction):
        return _shift_axis(arrs, self.spec, k, direction, self.devices)

    # -- splitting the pool into bricks ---------------------------------------

    def split(self, state: ParticleState) -> List[ParticleState]:
        """The (ndev * local_cap) pool as per-brick states on their
        devices (row views where the device is the pool's)."""
        cap = state.capacity // self.spec.ndev
        return [ParticleState(**{
            f.name: _to(getattr(state, f.name)[b * cap:(b + 1) * cap], dev)
            for f in dataclasses.fields(state)})
            for b, dev in enumerate(self.devices)]

    def concat(self, states: List[ParticleState]) -> ParticleState:
        """Per-brick states -> one (ndev * local_cap) pool on the first
        brick's device (the reference's globally sharded array)."""
        dev = self.devices[0]
        return ParticleState(**{
            f.name: torch.cat([_to(getattr(s, f.name), dev) for s in states])
            for f in dataclasses.fields(states[0])})

    # -- the mid-force halo refresh -------------------------------------------

    def _halo_refresh(self, fields: list, auxes: list) -> list:
        """Staged per-axis owner -> ghost refresh of one per-particle field
        (n,) or (n, c) of every brick: axis-1 sends relay axis-0 ghosts
        (corners). Then the seam-band recopy."""
        g = self.spec.ghost_cap
        fields = list(fields)
        for k in range(self.spec.naxes):
            for s, direction in ((2 * k, -1), (2 * k + 1, +1)):
                vals = []
                for fld, a in zip(fields, auxes):
                    n = fld.shape[0]
                    v = fld[torch.clamp(a.send_rows[s], 0, n - 1)]
                    sm = torch.arange(g, device=fld.device) < a.n_send[s]
                    vals.append(torch.where(sm if v.dim() == 1
                                            else sm[:, None], v, 0.0))
                recv = self._shift(vals, k, direction)
                # my lo-edge pack lands in my lo neighbour's hi-ghost rows
                for b, a in enumerate(auxes):
                    n = fields[b].shape[0]
                    gm = torch.arange(g, device=fields[b].device) \
                        < a.n_ghost[s ^ 1]
                    tgt = torch.where(gm, a.ghost_rows[s ^ 1], n)
                    fields[b] = _scatter_rows(fields[b], tgt, recv[b], n)
        return [self._seam_recopy(f, a) for f, a in zip(fields, auxes)]

    @staticmethod
    def _seam_recopy(field: torch.Tensor, aux: BrickAux,
                     shift_axis: int | None = None) -> torch.Tensor:
        """Re-copy the strip seam bands from their (just-refreshed) source
        rows; no-op for other inners. ``shift_axis``: apply the
        column-axis position shift (x only)."""
        if aux.seam_src.numel() == 0:
            return field
        g = field[aux.seam_src]
        if shift_axis is not None and field.dim() == 2:
            g[:, shift_axis] += aux.seam_shift
        return _scatter_rows(field, aux.seam_dest, g, field.shape[0])

    def force_stage_all(self, states: list, tabs: list, spec: PhysicsSpec,
                        auxes: list, istep: int) -> list:
        """Every brick's force stage in lockstep: each inner's
        ``force_stage_steps`` yields its fresh rho and colour gradient,
        the halo refresh runs across bricks, and the refreshed fields go
        back before the next sweep (``Pair::pack_forward_comm``)."""
        gens = [self.inner_of(b).force_stage_steps(
            st, tabs[b], spec, a.grid, istep, halo_points=True)
            for b, (st, a) in enumerate(zip(states, auxes))]

        def step(gen, val=None, first=False):
            try:
                return (next(gen) if first else gen.send(val)), False
            except StopIteration as stop:
                return stop.value, True

        outs = [step(gen, first=True) for gen in gens]
        while not outs[0][1]:
            if not all(not done for _, done in outs):
                raise RuntimeError("bricks' force stages out of step")
            fields = self._halo_refresh([o for o, _ in outs], auxes)
            outs = [step(gen, f) for gen, f in zip(gens, fields)]
        if not all(done for _, done in outs):
            raise RuntimeError("bricks' force stages out of step")
        return [o for o, _ in outs]

    # -- the comm stack -------------------------------------------------------

    def init_aux(self, state: ParticleState, box: Box):
        """Exchange + borders + sort of the partitioned pool (Verlet::setup's
        comm). Returns (pool, DistAux)."""
        states, auxes = self._rebuild(self.split(state))
        return self.concat(states), DistAux(tuple(auxes))

    def needs_rebuild(self, states: list, auxes: list, istep: int) -> bool:
        """The skin/2 trigger over every brick (one host sync), or every
        ``rebuild_every`` steps."""
        if self.rebuild_every > 0 and istep % self.rebuild_every == 0:
            return True
        if self._skin <= 0.0:
            return True
        dev = self.devices[0]
        d2 = []
        for st, a in zip(states, auxes):
            disp = st.x - a.grid.x_ref
            d2.append(_to(torch.where(st.alive[:, None], disp * disp, 0.0)
                          .sum(-1).max(), dev))
        return bool(torch.stack(d2).max() > (0.5 * self._skin) ** 2)

    def prepare(self, states: list, auxes: list, istep: int):
        """Rebuild when any brick's trigger fires, else the per-step
        forward comm. Returns (states, auxes, rebuilt)."""
        if self.needs_rebuild(states, auxes, istep):
            states, auxes = self._rebuild(states, prev=auxes)
            return states, auxes, True
        return self._forward_comm(states, auxes), auxes, False

    def _forward_comm(self, states: list, auxes: list) -> list:
        """Owner -> ghost refresh of x, vest, rho, e, staged per axis
        (axis-1 relays axis-0 ghost rows: corners stay fresh), the four
        fields in one (n, 8) matrix."""
        g = self.spec.ghost_cap
        mats = [torch.cat([st.x, st.vest, st.rho[:, None], st.e[:, None]],
                          dim=1) for st in states]
        for k in range(self.spec.naxes):
            ax = self.spec.axes[k]
            for s, direction in ((2 * k, -1), (2 * k + 1, +1)):
                vals = []
                for b, (mat, a) in enumerate(zip(mats, auxes)):
                    n = mat.shape[0]
                    # into the receiver's frame: moving down-axis adds the
                    # receiver's width, up-axis subtracts mine
                    w = self._w_nbr(b, k, -1) if direction < 0 \
                        else -self._w_me(b, k)
                    v = mat[torch.clamp(a.send_rows[s], 0, n - 1)]
                    sm = torch.arange(g, device=mat.device) < a.n_send[s]
                    v = torch.where(sm[:, None], v, 0.0)
                    v[:, ax] += w
                    vals.append(v)
                recv = self._shift(vals, k, direction)
                for b, a in enumerate(auxes):
                    n = mats[b].shape[0]
                    gm = torch.arange(g, device=mats[b].device) \
                        < a.n_ghost[s ^ 1]
                    tgt = torch.where(gm, a.ghost_rows[s ^ 1], n)
                    mats[b] = _scatter_rows(mats[b], tgt, recv[b], n)
        out = []
        for st, mat, a in zip(states, mats, auxes):
            if self.mode == "strip":
                mat = self._seam_recopy(mat, a,
                                        shift_axis=self.strip_geom.col_axis)
            out.append(dataclasses.replace(
                st, x=mat[:, 0:3].contiguous(),
                vest=mat[:, 3:6].contiguous(), rho=mat[:, 6].contiguous(),
                e=mat[:, 7].contiguous()))
        return out

    def _edge_masks(self, b: int, k: int, st: ParticleState, lo_thr: float,
                    hi_thr: float):
        """(alive rows below lo_thr, alive rows at or above hi_thr) along
        axis k; at a non-periodic global edge nothing leaves (walls: an
        overhanging particle stays with the edge brick)."""
        xa = st.x[:, self.spec.axes[k]]
        alive = st.alive
        lo = alive & (xa < lo_thr)
        hi = alive & (xa >= hi_thr)
        if not self.spec.periodic[k]:
            c = self._coords[b][k]
            if c == 0:
                lo = torch.zeros_like(lo)
            if c == self.spec.shape[k] - 1:
                hi = torch.zeros_like(hi)
        return lo, hi

    def _rebuild(self, states: list, prev: list | None = None):
        """Exchange + borders + sort, staged per axis (``tpusph``'s
        ``DistBackend._rebuild``). ``prev``: the auxes of the last build,
        whose overflow accumulates and whose build counts go on."""
        spec = self.spec
        nb = spec.ndev
        gcap, mcap = spec.ghost_cap, spec.migrate_cap
        margin = float(np.float32(spec.margin))

        # drop the previous ghosts; wrap the non-decomposed periodic axes
        states = [dataclasses.replace(
            st, type=torch.where(st.owned, st.type, 0),
            owned=torch.ones_like(st.owned),
            x=self._wrap_other_axes(st.x, b))
            for b, st in enumerate(states)]
        overflow = [torch.zeros(1, dtype=torch.int64, device=dev)
                    for dev in self.devices]
        if prev is not None:
            overflow = [o + p.overflow for o, p in zip(overflow, prev)]

        # ---- exchange (migration), axis by axis: a corner migrant moves
        # in two hops
        for k in range(spec.naxes):
            ax = spec.axes[k]
            pays_lo, pays_hi = [], []
            for b, st in enumerate(states):
                n = st.capacity
                w_me = self._w_me(b, k)
                gone_lo, gone_hi = self._edge_masks(b, k, st, 0.0, w_me)
                rows_lo, cnt_lo, ov_lo = _select_rows(gone_lo, mcap)
                rows_hi, cnt_hi, ov_hi = _select_rows(gone_hi, mcap)
                pay_lo = _pack_rows(st, rows_lo, cnt_lo)
                pay_hi = _pack_rows(st, rows_hi, cnt_hi)
                # into the receiver's frame: lo-bound adds the lo
                # neighbour's width, hi-bound subtracts mine
                pay_lo["x"][:, ax] += self._w_nbr(b, k, -1)
                pay_hi["x"][:, ax] += -w_me
                killed = torch.zeros(n + 1, dtype=torch.bool,
                                     device=st.device)
                killed[rows_lo] = True
                killed[rows_hi] = True
                states[b] = dataclasses.replace(
                    st, type=torch.where(killed[:n], 0, st.type))
                overflow[b] = overflow[b] + ov_lo + ov_hi
                pays_lo.append(pay_lo)
                pays_hi.append(pay_hi)
            from_lo = self._shift(pays_hi, k, +1)
            from_hi = self._shift(pays_lo, k, -1)
            for b in range(nb):
                st, ov1 = _merge_payload(states[b], from_lo[b], True)
                st, ov2 = _merge_payload(st, from_hi[b], True,
                                         used_dead=mcap)
                states[b] = st
                overflow[b] = overflow[b] + ov1 + ov2

        # ---- borders (ghosts), axis by axis: later axes pack their edge
        # slabs from the state INCLUDING earlier axes' ghosts, so corner
        # ghosts are relayed in two hops
        send_slots = [[] for _ in range(nb)]
        n_send = [[] for _ in range(nb)]
        ghost_cnts = [[] for _ in range(nb)]
        for k in range(spec.naxes):
            ax = spec.axes[k]
            gp_lo, gp_hi, sc_lo, sc_hi = [], [], [], []
            for b, st in enumerate(states):
                n = st.capacity
                dev = st.device
                w_me = self._w_me(b, k)
                hi_thr = float(np.float32(w_me) - np.float32(margin))
                edge_lo, edge_hi = self._edge_masks(b, k, st, margin,
                                                    hi_thr)
                srows_lo, scnt_lo, sov_lo = _select_rows(edge_lo, gcap)
                srows_hi, scnt_hi, sov_hi = _select_rows(edge_hi, gcap)
                pay_lo = _pack_rows(st, srows_lo, scnt_lo)
                pay_hi = _pack_rows(st, srows_hi, scnt_hi)
                pay_lo["x"][:, ax] += self._w_nbr(b, k, -1)
                pay_hi["x"][:, ax] += -w_me
                # forward-comm send markers (carried through the sort)
                for rows in (srows_lo, srows_hi):
                    mark = torch.full((n + 1,), -1, dtype=torch.int64,
                                      device=dev)
                    mark[rows] = torch.arange(gcap, device=dev)
                    send_slots[b].append(mark[:n])
                n_send[b] += [scnt_lo, scnt_hi]
                overflow[b] = overflow[b] + sov_lo + sov_hi
                gp_lo.append(pay_lo)
                gp_hi.append(pay_hi)
                sc_lo.append(scnt_lo)
                sc_hi.append(scnt_hi)
            ghosts_from_lo = self._shift(gp_hi, k, +1)
            ghosts_from_hi = self._shift(gp_lo, k, -1)
            gcnt_lo = self._shift(sc_hi, k, +1)
            gcnt_hi = self._shift(sc_lo, k, -1)
            for b in range(nb):
                st, ov3 = _merge_payload(states[b], ghosts_from_lo[b], False,
                                         used_dead=2 * k * gcap)
                st, ov4 = _merge_payload(st, ghosts_from_hi[b], False,
                                         used_dead=(2 * k + 1) * gcap)
                states[b] = st
                overflow[b] = overflow[b] + ov3 + ov4
                ghost_cnts[b] += [gcnt_lo[b], gcnt_hi[b]]

        auxes = []
        for b, st in enumerate(states):
            auxes.append(self._sort(b, st, send_slots[b], n_send[b],
                                    ghost_cnts[b], overflow[b],
                                    None if prev is None
                                    else prev[b].grid.nbuilds))
            states[b] = auxes[-1][0]
        return [s for s, _ in auxes], [a for _, a in auxes]

    def _sort(self, b, st, send_slots, n_send, ghost_cnts, overflow,
              nbuilds):
        """Ghost slot reconstruction and the sort into the inner layout,
        carrying the markers. Dead slots were consumed in ascending row
        order with disjoint, increasing offsets per merge, so among the
        activated (alive, not owned) rows in row order the first
        ghost_cnts[0] are side-0 ghosts, the next ghost_cnts[1] side-1's,
        and so on."""
        n = st.capacity
        dev = st.device
        gcap = self.spec.ghost_cap
        act = st.alive & ~st.owned
        act_rank = torch.cumsum(act.to(torch.int64), 0) - 1
        ghost_slots = []
        lo_bound = torch.zeros(1, dtype=torch.int64, device=dev)
        for cnt in ghost_cnts:
            hi_bound = lo_bound + cnt
            in_side = act & (act_rank >= lo_bound) & (act_rank < hi_bound)
            ghost_slots.append(torch.where(in_side, act_rank - lo_bound, -1))
            lo_bound = hi_bound
        extra = dict(send=torch.stack(send_slots, 1),
                     ghost=torch.stack(ghost_slots, 1))
        inner = self.inner_of(b)
        if self.mode == "strip":
            from tpusph_torch.ops.strip_pair import build_strips
            st, grid, extra, seam = build_strips(
                st, self.strip_geom, self.box_of(b), nbuilds=nbuilds,
                extra=extra, keep_ghosts=True, return_seam=True)
            grid = inner._attach_mix(st, grid)
        else:
            st, grid, extra = gridlib.build(st, self.geom, extra=extra,
                                            nbuilds=nbuilds)
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            seam = (z, z, torch.zeros(0, dtype=torch.float32, device=dev))

        def rows_from_slots(slots):
            buf = torch.full((gcap + 1,), n, dtype=torch.int64, device=dev)
            buf[torch.where(slots >= 0, slots, gcap)] = torch.arange(
                n, device=dev)
            return buf[:gcap]

        nsides = 2 * self.spec.naxes
        aux = BrickAux(
            grid=grid,
            send_rows=torch.stack([rows_from_slots(extra["send"][:, s])
                                   for s in range(nsides)]),
            n_send=torch.cat(n_send),
            ghost_rows=torch.stack([rows_from_slots(extra["ghost"][:, s])
                                    for s in range(nsides)]),
            n_ghost=torch.cat(ghost_cnts),
            # the inner layout's overflow (a cell past its cap, a strip
            # column or window) is folded in: it drops pairs too
            overflow=overflow + grid.overflow.to(torch.int64),
            seam_src=seam[0], seam_dest=seam[1], seam_shift=seam[2])
        return st, aux

    def _wrap_other_axes(self, x: torch.Tensor, b: int) -> torch.Tensor:
        box = self.box_global
        lo, hi = _to(box.lo, x.device), _to(box.hi, x.device)
        wrapped = Box(lo, hi, box.periodic).wrap(x)
        for ax in self.spec.axes:
            wrapped[:, ax] = x[:, ax]
        return wrapped

    def halo_rows(self, aux: DistAux) -> int:
        """Ghost rows refreshed per forward comm over all bricks (the brick
        layer's metric: halo rows per step)."""
        return int(sum(int(b.n_ghost.sum()) for b in aux.bricks))


# --------------------------------------------------------------------------
# host-side setup
# --------------------------------------------------------------------------

def choose_strip_geometry_dist(box_global: Box, spec: BrickSpec, dim: int,
                               cutoff: float, skin: float, x: np.ndarray,
                               headroom: float = 1.15, drift: float = 1.0,
                               extra_rows=(0, 0)):
    """Strip geometry shared by EVERY brick (one layout): chosen per brick
    view (owned + margin ghosts, brick-local frame) and merged to the worst
    case (``tpusph.dist.choose_strip_geometry_dist``, line for line).
    Returns (geom, local_cap) or (None, None) when any brick cannot strip;
    local_cap == geom.n_slots, bumped until the pool also holds the ghost
    and migration merge buffers (``choose_local_cap``)."""
    from tpusph_torch.ops.strip_pair import (
        STRIP_W_CAP, choose_strip_geometry, pad_window_to_vreg,
    )
    blocal = local_box(spec, box_global, "cpu")
    views = [v for v in brick_local_positions(x, spec, box_global)
             if len(v) > 0]
    if not views:
        return None, None
    # pass 1: the fullest brick picks the (ts, ch) tile config; pass 2:
    # every brick re-measures its margins at that config, merged
    lead = max(views, key=len)
    g0 = choose_strip_geometry(blocal, cutoff, dim, skin, x=lead,
                               headroom=headroom, drift=drift,
                               extra_rows=extra_rows)
    if g0 is None:
        return None, None
    cand = ((g0.ts, g0.ch),)
    pnc = (g0.ncx, g0.ncy) if dim == 3 else (g0.ncx,)
    geoms = []
    for v in views:
        g = choose_strip_geometry(blocal, cutoff, dim, skin, x=v,
                                  headroom=headroom, candidates=cand,
                                  plane_nc=pnc, drift=drift,
                                  extra_rows=extra_rows)
        if g is None:
            return None, None
        geoms.append(g)
    ts, ch = g0.ts, g0.ch
    blk = g0.ts * g0.t_blk
    head = max(g.head for g in geoms)
    tail = max(g.tail for g in geoms)
    budget = max(g.col_cap - g.head - g.tail for g in geoms)
    mlo = max(g.mlo for g in geoms)
    mhi = max(g.mhi for g in geoms)
    if ch * (mlo + (ts // ch) + mhi) > STRIP_W_CAP:
        return None, None
    col_cap = -(-(head + budget + tail) // blk) * blk
    mlo, mhi = pad_window_to_vreg(ts, ch, mlo, mhi, col_cap // ch)
    geom = g0._replace(head=head, tail=tail, col_cap=col_cap,
                       mlo=mlo, mhi=mhi)

    # the pool must also absorb the pre-sort ghost / migrant merges
    owner = np.zeros(len(x), np.int64)
    for k, ax in enumerate(spec.axes):
        rel = np.asarray(x, np.float64)[:, ax] - spec.lo[k]
        if spec.cuts is None:
            c = np.clip((rel / spec.width[k]).astype(int), 0,
                        spec.shape[k] - 1)
        else:
            c = np.clip(np.searchsorted(spec.cuts[k], rel, side="right") - 1,
                        0, spec.shape[k] - 1)
        owner = owner * spec.shape[k] + c
    counts_max = int(np.bincount(owner, minlength=spec.ndev).max())
    required = choose_local_cap(spec, counts_max)
    while geom.n_slots < required:
        geom = geom._replace(col_cap=geom.col_cap + geom.ts * geom.t_blk)
    return geom, geom.n_slots


def choose_brick_shape(box: Box, ndev: int, margin: float, dim: int,
                       axis_dim: int = 0) -> Tuple[Tuple[int, ...],
                                                   Tuple[int, ...]]:
    """(axes, shape) for ndev bricks: 1D along ``axis_dim`` while the
    bricks are comfortably wider than the margin, else the most cubic
    feasible factorization over more axes (comm.cpp's procgrid)."""
    lo = _host(box.lo)
    hi = _host(box.hi)
    length = hi - lo
    if length[axis_dim] / ndev > 1.5 * margin:
        return (axis_dim,), (ndev,)
    cand_axes = [a for a in range(dim) if length[a] > 0]
    best = None
    for axes in _axis_subsets(cand_axes, axis_dim):
        for shape in _factorizations(ndev, len(axes)):
            widths = [length[a] / s for a, s in zip(axes, shape)]
            if min(widths) <= margin:
                continue
            score = min(widths)  # maximize the narrowest brick
            if best is None or score > best[0]:
                best = (score, tuple(axes), tuple(shape))
    if best is None:
        raise ValueError(
            f"no brick decomposition of {ndev} devices fits this box with "
            f"halo margin {margin} (every factorization has a brick "
            "width <= margin). Use fewer devices or a larger box.")
    return best[1], best[2]


def _axis_subsets(cand, first):
    out = []
    rest = [a for a in cand if a != first]
    out.append([first])
    for r in rest:
        out.append(sorted([first, r]))
    if len(rest) >= 2:
        out.append(sorted([first] + rest[:2]))
    return out


def _factorizations(n, k):
    if k == 1:
        return [(n,)]
    out = []
    for f in range(1, n + 1):
        if n % f == 0:
            for tail in _factorizations(n // f, k - 1):
                out.append((f,) + tail)
    return out


def make_brick_spec(box: Box, ndev: int, cutoff: float, skin: float,
                    n_particles: int, axis_dim: int = 0,
                    shape: Tuple[int, ...] | None = None,
                    axes: Tuple[int, ...] | None = None,
                    ghost_cap: int | None = None,
                    migrate_cap: int | None = None,
                    cuts: Tuple[Tuple[float, ...], ...] | None = None
                    ) -> BrickSpec:
    """The decomposition (``tpusph.dist.make_brick_spec``): the shape (or
    the chosen one), the widths, and the ghost and migration capacities
    from the staged borders' slab volumes."""
    margin = cutoff + skin
    if shape is None:
        axes, shape = choose_brick_shape(
            box, ndev, margin, dim=3, axis_dim=axis_dim)
    elif axes is None:
        axes = tuple(range(len(shape)))
    if int(np.prod(shape)) != ndev:
        raise ValueError(f"brick shape {shape} does not tile {ndev} devices")
    lo_g = _host(box.lo)
    hi_g = _host(box.hi)
    widths = []
    for k, (a, s) in enumerate(zip(axes, shape)):
        if cuts is not None:
            ws = np.diff(np.asarray(cuts[k], np.float64))
            if len(ws) != s or (ws <= 0).any():
                raise ValueError(f"balance cuts along axis {a} are not "
                                 f"{s} monotone bricks: {cuts[k]}")
            w = float(ws.min())
        else:
            w = (hi_g[a] - lo_g[a]) / s
        if s > 1 and margin >= w:
            raise ValueError(
                f"halo margin {margin} >= brick width {w} along axis {a}: "
                "too many bricks for this box/cutoff")
        widths.append(float((hi_g[a] - lo_g[a]) / s) if cuts is None
                      else float(np.max(np.diff(cuts[k]))))
    if ghost_cap is None:
        per_brick = max(n_particles // ndev, 1)
        # staged borders: axis k's edge slab includes ALL earlier axes'
        # ghosts, so its volume ratio is frac_k * prod_{j<k}(1 + 2 frac_j)
        fracs = [min(margin / w, 1.0) for w in widths]
        ratio = 0.0
        for k, fk in enumerate(fracs):
            r = fk
            for fj in fracs[:k]:
                r *= (1.0 + 2.0 * fj)
            ratio = max(ratio, r)
        ghost_cap = int(math.ceil(per_brick * ratio * 2.0 / 8.0) * 8) + 32
    if migrate_cap is None:
        migrate_cap = max(int(ghost_cap), 16)
    return BrickSpec(ndev=ndev, axes=tuple(int(a) for a in axes),
                     shape=tuple(int(s) for s in shape),
                     lo=tuple(float(lo_g[a]) for a in axes),
                     width=tuple(widths),
                     margin=margin, ghost_cap=int(ghost_cap),
                     migrate_cap=int(migrate_cap),
                     periodic=tuple(bool(box.periodic[a]) for a in axes),
                     cuts=(None if cuts is None else
                           tuple(tuple(float(c) for c in cc) for cc in cuts)))


def compute_balance_cuts(x: np.ndarray, box: Box,
                         axes: Tuple[int, ...], shape: Tuple[int, ...],
                         margin: float) -> Tuple[Tuple[float, ...], ...]:
    """Equal-count brick boundaries per decomposed axis (balance.cpp's
    shift balancer): boundaries at the per-axis particle-count quantiles,
    clamped so every brick stays wider than the halo margin."""
    lo_g = _host(box.lo)
    hi_g = _host(box.hi)
    wmin = margin * 1.05 + 1e-9
    out = []
    for a, s in zip(axes, shape):
        length = float(hi_g[a] - lo_g[a])
        if s * wmin >= length:
            raise ValueError(
                f"cannot balance axis {a}: {s} bricks of minimum width "
                f"{wmin:.4g} (halo margin) exceed the box length {length:.4g}")
        rel = np.sort(np.clip(np.asarray(x[:, a], np.float64) - lo_g[a],
                              0.0, length))
        q = [length * i / s if len(rel) == 0 else
             float(rel[min(int(round(len(rel) * i / s)), len(rel) - 1)])
             for i in range(1, s)]
        cuts = np.array([0.0] + q + [length])
        for i in range(1, s + 1):          # enforce the margin floor
            cuts[i] = max(cuts[i], cuts[i - 1] + wmin)
        cuts[s] = length
        for i in range(s - 1, 0, -1):
            cuts[i] = min(cuts[i], cuts[i + 1] - wmin)
        if cuts[0] < -1e-9 or (np.diff(cuts) <= 0).any():
            raise ValueError(f"balance infeasible along axis {a}")
        cuts[0] = 0.0
        out.append(tuple(float(c) for c in cuts))
    return tuple(out)


def choose_local_cap(spec: BrickSpec, counts_max: int) -> int:
    """Pool capacity per brick: peak occupancy + ghost buffers (one pair per
    decomposed axis, disjoint merge offsets) + migration slack."""
    cap = counts_max + 2 * spec.naxes * spec.ghost_cap \
        + 2 * spec.naxes * spec.migrate_cap
    return ((cap + 127) // 128) * 128


def brick_owner(x: np.ndarray, spec: BrickSpec):
    """(owner brick of every particle, brick-local positions)."""
    x = np.asarray(x, np.float32).copy()
    owner = np.zeros(len(x), np.int64)
    for k, ax in enumerate(spec.axes):
        rel = x[:, ax] - spec.lo[k]
        if spec.cuts is None:
            c = np.clip((rel / spec.width[k]).astype(int),
                        0, spec.shape[k] - 1)
        else:
            c = np.clip(np.searchsorted(spec.cuts[k], rel, side="right") - 1,
                        0, spec.shape[k] - 1)
        x[:, ax] = rel - spec.offsets_of(k)[c]      # brick-local
        owner = owner * spec.shape[k] + c
    return owner, x


def partition_state(staged: dict, spec: BrickSpec, devices,
                    local_cap: int | None = None
                    ) -> Tuple[List[ParticleState], int]:
    """Scatter host-staged arrays to the bricks in brick-local coordinates
    (``tpusph.dist.partition_state``): one ``local_cap``-row state per
    brick on its device. The integrator extras (vest, f, de, drho and the
    Kahan ledgers) are kept where ``staged`` carries them, so a mid-run
    repartition continues the leapfrog."""
    owner, x = brick_owner(staged["x"], spec)
    counts = np.bincount(owner, minlength=spec.ndev)
    if local_cap is None:
        local_cap = choose_local_cap(spec, int(counts.max()))
    if counts.max() > local_cap:
        raise ValueError(f"brick occupancy {counts.max()} > local capacity "
                         f"{local_cap}")
    fields = dict(staged)
    fields["x"] = x
    out = []
    for b, dev in enumerate(devices):
        sel = owner == b
        cnt = int(sel.sum())

        def pad(v, fill_shape=None):
            v = np.asarray(v)
            dt = v.dtype if v.dtype != np.float64 else np.float32
            buf = np.zeros((local_cap,) + v.shape[1:], dt)
            buf[:cnt] = v[sel]
            return buf

        def opt(key, shape):
            if key in fields and np.asarray(fields[key]).shape[1:] == shape:
                return pad(fields[key])
            return np.zeros((local_cap,) + shape, np.float32)

        arrs = dict(
            x=pad(fields["x"]), v=pad(fields["v"]),
            vest=pad(fields["vest"] if "vest" in fields else fields["v"]),
            f=opt("f", (3,)), rho=pad(fields["rho"]), drho=opt("drho", ()),
            e=pad(fields["e"]), de=opt("de", ()), cv=pad(fields["cv"]),
            rmass=pad(fields["rmass"]), type=pad(fields["type"]),
            tag=pad(fields["tag"]), mobile=pad(fields["mobile"]),
            vir=np.zeros(local_cap, np.float32), rho_c=opt("rho_c", ()),
            e_c=opt("e_c", ()))
        arrs["owned"] = arrs["type"] > 0
        out.append(state_from_numpy(arrs, device=dev))
    return out, local_cap


def globalize_positions(x_host: np.ndarray, spec: BrickSpec,
                        local_cap: int) -> np.ndarray:
    """Brick-local -> global coordinates for host-side output (dump, get)."""
    x = np.array(x_host, np.float32)
    rows = np.arange(len(x))
    brick = rows // local_cap
    coords = spec.coords_of(brick)
    for k, ax in enumerate(spec.axes):
        x[:, ax] += spec.lo[k] + spec.offsets_of(k)[np.asarray(coords[k])]
    return x


def _tabs_on(tabs: DeviceTables, dev: torch.device) -> DeviceTables:
    if tabs.tab2.device == dev:
        return tabs
    return tabs._replace(tab2=tabs.tab2.to(dev), tab1=tabs.tab1.to(dev),
                         gravity=tabs.gravity.to(dev))


class _BrickHookView:
    """What fix phase_change sees of the bricks inside one brick's
    end-of-step hook: the brick's inner vapor query in its local box, and
    the tag base for insertion (the global largest tag, taken over every
    brick before any brick inserts, plus the brick index times the pool
    capacity: ``tpusph``'s pmax + axis_index * n)."""

    is_dist = True

    def __init__(self, backend: DistBackend, b: int, states: list):
        self._backend = backend
        self.brick = b
        self._states = states

    def vapor_neighbor(self, state, box, vtype, cut, aux):
        return self._backend.inner_of(self.brick).vapor_neighbor(
            state, self._backend.box_of(self.brick), vtype, cut, aux)

    def tag_base(self, n: int) -> torch.Tensor:
        dev = self._states[self.brick].device
        top = torch.stack([
            _to(torch.where(s.alive, s.tag, 0).max(), dev)
            for s in self._states]).max()
        return top + self.brick * n


class DistRunner:
    """The step loop over the bricks (Verlet::run with the comm stack),
    with ``runner.Runner``'s interface: ``setup``, ``run`` (callbacks at
    the output cadence, freeze-on-overflow, the phase marks), ``loop_time``,
    ``ok_steps`` and ``phase_times`` (Modify, Neigh: the trigger and a
    rebuild, Comm: the per-step forward comm, Pair: the force stage with
    its halo refreshes; each the slowest card's time, from an event on
    every brick's card at each mark). The pool it takes and hands back is
    the concatenation of the bricks (``DistBackend.concat``)."""

    def __init__(self, spec: PhysicsSpec, backend: DistBackend,
                 end_of_step: Optional[Callable] = None):
        self.spec = spec
        self.backend = backend
        self.end_of_step = end_of_step
        self.loop_time = 0.0
        self.ok_steps = 0
        self.phase_times = None

    def _tabs(self, tabs: DeviceTables) -> list:
        return [_tabs_on(tabs, dev) for dev in self.backend.devices]

    def setup(self, state: ParticleState, tabs: DeviceTables, istep: int,
              aux: DistAux) -> ParticleState:
        """Verlet::setup: forces (with the halo refreshes) before the first
        initial_integrate."""
        be = self.backend
        sts = be.force_stage_all(be.split(state), self._tabs(tabs),
                                 self.spec, list(aux.bricks), istep)
        return be.concat(sts)

    def run(self, state: ParticleState, tabs: DeviceTables, dt: float,
            nsteps: int, aux: DistAux, istep0: int = 0, every: int = 0,
            callback: Optional[Callable] = None, phase_timer: bool = False):
        """``Runner.run`` over the bricks. A rebuild that counts an
        overflow in ANY brick abandons the step on every brick (the
        reference's psum'd freeze predicate)."""
        be = self.backend
        tabl = self._tabs(tabs)
        sts = be.split(state)
        auxes = list(aux.bricks)
        done = 0
        self.ok_steps = 0
        frozen = int(aux.overflow.sum()) > 0
        timer = _PhaseTimer(be.devices) if phase_timer else None
        t0 = time.perf_counter()
        while done < nsteps:
            chunk = nsteps - done if every <= 0 else \
                min(every - (istep0 + done) % every, nsteps - done)
            for k in range(chunk):
                if frozen:
                    break
                istep = istep0 + done + k
                _mark(timer)
                new = [integrate.initial_integrate(s, dt) for s in sts]
                _mark(timer, "Modify")
                new, aux1, rebuilt = be.prepare(new, auxes, istep)
                _mark(timer, "Neigh" if rebuilt else "Comm")
                if rebuilt and int(DistAux(tuple(aux1)).overflow.sum()) > 0:
                    auxes = aux1
                    frozen = True
                    break
                new = be.force_stage_all(new, tabl, self.spec, aux1, istep)
                _mark(timer, "Pair")
                new = [integrate.final_integrate(s, dt) for s in new]
                if self.end_of_step is not None:
                    pre = list(new)
                    for b in range(len(new)):
                        new[b], grid = self.end_of_step(
                            pre[b], tabl[b], dt, istep, aux1[b].grid,
                            _BrickHookView(be, b, pre), be.box_of(b))
                        aux1[b] = dataclasses.replace(aux1[b], grid=grid)
                _mark(timer, "Modify")
                if timer is not None:
                    timer.commit()
                sts, auxes = new, aux1
                self.ok_steps += 1
            done += chunk
            if callback is not None:
                callback(be.concat(sts), istep0 + done,
                         DistAux(tuple(auxes)))
        for dev in be.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.loop_time += time.perf_counter() - t0
        self.phase_times = timer.split() if timer is not None \
            and timer.steps else None
        return be.concat(sts), DistAux(tuple(auxes))
