"""The benchmark's own pair search: a plain cell-binned search in a box
that is periodic along some axes, in PyTorch on any device and dtype.

Every (i, j) with i != j and an rsq below the cutoff squared is found once
from each side; the displacement takes the minimum image along the
periodic axes only. The reference uses it for its sweeps and the vapour
query, and the per-layer metrics use it to count the pairs the physics
needs (``count``). It imports nothing of the program.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

# candidate (i, j) entries per block of i rows: bounds the temporaries
BLOCK_CANDIDATES = 1 << 26


class Box(NamedTuple):
    """A scene's box: the lower and upper corner and the periodic flag of
    each axis (LAMMPS ``boundary p p f`` is periodic (True, True, False))."""

    lo: tuple
    hi: tuple
    periodic: tuple

    @property
    def length(self) -> tuple:
        return tuple(h - lo for lo, h in zip(self.lo, self.hi))

    def min_image(self, d: np.ndarray) -> np.ndarray:
        """Host displacements (..., 3) to their minimum image along the
        periodic axes."""
        length = np.asarray(self.length)
        return d - np.where(self.periodic, length * np.round(d / length),
                            0.0)


def _per_axis(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).expand(3)


def min_image(dx: torch.Tensor, length: torch.Tensor,
              periodic: torch.Tensor) -> torch.Tensor:
    return torch.where(periodic, dx - length * torch.round(dx / length), dx)


def wrap(x: torch.Tensor, lo: torch.Tensor, length: torch.Tensor,
         periodic: torch.Tensor) -> torch.Tensor:
    """Positions into the box along the periodic axes (a floor-mod)."""
    return torch.where(periodic, torch.remainder(x - lo, length) + lo, x)


class PairList:
    """Every directed pair within ``cut`` of the positions ``x`` (n, 3) in
    the box of per-axis ``length`` from the corner ``lo``, periodic along
    the axes ``periodic`` flags (each a number or three): ``i`` and ``j``
    int64 row indices sorted by i (blocks of rows in cell order). ``x``
    holds the positions wrapped into the box along the periodic axes;
    ``dx`` and ``rsq`` are formed on demand, in the positions' dtype."""

    def __init__(self, x: torch.Tensor, length, cut: float, lo=0.0,
                 periodic=True):
        kw = dict(dtype=x.dtype, device=x.device)
        self.length = _per_axis(length, **kw)
        self.lo = _per_axis(lo, **kw)
        self.periodic = _per_axis(periodic, torch.bool, x.device)
        self.x = wrap(x, self.lo, self.length, self.periodic)
        self.cut = float(cut)
        self.i, self.j = _search(self.x, self.lo, self.length,
                                 self.periodic, self.cut)

    def __len__(self) -> int:
        return int(self.i.numel())

    def blocks(self, size: int = 1 << 25):
        """(sl, i, j, dx, rsq) over slices of at most ``size`` pairs."""
        for a in range(0, len(self), size):
            sl = slice(a, min(a + size, len(self)))
            i, j = self.i[sl], self.j[sl]
            dx = min_image(self.x[i] - self.x[j], self.length,
                           self.periodic)
            yield sl, i, j, dx, (dx * dx).sum(-1)


def _offsets(nc, periodic):
    """Distinct neighbour-cell offsets along each axis: a periodic box of
    fewer than three cells along an axis has fewer distinct neighbours; on
    a non-periodic axis an offset past a face finds no cell."""
    per_axis = [sorted({o % n for o in (-1, 0, 1)}) if p
                else ([-1, 0, 1] if n > 1 else [0])
                for n, p in zip(nc, periodic)]
    return list(itertools.product(*per_axis))


def _search(x: torch.Tensor, lo: torch.Tensor, length: torch.Tensor,
            periodic: torch.Tensor, cut: float):
    dev = x.device
    n = x.shape[0]
    lengths = [float(v) for v in length.tolist()]
    per = [bool(p) for p in periodic.tolist()]
    if any(p and v < 2.0 * cut for p, v in zip(per, lengths)):
        raise ValueError("the box must be at least two cutoffs wide along "
                         "a periodic axis")
    nc = [max(int(v // cut), 1) for v in lengths]
    # cell coordinates from float64 positions, so that a low-precision
    # copy of the positions still bins every row inside the box; on a
    # non-periodic axis a row past a face bins into the face's cell
    xw = x.double() - lo.double()
    xw = torch.where(periodic, torch.remainder(xw, length.double()), xw)
    cell = torch.stack([
        torch.clamp((xw[:, d] * (nc[d] / lengths[d])).long(), 0, nc[d] - 1)
        for d in range(3)], 1)
    cid = (cell[:, 0] * nc[1] + cell[:, 1]) * nc[2] + cell[:, 2]
    order = torch.argsort(cid, stable=True)
    ncell = nc[0] * nc[1] * nc[2]
    counts = torch.bincount(cid, minlength=ncell)
    starts = torch.cumsum(counts, 0) - counts
    width = int(counts.max()) if n else 0
    offs = _offsets(nc, per)
    lane = torch.arange(width, device=dev)
    cut2 = cut * cut
    step = max(1, BLOCK_CANDIDATES // max(width * len(offs), 1))
    ii, jj = [], []
    for a in range(0, n, step):
        rows = order[a:a + step]
        c = cell[rows]
        cand = []
        for o in offs:
            nb, inside = [], None
            for d in range(3):
                cd = c[:, d] + o[d]
                if per[d]:
                    cd = cd % nc[d]
                elif o[d]:
                    ok_d = (cd >= 0) & (cd < nc[d])
                    inside = ok_d if inside is None else inside & ok_d
                    cd = torch.clamp(cd, 0, nc[d] - 1)
                nb.append(cd)
            nid = (nb[0] * nc[1] + nb[1]) * nc[2] + nb[2]
            k = starts[nid][:, None] + lane[None, :]
            ok = lane[None, :] < counts[nid][:, None]
            if inside is not None:
                ok = ok & inside[:, None]
            cand.append(torch.where(ok, order[torch.clamp(k, max=n - 1)],
                                    -1))
        cand = torch.cat(cand, 1)
        i = rows[:, None].expand_as(cand)
        keep = (cand >= 0) & (cand != i)
        i, j = i[keep], cand[keep]
        dx = min_image(x[i] - x[j], length, periodic)
        near = (dx * dx).sum(-1) < cut2
        ii.append(i[near])
        jj.append(j[near])
    if not ii:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(ii), torch.cat(jj)


def count(x: torch.Tensor, typ: torch.Tensor, length, cut: float, lo=0.0,
          periodic=True) -> dict:
    """The pairs the bench physics needs on these positions and types:
    ``pairs`` every live (i, j); ``unlike`` those of unlike types (the
    colour gradient's); ``interface`` those whose i or j has an unlike
    neighbour (the capillary force's); ``rows`` the particles."""
    pl = PairList(x, length, cut, lo, periodic)
    unlike_i = typ[pl.i] != typ[pl.j]
    flag = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    flag[pl.i[unlike_i]] = True
    return dict(rows=int(x.shape[0]), pairs=len(pl),
                unlike=int(unlike_i.sum()),
                interface=int((flag[pl.i] | flag[pl.j]).sum()))
