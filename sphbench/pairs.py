"""The benchmark's own pair search: a plain cell-binned search in a
periodic box, in PyTorch on any device and dtype.

Every (i, j) with i != j and a minimum-image rsq below the cutoff squared
is found once from each side. The reference uses it for its sweeps and the
vapour query, and the per-layer metrics use it to count the pairs the
physics needs (``count``). It imports nothing of the program.
"""

from __future__ import annotations

import itertools

import torch

# candidate (i, j) entries per block of i rows: bounds the temporaries
BLOCK_CANDIDATES = 1 << 26


def min_image(dx: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return dx - length * torch.round(dx / length)


class PairList:
    """Every directed pair within ``cut`` of the positions ``x`` (n, 3) in
    the periodic box [0, length): ``i`` and ``j`` int64 row indices sorted
    by i (blocks of rows in cell order). ``dx`` and ``rsq`` are formed on
    demand, in the positions' dtype."""

    def __init__(self, x: torch.Tensor, length, cut: float):
        self.x = x
        self.length = torch.as_tensor(length, dtype=x.dtype,
                                      device=x.device).expand(3)
        self.cut = float(cut)
        self.i, self.j = _search(x, self.length, self.cut)

    def __len__(self) -> int:
        return int(self.i.numel())

    def blocks(self, size: int = 1 << 25):
        """(sl, i, j, dx, rsq) over slices of at most ``size`` pairs."""
        for a in range(0, len(self), size):
            sl = slice(a, min(a + size, len(self)))
            i, j = self.i[sl], self.j[sl]
            dx = min_image(self.x[i] - self.x[j], self.length)
            yield sl, i, j, dx, (dx * dx).sum(-1)


def _offsets(nc):
    """Distinct neighbour-cell offsets along each axis (a box of fewer than
    three cells along an axis has fewer distinct neighbours)."""
    per_axis = [sorted({o % n for o in (-1, 0, 1)}) for n in nc]
    return list(itertools.product(*per_axis))


def _search(x: torch.Tensor, length: torch.Tensor, cut: float):
    dev = x.device
    n = x.shape[0]
    lengths = [float(v) for v in length.tolist()]
    if min(lengths) < 2.0 * cut:
        raise ValueError("the box must be at least two cutoffs wide")
    nc = [max(int(v // cut), 1) for v in lengths]
    # cell coordinates from float64 positions, so that a low-precision
    # copy of the positions still bins every row inside the box
    xw = torch.remainder(x.double(), length.double())
    cell = torch.stack([
        torch.clamp((xw[:, d] * (nc[d] / lengths[d])).long(), 0, nc[d] - 1)
        for d in range(3)], 1)
    cid = (cell[:, 0] * nc[1] + cell[:, 1]) * nc[2] + cell[:, 2]
    order = torch.argsort(cid, stable=True)
    ncell = nc[0] * nc[1] * nc[2]
    counts = torch.bincount(cid, minlength=ncell)
    starts = torch.cumsum(counts, 0) - counts
    width = int(counts.max()) if n else 0
    offs = _offsets(nc)
    lane = torch.arange(width, device=dev)
    cut2 = cut * cut
    step = max(1, BLOCK_CANDIDATES // max(width * len(offs), 1))
    ii, jj = [], []
    for a in range(0, n, step):
        rows = order[a:a + step]
        c = cell[rows]
        cand = []
        for o in offs:
            nb = [(c[:, d] + o[d]) % nc[d] for d in range(3)]
            nid = (nb[0] * nc[1] + nb[1]) * nc[2] + nb[2]
            k = starts[nid][:, None] + lane[None, :]
            ok = lane[None, :] < counts[nid][:, None]
            cand.append(torch.where(ok, order[torch.clamp(k, max=n - 1)],
                                    -1))
        cand = torch.cat(cand, 1)
        i = rows[:, None].expand_as(cand)
        keep = (cand >= 0) & (cand != i)
        i, j = i[keep], cand[keep]
        dx = min_image(x[i] - x[j], length)
        near = (dx * dx).sum(-1) < cut2
        ii.append(i[near])
        jj.append(j[near])
    if not ii:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(ii), torch.cat(jj)


def count(x: torch.Tensor, typ: torch.Tensor, length, cut: float) -> dict:
    """The pairs the bench physics needs on these positions and types:
    ``pairs`` every live (i, j); ``unlike`` those of unlike types (the
    colour gradient's); ``interface`` those whose i or j has an unlike
    neighbour (the capillary force's); ``rows`` the particles."""
    pl = PairList(x, length, cut)
    unlike_i = typ[pl.i] != typ[pl.j]
    flag = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    flag[pl.i[unlike_i]] = True
    return dict(rows=int(x.shape[0]), pairs=len(pl),
                unlike=int(unlike_i.sum()),
                interface=int((flag[pl.i] | flag[pl.j]).sum()))
