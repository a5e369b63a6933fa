"""Lattice fills and geometric regions — the TPU-native equivalent of the
reference's ``lattice`` / ``region`` / ``create_atoms`` commands
(src/lattice.cpp, src/region*.cpp, src/create_atoms.cpp — SURVEY.md §2.4).

Host-side numpy: runs once at setup, outside the hot loop. A copy of
``tpusph/lattice.py`` (framework-free), so that the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

_EPS = 1e-6


@dataclasses.dataclass
class Region:
    """Geometric region; subclasses implement ``inside(x) -> bool mask``
    and ``bbox() -> (lo, hi)``. Mirrors LAMMPS region styles."""

    side: str = "in"  # "in" or "out" (LAMMPS `side` keyword)

    def contains(self, x: np.ndarray) -> np.ndarray:
        m = self.inside(x)
        return m if self.side == "in" else ~m

    def inside(self, x: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def bbox(self):  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class Block(Region):
    lo: Sequence[float] = (0.0, 0.0, 0.0)
    hi: Sequence[float] = (1.0, 1.0, 1.0)

    def inside(self, x):
        lo = np.asarray(self.lo)
        hi = np.asarray(self.hi)
        return np.all((x >= lo - _EPS) & (x <= hi + _EPS), axis=-1)

    def bbox(self):
        return np.asarray(self.lo, float), np.asarray(self.hi, float)


@dataclasses.dataclass
class Sphere(Region):
    center: Sequence[float] = (0.0, 0.0, 0.0)
    radius: float = 1.0

    def inside(self, x):
        d = x - np.asarray(self.center)
        return np.sum(d * d, axis=-1) <= (self.radius + _EPS) ** 2

    def bbox(self):
        c = np.asarray(self.center, float)
        return c - self.radius, c + self.radius


@dataclasses.dataclass
class Cylinder(Region):
    """Axis-aligned cylinder (LAMMPS region cylinder)."""
    axis: str = "z"
    center: Sequence[float] = (0.0, 0.0)  # coords in the two non-axis dims
    radius: float = 1.0
    lo: float = 0.0
    hi: float = 1.0

    def _dims(self):
        a = "xyz".index(self.axis)
        other = [d for d in range(3) if d != a]
        return a, other

    def inside(self, x):
        a, other = self._dims()
        d = x[..., other] - np.asarray(self.center)
        radial = np.sum(d * d, axis=-1) <= (self.radius + _EPS) ** 2
        axial = (x[..., a] >= self.lo - _EPS) & (x[..., a] <= self.hi + _EPS)
        return radial & axial

    def bbox(self):
        a, other = self._dims()
        lo = np.empty(3)
        hi = np.empty(3)
        lo[a], hi[a] = self.lo, self.hi
        c = np.asarray(self.center, float)
        lo[other] = c - self.radius
        hi[other] = c + self.radius
        return lo, hi


@dataclasses.dataclass
class Prism(Region):
    """Tilted parallelepiped (LAMMPS region prism — src/region_prism.cpp,
    SURVEY §2.4): edge vectors a=(xhi-xlo,0,0), b=(xy,yhi-ylo,0),
    c=(xz,yz,zhi-zlo); a point is inside iff its fractional coordinates
    along (a,b,c) all lie in [0,1]."""
    lo: Sequence[float] = (0.0, 0.0, 0.0)
    hi: Sequence[float] = (1.0, 1.0, 1.0)
    xy: float = 0.0
    xz: float = 0.0
    yz: float = 0.0

    def inside(self, x):
        lo = np.asarray(self.lo, float)
        hi = np.asarray(self.hi, float)
        edge = np.maximum(hi - lo, 1e-300)
        # back-substitute the triangular edge matrix: c first, then b, a
        sz = (x[..., 2] - lo[2]) / edge[2]
        sy = (x[..., 1] - lo[1] - self.yz * sz) / edge[1]
        sx = (x[..., 0] - lo[0] - self.xy * sy - self.xz * sz) / edge[0]
        ok = np.ones(x.shape[:-1], bool)
        for s in (sx, sy, sz):
            ok &= (s >= -_EPS) & (s <= 1.0 + _EPS)
        return ok

    def bbox(self):
        lo = np.asarray(self.lo, float).copy()
        hi = np.asarray(self.hi, float).copy()
        lo[0] += min(0.0, self.xy) + min(0.0, self.xz)
        hi[0] += max(0.0, self.xy) + max(0.0, self.xz)
        lo[1] += min(0.0, self.yz)
        hi[1] += max(0.0, self.yz)
        return lo, hi


@dataclasses.dataclass
class Union(Region):
    regions: Sequence[Region] = ()

    def inside(self, x):
        m = np.zeros(x.shape[:-1], bool)
        for r in self.regions:
            m |= r.contains(x)
        return m

    def bbox(self):
        los, his = zip(*(r.bbox() for r in self.regions))
        return np.min(los, axis=0), np.max(his, axis=0)


@dataclasses.dataclass
class Intersect(Region):
    regions: Sequence[Region] = ()

    def inside(self, x):
        m = np.ones(x.shape[:-1], bool)
        for r in self.regions:
            m &= r.contains(x)
        return m

    def bbox(self):
        los, his = zip(*(r.bbox() for r in self.regions))
        return np.max(los, axis=0), np.min(his, axis=0)


# -- lattice styles (src/lattice.cpp basis vectors) --------------------------

_BASES = {
    # 2D
    "sq":  np.array([[0.0, 0.0, 0.0]]),
    "sq2": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
    "hex": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),  # with y-scaled cell
    # 3D
    "sc":  np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]),
    "hcp": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 5.0 / 6.0, 0.5], [0.0, 1.0 / 3.0, 0.5]]),
}


def lattice_points(style: str, spacing: float, region: Region,
                   dim: int = 3, box_region: Optional[Region] = None) -> np.ndarray:
    """Enumerate lattice sites of ``style`` with cell size ``spacing`` inside
    ``region`` (and, if given, ``box_region``). Returns (n, 3) float32; 2D
    lattices put z = 0."""
    style = style.lower()
    if style not in _BASES:
        raise ValueError(f"unknown lattice style '{style}' (have {sorted(_BASES)})")
    basis = _BASES[style].copy()
    cell = np.array([spacing, spacing, spacing])
    if style == "hex":
        cell[1] = spacing * np.sqrt(3.0)
    if dim == 2:
        cell[2] = 1.0

    lo, hi = region.bbox()
    if box_region is not None:
        blo, bhi = box_region.bbox()
        lo, hi = np.maximum(lo, blo), np.minimum(hi, bhi)
    if dim == 2:
        lo[2] = hi[2] = 0.0

    i0 = np.floor(lo / cell).astype(int) - 1
    i1 = np.ceil(hi / cell).astype(int) + 1
    if dim == 2:
        i0[2], i1[2] = 0, 0
        basis = basis[np.abs(basis[:, 2]) < 1e-12]

    ii = [np.arange(i0[d], i1[d] + 1) for d in range(3)]
    grid = np.stack(np.meshgrid(*ii, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = (grid[:, None, :] + basis[None, :, :]) * cell
    pts = pts.reshape(-1, 3)
    m = region.contains(pts)
    if box_region is not None:
        m &= box_region.contains(pts)
    return pts[m].astype(np.float32)
