"""Physics configuration: which pair terms are enabled (a frozen, hashable
dataclass) and their coefficient tables — the counterpart of
``tpusph/params.py`` (``pair_style hybrid/overlay`` + ``pair_coeff``,
SURVEY.md §2.2-2.3, §2.9).

The enabled terms are fused into at most three sweeps over the same
neighbour structure: rho (sph/rhosum), the colour gradient (surface
tension), and the force sweep. Tables are 1-indexed by LAMMPS type
(row/column 0 unused), held on the host as float32 numpy arrays and moved
to the device once per run (``PairTables.stacked``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpusph_torch import kernels
from tpusph_torch.ops.rows import TABLES_1D, TABLES_2D


@dataclasses.dataclass(frozen=True)
class PhysicsSpec:
    """Static physics switches (see ``tpusph.params.PhysicsSpec`` for each
    field's reference style)."""

    dim: int = 3
    kernel: int = kernels.LUCY
    rhosum_every: int = 0         # sph/rhosum N (0 = continuity only)
    rhosum_nd: bool = False       # sph/rhosum/multiphase number density
    tait: bool = False            # sph/taitwater
    morris: bool = False          # sph/taitwater/morris
    ideal_gas: bool = False       # sph/idealgas
    lj: bool = False              # sph/lj
    heatconduction: bool = False  # sph/heatconduction
    heat_phasechange: bool = False  # sph/heatconduction/phasechange
    surface_tension: bool = False  # sph/colorgradient + sph/surfacetension
    phase_change: bool = False    # fix phase_change
    continuity: bool = True
    gravity: bool = False
    # perf flags derived from the concrete tables (api._derive_perf_flags):
    # tables uniform over real types, and one shared active cutoff
    scalar_tables: tuple = ()
    shared_wfd: bool = False
    virial: bool = False


def _t1(ntypes, fill=0.0):
    return np.full((ntypes + 1,), fill, np.float32)


def _t2(ntypes, fill=0.0):
    return np.full((ntypes + 1, ntypes + 1), fill, np.float32)


class DeviceTables(NamedTuple):
    """PairTables on the device: (8, T1, T1) pair tables in TABLES_2D
    order, (5, T1) type tables in TABLES_1D order, the gravity vector, and
    per sweep the square of the largest cutoff it can use (a pair at or
    beyond it contributes nothing, so the sweeps skip it first)."""
    tab2: torch.Tensor
    tab1: torch.Tensor
    gravity: torch.Tensor
    cutmax2: dict


@dataclasses.dataclass
class PairTables:
    """Per-type(-pair) coefficient tables, 1-indexed (see
    ``tpusph.params.PairTables`` for the pair_coeff surface)."""

    rho0: np.ndarray
    c0: np.ndarray
    tait_b: np.ndarray
    gas_gamma: np.ndarray
    visc: np.ndarray
    heat_D: np.ndarray
    sigma: np.ndarray
    tsat: np.ndarray
    color: np.ndarray
    gravity: np.ndarray
    cut: np.ndarray
    cut_rho: np.ndarray
    cut_heat: np.ndarray
    cut_tension: np.ndarray

    @property
    def ntypes(self) -> int:
        return self.rho0.shape[0] - 1

    @staticmethod
    def zeros(ntypes: int) -> "PairTables":
        return PairTables(
            rho0=_t1(ntypes, 1.0), c0=_t1(ntypes), tait_b=_t1(ntypes),
            gas_gamma=_t1(ntypes, 1.4), visc=_t2(ntypes),
            heat_D=_t2(ntypes), sigma=_t2(ntypes), tsat=_t2(ntypes),
            color=np.arange(ntypes + 1, dtype=np.float32),
            gravity=np.zeros(3, np.float32), cut=_t2(ntypes),
            cut_rho=_t2(ntypes), cut_heat=_t2(ntypes),
            cut_tension=_t2(ntypes))

    def max_cut(self) -> float:
        """Largest support radius across all sweeps."""
        return float(max(self.cut.max(), self.cut_rho.max(),
                         self.cut_heat.max(), self.cut_tension.max()))

    def stacked(self, device) -> "DeviceTables":
        """The tables on ``device`` in the layout the strip sweeps read."""
        t2 = np.stack([getattr(self, n) for n in TABLES_2D])
        t1 = np.stack([getattr(self, n) for n in TABLES_1D])

        def sq(*names):
            # square of the largest cutoff, in float32 like the sweeps'
            # rsq < cut*cut tests, so pruning by it is exact
            c = np.float32(max(getattr(self, n).max() for n in names))
            return float(c * c)

        return DeviceTables(
            tab2=torch.as_tensor(t2, dtype=torch.float32, device=device),
            tab1=torch.as_tensor(t1, dtype=torch.float32, device=device),
            gravity=torch.as_tensor(self.gravity, dtype=torch.float32,
                                    device=device),
            cutmax2={"rho": sq("cut_rho"), "cgrad": sq("cut_tension"),
                     "force": sq("cut", "cut_heat", "cut_tension")})

    # -- pair_coeff-style setters --------------------------------------------

    def _set2(self, name, i, j, value):
        arr = getattr(self, name)
        arr[i, j] = value
        arr[j, i] = value

    def _set1(self, name, i, value):
        getattr(self, name)[i] = value

    def set_taitwater(self, i, j, rho0, c0, viscosity, h):
        """pair_coeff i j sph/taitwater rho0 c0 alpha h (also morris)."""
        for t in {i, j}:
            self._set1("rho0", t, rho0)
            self._set1("c0", t, c0)
            self._set1("tait_b", t, c0 * c0 * rho0 / 7.0)
        self._set2("visc", i, j, viscosity)
        self._set2("cut", i, j, h)

    def set_idealgas(self, i, j, viscosity, h):
        """pair_coeff i j sph/idealgas alpha h."""
        self._set2("visc", i, j, viscosity)
        self._set2("cut", i, j, h)

    def set_lj(self, i, j, viscosity, h):
        """pair_coeff i j sph/lj nu h (the vdW EOS itself is
        parameter-free in LJ reduced units)."""
        self._set2("visc", i, j, viscosity)
        self._set2("cut", i, j, h)

    def set_rhosum(self, i, j, h):
        self._set2("cut_rho", i, j, h)

    def set_heatconduction(self, i, j, d, h, tsat: float = 0.0):
        """pair_coeff i j sph/heatconduction D h [Tsat] (the /phasechange
        variant pins the pair's conduction to T_sat)."""
        self._set2("heat_D", i, j, d)
        self._set2("cut_heat", i, j, h)
        if tsat:
            self._set2("tsat", i, j, tsat)

    def set_surfacetension(self, i, j, sigma, h):
        """sigma on the i-j interface; the capillary-stress cutoff is set
        for (i,i), (j,j) and (i,j) — the stress divergence needs same-phase
        neighbours too."""
        self._set2("sigma", i, j, sigma)
        self._set2("cut_tension", i, j, h)
        self._set2("cut_tension", i, i, h)
        self._set2("cut_tension", j, j, h)

    def set_color(self, i, color):
        self._set1("color", i, color)

    def set_gravity(self, g):
        """fix gravity's body acceleration vector."""
        self.gravity = np.asarray(g, np.float32).reshape(3).copy()


def tables_from_numpy(arrays: dict) -> PairTables:
    """PairTables from a dict of host arrays (e.g. a JAX package
    PairTables fetched with ``jax.device_get``)."""
    return PairTables(**{f.name: np.array(arrays[f.name], np.float32)
                         for f in dataclasses.fields(PairTables)})
