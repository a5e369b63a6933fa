"""Particle state on torch tensors: the counterpart of ``tpusph/state.py``
(LAMMPS ``atom_style meso``, SURVEY.md §2.2).

A structure of arrays with a FIXED capacity and an alive mask (``type ==
0`` is a dead slot), held on one explicit ``device``. The dataclasses are
frozen: every update builds a new state with ``dataclasses.replace``, so a
frozen step can hand back the pre-step state unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

_F32 = ("x", "v", "vest", "f", "rho", "drho", "e", "de", "cv", "rmass",
        "vir", "rho_c", "e_c")
_I32 = ("type", "tag")
_BOOL = ("mobile", "owned")


@dataclasses.dataclass(frozen=True)
class Box:
    """Simulation box: lo/hi are (3,) float32 tensors, ``periodic`` a
    3-tuple of Python bools (LAMMPS ``boundary p p f``)."""

    lo: torch.Tensor
    hi: torch.Tensor
    periodic: Tuple[bool, bool, bool] = (True, True, True)

    @property
    def length(self) -> torch.Tensor:
        return self.hi - self.lo

    @staticmethod
    def create(lo, hi, periodic=(True, True, True), device="cpu") -> "Box":
        return Box(lo=torch.as_tensor(np.array(lo, np.float32),
                                      device=device),
                   hi=torch.as_tensor(np.array(hi, np.float32),
                                      device=device),
                   periodic=tuple(bool(p) for p in periodic))

    def min_image(self, dx: torch.Tensor) -> torch.Tensor:
        """Minimum-image displacement along the periodic directions; dx
        has shape (..., 3). ``torch.round`` rounds half to even, as
        ``jnp.round`` does."""
        if not any(self.periodic):
            return dx
        wrapped = dx - self.length * torch.round(dx / self.length)
        mask = torch.tensor(self.periodic, device=dx.device)
        return torch.where(mask, wrapped, dx)

    def wrap(self, x: torch.Tensor) -> torch.Tensor:
        """Remap positions into the box along periodic directions
        (Domain::pbc). ``torch.remainder`` is the floor-mod that
        ``jnp.mod`` computes, so wrapped positions agree bit for bit."""
        wrapped = self.lo + torch.remainder(x - self.lo, self.length)
        mask = torch.tensor(self.periodic, device=x.device)
        return torch.where(mask, wrapped, x)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle pool; all floats float32. Fields mirror
    atom_vec_meso's per-atom state (see ``tpusph/state.py``):
    x, v, f (N, 3); vest the extrapolated velocity the pair forces read;
    rho/drho, e/de; cv; rmass; type (0 = dead); tag; mobile (False = fix
    meso/stationary); owned (False = seam-ghost copy); vir the per-particle
    pair virial; rho_c/e_c the Kahan compensations of the rho/e ledgers."""

    x: torch.Tensor
    v: torch.Tensor
    vest: torch.Tensor
    f: torch.Tensor
    rho: torch.Tensor
    drho: torch.Tensor
    e: torch.Tensor
    de: torch.Tensor
    cv: torch.Tensor
    rmass: torch.Tensor
    type: torch.Tensor
    tag: torch.Tensor
    mobile: torch.Tensor
    owned: torch.Tensor
    vir: torch.Tensor
    rho_c: torch.Tensor
    e_c: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def alive(self) -> torch.Tensor:
        return self.type > 0

    def nlocal(self) -> int:
        """Number of alive OWNED particles (seam ghosts are copies)."""
        return int((self.alive & self.owned).sum())

    def permute(self, perm: torch.Tensor) -> "ParticleState":
        """Every per-particle array reordered by ``perm`` (the cell sort)."""
        return ParticleState(**{f.name: getattr(self, f.name)[perm]
                                for f in dataclasses.fields(self)})


def state_from_numpy(arrays: dict, device="cpu") -> ParticleState:
    """Build a state from a dict of the 17 host arrays (e.g. a JAX
    package state fetched with ``jax.device_get``)."""
    out = {}
    for names, dtype in ((_F32, np.float32), (_I32, np.int32),
                         (_BOOL, bool)):
        for name in names:
            out[name] = torch.as_tensor(np.array(arrays[name], dtype),
                                        device=device)
    return ParticleState(**out)


def state_to_numpy(state: ParticleState) -> dict:
    """The 17 fields as host numpy arrays."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


def state_from_arrays(x, type, rmass, *, capacity, device, v=None, rho=None,
                      e=None, cv=None, tag=None, mobile=None, vest=None,
                      f=None, de=None, drho=None, rho_c=None,
                      e_c=None) -> ParticleState:
    """Build a state from host arrays (the create_atoms path), padded to
    ``capacity`` with dead slots. The optional integrator fields let a
    mid-run geometry re-choice rebuild the pool without losing the leapfrog
    half-step context (``ParticleState.from_arrays`` in the reference)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]

    def pad(a, fill=0.0, dt=np.float32, vec=False):
        a = (np.asarray(a, dt) if a is not None
             else np.full((n, 3) if vec else (n,), fill, dt))
        if vec and a.ndim == 1:
            a = np.broadcast_to(a[None, :], (n, 3))
        out = np.zeros((capacity, 3) if vec else (capacity,), dt)
        out[:n] = a
        return out

    return state_from_numpy(dict(
        x=pad(x, vec=True), v=pad(v, vec=True),
        vest=pad(vest if vest is not None else v, vec=True),
        f=pad(f, vec=True), rho=pad(rho, 1.0), drho=pad(drho),
        e=pad(e), de=pad(de), cv=pad(cv, 1.0), rmass=pad(rmass, 1.0),
        type=pad(type, 0, np.int32),
        tag=pad(tag if tag is not None else np.arange(1, n + 1), 0,
                np.int32),
        mobile=pad(mobile if mobile is not None else np.ones(n, bool),
                   False, bool),
        owned=pad(np.ones(n, bool), False, bool),
        vir=pad(None), rho_c=pad(rho_c), e_c=pad(e_c)), device=device)
