"""SPH smoothing kernels and derivatives on torch tensors, 2D and 3D
normalizations — the counterpart of ``tpusph/kernels.py``.

Conventions are the reference's: ``cut`` is the FULL support radius
(LAMMPS ``pair_coeff`` ``h``), and two functions per kernel:

  w(r, cut, dim)    -> W(r)          the kernel value, 0 for r >= cut
  wfd(r, cut, dim)  -> (1/r) dW/dr   grad_i W = wfd * (x_i - x_j)

The forms are the reference's Sterbenz forms term by term: (1-q) powers
folded into plain (cut - r) powers with the cut-dependence in one constant
built from divides, so fp32 results agree with the JAX package to a few
ulps. ``r`` and ``cut`` are float32 tensors; Python-float constants are
applied in float32, as JAX's weak typing does. The CUDA sweeps in
``csrc/strip_sweeps.cu`` carry the same formulas.
"""

from __future__ import annotations

import math
from functools import partial

import torch

LUCY = 0
CUBIC_SPLINE = 1
QUINTIC_SPLINE = 2
WENDLAND_C2 = 3

KERNEL_NAMES = {
    "lucy": LUCY,
    "cubic": CUBIC_SPLINE,
    "cubicspline": CUBIC_SPLINE,
    "quintic": QUINTIC_SPLINE,
    "quinticspline": QUINTIC_SPLINE,
    "wendland": WENDLAND_C2,
    "wendland/c2": WENDLAND_C2,
}


def _cdiv(c: float, t):
    """c / t as ONE float32 division. torch evaluates a Python scalar over a
    tensor as reciprocal(t) * c — two roundings — where JAX divides."""
    if torch.is_tensor(t):
        return torch.full_like(t, c) / t
    return c / t


def _lucy_sigma(cut, dim):
    if dim == 3:
        return _cdiv(105.0 / (16.0 * math.pi), cut * cut * cut)
    return _cdiv(5.0 / math.pi, cut * cut)


def lucy_w(r, cut, dim):
    s = _lucy_sigma(cut, dim)
    icut = 1.0 / cut
    q = torch.clamp(r * icut, 0.0, 1.0)
    s6 = ((s / cut) / cut) / cut
    d = torch.clamp(cut - r, min=0.0)
    return torch.where(r < cut, s6 * (1.0 + 3.0 * q) * d * d * d, 0.0)


def lucy_wfd(r, cut, dim):
    s = _lucy_sigma(cut, dim)
    s5 = ((-12.0 * s) / cut) / cut
    d = torch.clamp(cut - r, min=0.0)
    return torch.where(r < cut, (s5 / cut) / cut * (d * d), 0.0)


def _cubic_sigma(h, dim):
    if dim == 3:
        return 1.0 / (math.pi * h * h * h)
    return _cdiv(10.0, 7.0 * math.pi * h * h)


def cubic_w(r, cut, dim):
    h = cut / 2.0
    u = torch.clamp(r / h, 0.0, 2.0)
    s = _cubic_sigma(h, dim)
    inner = 1.0 - 1.5 * u * u + 0.75 * u * u * u
    tmu = 2.0 - u
    outer = 0.25 * tmu * tmu * tmu
    return torch.where(r < cut, s * torch.where(u <= 1.0, inner, outer), 0.0)


def cubic_wfd(r, cut, dim):
    h = cut / 2.0
    u = torch.clamp(r / h, 0.0, 2.0)
    s = _cubic_sigma(h, dim)
    tmu = 2.0 - u
    wfd_inner = s * (-3.0 + 2.25 * u) / (h * h)
    r_safe = torch.where(r > 0.0, r, 1.0)
    wfd_outer = s * (-0.75 * tmu * tmu) / (h * r_safe)
    return torch.where(r < cut, torch.where(u <= 1.0, wfd_inner, wfd_outer),
                       0.0)


def _quintic_sigma(h, dim):
    if dim == 3:
        return 1.0 / (120.0 * math.pi * h * h * h)
    return _cdiv(7.0, 478.0 * math.pi * h * h)


def _plus_pow5(x):
    xp = torch.clamp(x, min=0.0)
    x2 = xp * xp
    return x2 * x2 * xp


def _plus_pow4(x):
    xp = torch.clamp(x, min=0.0)
    x2 = xp * xp
    return x2 * x2


def quintic_w(r, cut, dim):
    h = cut / 3.0
    u = torch.clamp(r / h, 0.0, 3.0)
    s = _quintic_sigma(h, dim)
    val = (_plus_pow5(3.0 - u) - 6.0 * _plus_pow5(2.0 - u)
           + 15.0 * _plus_pow5(1.0 - u))
    return torch.where(r < cut, s * val, 0.0)


def quintic_wfd(r, cut, dim):
    h = cut / 3.0
    u = torch.clamp(r / h, 0.0, 3.0)
    s = _quintic_sigma(h, dim)
    dwdu = -5.0 * (_plus_pow4(3.0 - u) - 6.0 * _plus_pow4(2.0 - u)
                   + 15.0 * _plus_pow4(1.0 - u))
    # lim_{u->0} (dW/du)/u = -120: a series-safe divide
    u_safe = torch.where(u > 1e-6, u, 1.0)
    ratio = torch.where(u > 1e-6, dwdu / u_safe, -120.0)
    return torch.where(r < cut, s * ratio / (h * h), 0.0)


def _wendland_sigma(cut, dim):
    if dim == 3:
        return _cdiv(21.0 / (2.0 * math.pi), cut * cut * cut)
    return _cdiv(7.0 / math.pi, cut * cut)


def wendland_w(r, cut, dim):
    s = _wendland_sigma(cut, dim)
    icut = 1.0 / cut
    q = torch.clamp(r * icut, 0.0, 1.0)
    s4 = (((s / cut) / cut) / cut) / cut
    d = torch.clamp(cut - r, min=0.0)
    d2 = d * d
    return torch.where(r < cut, s4 * d2 * d2 * (4.0 * q + 1.0), 0.0)


def wendland_wfd(r, cut, dim):
    s = _wendland_sigma(cut, dim)
    s5 = ((((-20.0 * s) / cut) / cut) / cut) / cut
    d = torch.clamp(cut - r, min=0.0)
    return torch.where(r < cut, (s5 / cut) * d * d * d, 0.0)


_W_FNS = {LUCY: lucy_w, CUBIC_SPLINE: cubic_w, QUINTIC_SPLINE: quintic_w,
          WENDLAND_C2: wendland_w}
_WFD_FNS = {LUCY: lucy_wfd, CUBIC_SPLINE: cubic_wfd,
            QUINTIC_SPLINE: quintic_wfd, WENDLAND_C2: wendland_wfd}


def kernel_w(kernel_id: int, dim: int):
    """Return w(r, cut) for a static kernel id and dimension."""
    return partial(_W_FNS[kernel_id], dim=dim)


def kernel_wfd(kernel_id: int, dim: int):
    """Return wfd(r, cut) = (1/r) dW/dr for a static kernel id and
    dimension."""
    return partial(_WFD_FNS[kernel_id], dim=dim)



def kernel_id_from_name(name: str) -> int:
    """The kernel id of a ``kernel_style`` name: case, ``_`` and ``-``
    are ignored (``quintic_spline``, ``Wendland-C2``)."""
    key = name.strip().lower().replace("_", "").replace("-", "")
    key = {"quinticspline": "quintic", "cubicspline": "cubic",
           "wendlandc2": "wendland"}.get(key, key)
    if key not in KERNEL_NAMES:
        raise ValueError(f"unknown SPH kernel '{name}' "
                         f"(have {sorted(KERNEL_NAMES)})")
    return KERNEL_NAMES[key]
