"""The plain reference of one step of the bench physics, in PyTorch at any
dtype: float64 for the reference, a lower precision for the control.

It states the physics once more, from the configuration file and from the
upstream USER-SPH equations (the port's own statement of record,
``tpusph_torch/ops/pair_terms.py``, is the pattern; nothing of the port is
imported):

  sph/rhosum/multiphase  rho_i = m_i (W(0) + sum_j W(r_ij))
  sph/colorgradient      cg_i = sum_j sigma_ij (m_j/rho_j)(c_j - c_i) wfd dx
  sph/taitwater          P = B((rho/rho0)^7 - 1), B = c0^2 rho0 / 7;
                         f_i += -m_i m_j (P_i/rho_i^2 + P_j/rho_j^2 + Pi_ij)
                         wfd dx, Monaghan Pi_ij for approaching pairs;
                         drho_i += m_j dv.dx wfd; de_i += -fpair dv.dx / 2
  sph/heatconduction     de_i += 2 m_i m_j/(m_i+m_j) (rho_i+rho_j)/(rho_i
                         rho_j) D (e_i - e_j) wfd, against cv_i T_sat on
                         pairs with T_sat > 0 (the /phasechange variant)
  sph/surfacetension     f_i += m_i m_j (Pi_i/rho_i^2 + Pi_j/rho_j^2) dx wfd,
                         Pi = (|cg|^2 I / dim - cg cg^T) / max(|cg|, 1e-6)
  fix meso               v += dt/2 f/m; vest = v_old + dt f/m; x += dt v;
                         e += dt/2 de; rho += dt/2 drho; the force stage;
                         v += dt/2 f/m; e += dt/2 de; rho += dt/2 drho

with the Lucy kernel W(r) = 105/(16 pi h^3) (1 + 3q)(1 - q)^3, q = r/h.
Every sweep of the bench has the one cutoff h. The box is the scene's: the
minimum image and the wrap apply along its periodic axes only.

A reference module, found by the name a configuration file gives under
``reference`` (this one where it gives none), provides ``Physics(cfg, box,
dtype, device)``, ``step(ph, s)`` and ``rule(cfg, types, ph, s, out, pl)``,
the check's rule for what the configuration's fix phase_change does on a
firing (None where it has none): here fix phase_change's ``mode insert``
(``reference/insert.py``).
"""

from __future__ import annotations

import math

import torch

from sphbench.pairs import PairList
from sphbench.reference import insert

EPS_CG = 1e-6


class Physics:
    """The coefficients of a configuration, per type (index 0 unused)."""

    def __init__(self, cfg: dict, box, dtype, device):
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.device = dtype, device
        self.box = box
        self.h = float(cfg["h"])
        self.dt = float(cfg["dt"])
        rho0 = [1.0, cfg["rho_liquid"], cfg["rho_vapor"]]
        c0 = float(cfg["c0"])
        self.rho0 = torch.tensor(rho0, **kw)
        self.c0 = torch.tensor([c0] * 3, **kw)
        self.tait_b = torch.tensor([c0 * c0 * r / 7.0 for r in rho0], **kw)
        self.visc = float(cfg["viscosity"])
        self.heat_d = float(cfg["heat_D"])
        # unlike pairs only: the capillary coefficient and T_sat pinning
        self.sigma = float(cfg["sigma"])
        self.tsat = float(cfg["tsat"])
        self.color = torch.tensor([0.0, 1.0, 2.0], **kw)
        self.number_density = bool(cfg["rhosum_number_density"])

    def w(self, r):
        h = self.h
        s = 105.0 / (16.0 * math.pi * h ** 3)
        q = torch.clamp(r / h, max=1.0)
        return s * (1.0 + 3.0 * q) * (1.0 - q) ** 3

    def wfd(self, r):
        """(1/r) dW/dr."""
        h = self.h
        s = 105.0 / (16.0 * math.pi * h ** 3)
        q = torch.clamp(r / h, max=1.0)
        return -12.0 * s / (h * h) * (1.0 - q) ** 2


def force_stage(ph: Physics, pl: PairList, p: dict) -> dict:
    """rho by summation, the colour gradient and the fused force sweep on
    the positions of ``pl``; ``p`` holds vest, e, m, cv and type (int64).
    Returns rho, cg, f, drho, de."""
    n = p["m"].shape[0]
    typ, m = p["type"], p["m"]
    rho = torch.zeros(n, dtype=ph.dtype, device=ph.device)
    for sl, i, j, dx, rsq in pl.blocks():
        w = ph.w(torch.sqrt(rsq))
        rho.index_add_(0, i, w if ph.number_density else m[j] * w)
    w0 = ph.w(torch.zeros(1, dtype=ph.dtype, device=ph.device))
    rho = (rho + w0) * m if ph.number_density else rho + m * w0

    cg = torch.zeros(n, 3, dtype=ph.dtype, device=ph.device)
    for sl, i, j, dx, rsq in pl.blocks():
        unlike = typ[i] != typ[j]
        if not bool(unlike.any()):
            continue
        i, j, dx, rsq = i[unlike], j[unlike], dx[unlike], rsq[unlike]
        wfd = ph.wfd(torch.sqrt(rsq))
        coef = ph.sigma * (m[j] / rho[j]) \
            * (ph.color[typ[j]] - ph.color[typ[i]]) * wfd
        cg.index_add_(0, i, coef[:, None] * dx)

    f = torch.zeros(n, 3, dtype=ph.dtype, device=ph.device)
    drho = torch.zeros(n, dtype=ph.dtype, device=ph.device)
    de = torch.zeros(n, dtype=ph.dtype, device=ph.device)
    e, cv, vest = p["e"], p["cv"], p["vest"]
    p_over = ph.tait_b[typ] * ((rho / ph.rho0[typ]) ** 7 - 1.0) / (rho * rho)
    cg2 = (cg * cg).sum(-1)
    cg_norm = torch.sqrt(torch.clamp(cg2, min=EPS_CG * EPS_CG))
    for sl, i, j, dx, rsq in pl.blocks():
        r = torch.sqrt(rsq)
        wfd = ph.wfd(r)
        mi, mj, ri, rj = m[i], m[j], rho[i], rho[j]
        dv = vest[i] - vest[j]
        dvdr = (dv * dx).sum(-1)
        h = ph.h
        ci, cj = ph.c0[typ[i]], ph.c0[typ[j]]
        visc = torch.where(
            dvdr < 0.0,
            -ph.visc * (ci + cj) * h * dvdr
            / ((rsq + 0.01 * h * h) * (ri + rj)), 0.0)
        fpair = -mi * mj * (p_over[i] + p_over[j] + visc) * wfd
        fij = fpair[:, None] * dx
        deij = -0.5 * fpair * dvdr
        drhoij = mj * dvdr * wfd
        coef = (2.0 * mi * mj / (mi + mj)) * ((ri + rj) / (ri * rj))
        ediff = e[i] - e[j]
        if ph.tsat > 0.0:
            ediff = torch.where(typ[i] != typ[j], e[i] - cv[i] * ph.tsat,
                                ediff)
        deij = deij + coef * ph.heat_d * ediff * wfd

        def stress_dot(k):
            c = cg[k]
            cdx = (c * dx).sum(-1)
            return (cg2[k][:, None] * dx / 3.0 - cdx[:, None] * c) \
                / cg_norm[k][:, None]

        st = stress_dot(i) / (ri * ri)[:, None] \
            + stress_dot(j) / (rj * rj)[:, None]
        fij = fij + (mi * mj * wfd)[:, None] * st
        f.index_add_(0, i, fij)
        drho.index_add_(0, i, drhoij)
        de.index_add_(0, i, deij)
    return dict(rho=rho, cg=cg, f=f, drho=drho, de=de)


def pair_list(ph: Physics, x) -> PairList:
    """The pairs within the cutoff of the positions ``x`` in the box."""
    b = ph.box
    return PairList(x, b.length, ph.h, b.lo, b.periodic)


def step(ph: Physics, s: dict) -> dict:
    """One velocity-Verlet step of the owned particles ``s`` (x, v, vest,
    e, m, cv, type as tensors in ``ph``'s dtype and device; type int64;
    mobile, bool, which this step does not read: the bench scenes have no
    stationary rows), as the program's run of one step does it: a force
    stage on the step's start (Verlet::setup), the first half, a force
    stage, the second half.
    Returns the state after the step, the force stage's outputs and the
    pair list of the step's end positions."""
    dtf = 0.5 * ph.dt
    p = dict(s)
    pl0 = pair_list(ph, s["x"])
    st0 = force_stage(ph, pl0, p)
    del pl0
    m = s["m"][:, None]
    v1 = s["v"] + dtf * st0["f"] / m
    vest1 = s["v"] + 2.0 * dtf * st0["f"] / m
    x1 = s["x"] + ph.dt * v1
    e1 = s["e"] + dtf * st0["de"]
    p1 = dict(p, x=x1, v=v1, vest=vest1, e=e1)
    pl1 = pair_list(ph, x1)
    st1 = force_stage(ph, pl1, p1)
    out = dict(p1, v=v1 + dtf * st1["f"] / m, e=e1 + dtf * st1["de"],
               rho=st1["rho"] + dtf * st1["drho"], f=st1["f"],
               drho=st1["drho"], de=st1["de"], cg=st1["cg"])
    return out, pl1


def rule(cfg: dict, types: dict, ph: Physics, s: dict, out: dict,
         pl: PairList):
    """fix phase_change's ``mode insert`` where the configuration has a
    phase change, else None."""
    if not cfg.get("phase_change"):
        return None
    return insert.Insert(cfg, types, ph, s, out, pl)
