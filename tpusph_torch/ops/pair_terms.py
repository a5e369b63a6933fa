"""Per-pair SPH physics, stated once: the counterpart of
``tpusph/ops/pair_terms.py`` on torch tensors, the port's statement of
record (the dense backend computes with it; ``ops/tile_physics.py``, the
body of the strip, band and column sweeps, is held equal to it by the
tests).

Shape-polymorphic: the ``i`` and ``j`` sides are dicts of tensors with a
common broadcastable batch shape ``(...,)`` (vectors ``(..., 3)``).
Coefficients arrive as a ``coefs`` dict of pairwise tensors built by
``make_pair_coefs`` from the device tables by integer type indexing.

Equation provenance (SURVEY.md §2.2-2.3; upstream USER-SPH pair styles):

  sph/rhosum              rho_i = sum_j m_j W(r_ij)   (self term included)
  sph/taitwater           Tait EOS P = B[(rho/rho0)^7 - 1], B = c0^2 rho0/7;
                          force -m_i m_j (P_i/rho_i^2 + P_j/rho_j^2 + Pi_ij)
                          wfd dx with Monaghan viscosity Pi_ij for approaching
                          pairs; continuity drho_i += m_j v_ij.dx wfd;
                          viscous/compressive heating into de.
  sph/taitwater/morris    same EOS; Morris (1997) laminar viscosity along dv.
  sph/idealgas            P = (gamma - 1) rho (e / m).
  sph/lj                  van-der-Waals form of the LJ gas EOS.
  sph/heatconduction      de_i += (2 m_i m_j/(m_i+m_j)) ((rho_i+rho_j)/
                                  (rho_i rho_j)) D (e_i - e_j) wfd
  sph/colorgradient       cg_i = sum_j sigma_ij (m_j/rho_j)(c_j - c_i) grad W
  sph/surfacetension      Hu & Adams (2006) capillary stress
                          Pi = (|cg|^2 I/dim - cg cg^T)/max(|cg|, eps)
"""

from __future__ import annotations

from typing import Dict

import torch

from tpusph_torch import kernels
from tpusph_torch.ops.rows import TABLES_1D, TABLES_2D
from tpusph_torch.params import DeviceTables, PhysicsSpec

EPS_CG = 1e-6  # |colorgradient| floor for the capillary stress

# sph/lj EOS: the van-der-Waals form calibrated to the LJ critical point
# (Tc* = 1.312, rhoc* = 0.316): b = 1/(3 rhoc*), a = (9/8) Tc*/rhoc*
LJ_VDW_A = 4.6709
LJ_VDW_B = 1.0549
LJ_DENOM_FLOOR = 0.05  # (1 - b rho) floor: keeps P finite past packing

# the tables the force and colour-gradient sweeps need, by arity
PAIR_TABLES_2D = ("cut", "visc", "heat_D", "cut_heat", "sigma",
                  "cut_tension", "tsat")
PAIR_TABLES_1D = ("rho0", "tait_b", "c0", "gas_gamma", "color")


def make_pair_coefs(tabs: DeviceTables, it, jt) -> Dict:
    """Pairwise coefficient tensors by integer type indexing; ``it`` and
    ``jt`` are broadcastable int64 type tensors."""
    c = {}
    for name in PAIR_TABLES_2D:
        c[name] = tabs.tab2[TABLES_2D.index(name)][it, jt]
    for name in PAIR_TABLES_1D:
        tab = tabs.tab1[TABLES_1D.index(name)]
        c[name + "_i"] = tab[it]
        c[name + "_j"] = tab[jt]
    return c


def eos_pressure_over_rhosq(rho, e, rmass, rho0, tait_b, gamma,
                            spec: PhysicsSpec):
    """(P/rho^2, P) for the enabled EOS (Tait, ideal gas or LJ). Inputs
    pre-sanitized (rho > 0 on dead slots is the caller's job)."""
    if spec.lj:
        t = (gamma - 1.0) * e / rmass
        denom = torch.clamp(1.0 - LJ_VDW_B * rho, min=LJ_DENOM_FLOOR)
        p = rho * t / denom - LJ_VDW_A * rho * rho
    elif spec.ideal_gas and not spec.tait:
        p = (gamma - 1.0) * rho * e / rmass
    else:
        q = rho / rho0
        q3 = q * q * q
        p = tait_b * (q3 * q3 * q - 1.0)
    return p / (rho * rho), p


def lj_sound_speed(rho, e, rmass, gamma):
    """c = sqrt(max(gamma T/(1-b rho)^2 - 2 a rho, 0)): the isothermal vdW
    stiffness with the adiabatic gamma factor, clamped past the
    spinodal."""
    t = (gamma - 1.0) * e / rmass
    denom = torch.clamp(1.0 - LJ_VDW_B * rho, min=LJ_DENOM_FLOOR)
    return torch.sqrt(torch.clamp(gamma * t / (denom * denom)
                                  - 2.0 * LJ_VDW_A * rho, min=0.0))


def rho_summation_pair(pj, r, cut_ij, mask, spec: PhysicsSpec):
    """Contribution of j to rho_i: m_j W(r) (sph/rhosum), or W(r) under
    the number-density form (the caller multiplies by m_i after adding the
    self term)."""
    w = kernels.kernel_w(spec.kernel, spec.dim)(
        r, torch.clamp(cut_ij, min=1e-30))
    mass = 1.0 if spec.rhosum_nd else pj["rmass"]
    return torch.where(mask & (cut_ij > 0.0), mass * w, 0.0)


def color_gradient_pair(pi, pj, dx, r, coefs, mask, spec: PhysicsSpec):
    """sigma_ij (m_j/rho_j)(c_j - c_i) grad_i W, shape (..., 3). sigma is
    folded in here, so the capillary stress needs no further factor."""
    cut_ij = coefs["cut_tension"]
    live = mask & (cut_ij > 0.0)
    wfd = kernels.kernel_wfd(spec.kernel, spec.dim)(
        r, torch.clamp(cut_ij, min=1e-30))
    rho_j = torch.where(live, pj["rho"], 1.0)
    coef = torch.where(
        live,
        coefs["sigma"] * (pj["rmass"] / rho_j)
        * (coefs["color_j"] - coefs["color_i"]) * wfd, 0.0)
    return coef[..., None] * dx


def _capillary_stress_dot_dx(cg, dx, dim):
    """(Pi . dx) for the Hu-Adams stress
    Pi = (|cg|^2 I/dim - cg cg^T)/max(|cg|, eps); cg, dx: (..., 3)."""
    cg2 = (cg * cg).sum(-1)
    norm = torch.sqrt(torch.clamp(cg2, min=EPS_CG * EPS_CG))
    cg_dot_dx = (cg * dx).sum(-1)
    return (cg2[..., None] * dx / dim - cg_dot_dx[..., None] * cg) \
        / norm[..., None]


def force_pair(pi, pj, dx, rsq, mask, coefs, spec: PhysicsSpec,
               cg_i=None, cg_j=None):
    """Every force-sweep pair term fused: a dict of f (..., 3), drho and
    de (...) (and vir under ``spec.virial``), the contributions TO i.

    ``dx = x_i - x_j`` (periodic image applied), ``rsq = |dx|^2``; ``mask``
    excludes self pairs and dead slots. No Newton halving: each side sums
    its own pairs."""
    r = torch.sqrt(torch.clamp(rsq, min=1e-30))
    f = torch.zeros_like(dx)
    drho = torch.zeros_like(rsq)
    de = torch.zeros_like(rsq)
    wfd_fn = kernels.kernel_wfd(spec.kernel, spec.dim)
    mi, mj = pi["rmass"], pj["rmass"]
    dv = pi["vest"] - pj["vest"]
    dvdr = (dv * dx).sum(-1)

    def gate(cut):
        live = mask & (rsq < cut * cut) & (cut > 0.0)
        wfd = torch.where(live, wfd_fn(r, torch.clamp(cut, min=1e-30)), 0.0)
        return (live, wfd, torch.where(live, pi["rho"], 1.0),
                torch.where(live, pj["rho"], 1.0),
                torch.where(live, mi, 1.0), torch.where(live, mj, 1.0))

    if spec.tait or spec.morris or spec.ideal_gas or spec.lj:
        cut_ij = coefs["cut"]
        live, wfd, rho_i, rho_j, m_i, m_j = gate(cut_ij)
        fi, _ = eos_pressure_over_rhosq(
            rho_i, pi["e"], m_i, coefs["rho0_i"], coefs["tait_b_i"],
            coefs["gas_gamma_i"], spec)
        fj, _ = eos_pressure_over_rhosq(
            rho_j, pj["e"], m_j, coefs["rho0_j"], coefs["tait_b_j"],
            coefs["gas_gamma_j"], spec)
        if spec.morris:
            # Morris laminar viscosity: along dv, not dx
            fvisc_coef = 2.0 * coefs["visc"] / (rho_i * rho_j)
            fvisc = torch.where(live, m_i * m_j * fvisc_coef * wfd, 0.0)
            fpair = torch.where(live, -m_i * m_j * (fi + fj) * wfd, 0.0)
            f = f + fpair[..., None] * dx + fvisc[..., None] * dv
            de = de + torch.where(
                live, -0.5 * (fpair * dvdr + fvisc * (dv * dv).sum(-1)),
                0.0)
        else:
            # Monaghan artificial viscosity for approaching pairs
            h_ij = torch.clamp(cut_ij, min=1e-30)
            ci, cj = coefs["c0_i"], coefs["c0_j"]
            if spec.lj:
                gi, gj = coefs["gas_gamma_i"], coefs["gas_gamma_j"]
                ci = lj_sound_speed(rho_i, pi["e"], m_i, gi)
                cj = lj_sound_speed(rho_j, pj["e"], m_j, gj)
            elif spec.ideal_gas and not spec.tait:
                gi, gj = coefs["gas_gamma_i"], coefs["gas_gamma_j"]
                ci = torch.sqrt(torch.clamp(gi * (gi - 1.0) * pi["e"] / m_i,
                                            min=0.0))
                cj = torch.sqrt(torch.clamp(gj * (gj - 1.0) * pj["e"] / m_j,
                                            min=0.0))
            # mu = h dvdr/(rsq + 0.01 h^2) and the Monaghan prefactor fused
            # into one divide (the kernel mirrors' form)
            fvisc = torch.where(
                dvdr < 0.0,
                -coefs["visc"] * (ci + cj) * h_ij * dvdr
                / ((rsq + 0.01 * h_ij * h_ij) * (rho_i + rho_j)), 0.0)
            fpair = torch.where(live, -m_i * m_j * (fi + fj + fvisc) * wfd,
                                0.0)
            f = f + fpair[..., None] * dx
            de = de + torch.where(live, -0.5 * fpair * dvdr, 0.0)
        if spec.continuity:
            drho = drho + torch.where(live, m_j * dvdr * wfd, 0.0)

    if spec.heatconduction or spec.heat_phasechange:
        live, wfd, rho_i, rho_j, m_i, m_j = gate(coefs["cut_heat"])
        coef = (2.0 * m_i * m_j / (m_i + m_j)) \
            * ((rho_i + rho_j) / (rho_i * rho_j))
        ediff = pi["e"] - pj["e"]
        if spec.heat_phasechange:
            # tsat > 0 pairs conduct against cv_i*T_sat (interface pinning)
            tsat = coefs["tsat"]
            ediff = torch.where(tsat > 0.0, pi["e"] - pi["cv"] * tsat, ediff)
        de = de + torch.where(live, coef * coefs["heat_D"] * ediff * wfd,
                              0.0)

    if spec.surface_tension:
        live, wfd, rho_i, rho_j, m_i, m_j = gate(coefs["cut_tension"])
        # f_i += m_i m_j (Pi_i/rho_i^2 + Pi_j/rho_j^2) . dx wfd over ALL
        # pairs within cut_tension (sigma already inside cg)
        pi_dx = _capillary_stress_dot_dx(cg_i, dx, spec.dim) \
            / (rho_i * rho_i)[..., None]
        pj_dx = _capillary_stress_dot_dx(cg_j, dx, spec.dim) \
            / (rho_j * rho_j)[..., None]
        f = f + torch.where(live, m_i * m_j * wfd, 0.0)[..., None] \
            * (pi_dx + pj_dx)

    out = dict(f=f, drho=drho, de=de)
    if spec.virial:
        # pair virial f_ij . r_ij over every term that produced force
        out["vir"] = (f * dx).sum(-1)
    return out
