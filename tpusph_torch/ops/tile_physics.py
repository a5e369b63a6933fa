"""Plain PyTorch pair physics of the three strip sweeps — the counterpart
of ``tpusph/ops/tile_physics.py`` and the reference implementation the
CUDA sweeps (``csrc/strip_sweeps.cu``) are held against.

The statement of record for the physics is ``tpusph/ops/pair_terms.py``;
this module mirrors the reference's kernel-side forms term by term
(hoisted per-particle EOS p/rho^2, sound speeds, 1/rho and tension-stress
norms; the Monaghan term's fused divide; the Sterbenz kernel forms). The
reference evaluates them on (rows, W) tiles; here they run on flat pair
lists — every (i, j) of the strip windows that survives the distance test
(``strip_pair.plain_sweep``) — and the per-pair terms are summed into their
i rows. The pair SET is the kernel's; only the summation order differs.

Per-pair arrays: ``fi``/``fj`` are dicts of field rows (keys are the R*
row ids of ``rows``) gathered at the pair's i and j slots.
"""

from __future__ import annotations

import torch

from tpusph_torch import kernels
from tpusph_torch.ops.rows import (
    RCGX, RCGY, RCGZ, RCV, RE, RM, RRHO, RTYPE, RVX, RVY, RVZ, TABLES_1D,
    TABLES_2D,
)
from tpusph_torch.params import PhysicsSpec

# sph/lj van-der-Waals EOS constants (tpusph/ops/pair_terms.py)
LJ_VDW_A = 4.6709
LJ_VDW_B = 1.0549
LJ_DENOM_FLOOR = 0.05


class Lookups:
    """Coefficient lookups for one set of pairs: tables uniform over the
    real types (``spec.scalar_tables``) fold to their [1, 1] / [1] entry,
    the rest are gathered by type."""

    def __init__(self, tab2: torch.Tensor, tab1: torch.Tensor,
                 spec: PhysicsSpec, it: torch.Tensor, jt: torch.Tensor):
        self.tab2, self.tab1, self.spec = tab2, tab1, spec
        self.it, self.jt = it, jt

    def c2d(self, name):
        tab = self.tab2[TABLES_2D.index(name)]
        if name in self.spec.scalar_tables:
            return tab[1, 1]
        return tab[self.it, self.jt]

    def ci(self, name):
        tab = self.tab1[TABLES_1D.index(name)]
        if name in self.spec.scalar_tables:
            return tab[1]
        return tab[self.it]

    def cj(self, name):
        tab = self.tab1[TABLES_1D.index(name)]
        if name in self.spec.scalar_tables:
            return tab[1]
        return tab[self.jt]


def eos_over_rhosq(rho, e, rmass, rho0, b, gamma, spec: PhysicsSpec):
    """p/rho^2 per particle (pair_terms.eos_pressure_over_rhosq forms)."""
    if spec.lj:
        t = (gamma - 1.0) * e / rmass
        denom = torch.clamp(1.0 - LJ_VDW_B * rho, min=LJ_DENOM_FLOOR)
        p = rho * t / denom - LJ_VDW_A * rho * rho
    elif spec.ideal_gas and not spec.tait:
        p = (gamma - 1.0) * rho * e / rmass
    else:
        q = rho / rho0
        q3 = q * q * q
        p = b * (q3 * q3 * q - 1.0)
    return p / (rho * rho)


def gas_sound_speed(rho, e, rmass, gamma, spec: PhysicsSpec):
    if spec.lj:
        t = (gamma - 1.0) * e / rmass
        denom = torch.clamp(1.0 - LJ_VDW_B * rho, min=LJ_DENOM_FLOOR)
        return torch.sqrt(torch.clamp(gamma * t / (denom * denom)
                                      - 2.0 * LJ_VDW_A * rho, min=0.0))
    return torch.sqrt(torch.clamp(gamma * (gamma - 1.0) * e / rmass,
                                  min=0.0))


def _gas(spec: PhysicsSpec) -> bool:
    return spec.lj or (spec.ideal_gas and not spec.tait)


def hoist_i(fi: dict, tab1: torch.Tensor, spec: PhysicsSpec,
            sweep: str) -> dict:
    """Per-i quantities shared by all of a row's pairs (computed once per
    row, then gathered per pair). Dead slots carry unit rho/m under the
    sentinel-dead layout contract, so no alive masking is needed."""
    it = fi[RTYPE].long()
    lk = Lookups(None, tab1, spec, it, None)
    h = {"rho_i": fi[RRHO], "m_i": fi[RM]}
    h["inv_rho_i"] = 1.0 / h["rho_i"]
    if sweep == "force" and (spec.tait or spec.morris or spec.ideal_gas
                             or spec.lj):
        h["fi"] = eos_over_rhosq(h["rho_i"], fi[RE], h["m_i"], lk.ci("rho0"),
                                 lk.ci("tait_b"), lk.ci("gas_gamma"), spec)
        if _gas(spec):
            h["ci"] = gas_sound_speed(h["rho_i"], fi[RE], h["m_i"],
                                      lk.ci("gas_gamma"), spec)
        else:
            h["ci"] = lk.ci("c0").expand_as(h["rho_i"])
    if sweep == "force" and spec.surface_tension:
        cgx, cgy, cgz = fi[RCGX], fi[RCGY], fi[RCGZ]
        cg2 = cgx * cgx + cgy * cgy + cgz * cgz
        inv_nr = 1.0 / (torch.sqrt(torch.clamp(cg2, min=1e-12))
                        * h["rho_i"] * h["rho_i"])
        h["a_i"] = cg2 * inv_nr / spec.dim
        h["b_i"] = inv_nr
    if sweep == "cgrad":
        h["color"] = lk.ci("color").expand_as(h["rho_i"])
    return h


def tile_part_sums(fi: dict, fj: dict, h: dict, dx, rsq, lk: Lookups,
                   spec: PhysicsSpec, sweep: str):
    """Per-pair contributions to the i rows for one sweep; ``fi`` and
    ``h`` are already gathered at the pairs' i slots, ``dx`` = (dx0, dx1,
    dx2) = x_i - (x_j + image shift). Returns the sweep's tuple: (rho,),
    (cgx, cgy, cgz) or (fx, fy, fz, drho, de[, vir])."""
    w_fn = kernels.kernel_w(spec.kernel, spec.dim)
    wfd_fn = kernels.kernel_wfd(spec.kernel, spec.dim)
    dx0, dx1, dx2 = dx
    # distance liveness (sentinel-dead contract) is applied by the caller
    r = torch.sqrt(torch.clamp(rsq, min=1e-30))
    rho_i, m_i, inv_rho_i = h["rho_i"], h["m_i"], h["inv_rho_i"]
    rho_j = fj[RRHO]
    m_j = fj[RM]
    inv_rho_j = 1.0 / rho_j
    zero = torch.zeros((), dtype=rsq.dtype, device=rsq.device)

    ctx = {}

    def term(cut_name):
        key = "shared" if spec.shared_wfd else cut_name
        if key not in ctx:
            cut = lk.c2d(cut_name)
            live = (rsq < cut * cut) & (cut > 0.0)
            wfd = torch.where(live, wfd_fn(r, torch.clamp(cut, min=1e-30)),
                              zero)
            ctx[key] = (cut, live, wfd)
        return ctx[key]

    if sweep == "rho":
        cut = lk.c2d("cut_rho")
        live = (rsq < cut * cut) & (cut > 0.0)
        w = w_fn(r, torch.clamp(cut, min=1e-30))
        mass = 1.0 if spec.rhosum_nd else m_j
        return (torch.where(live, mass * w, zero),)

    if sweep == "cgrad":
        _, live, wfd = term("cut_tension")
        coef = torch.where(
            live,
            lk.c2d("sigma") * (m_j * inv_rho_j)
            * (lk.cj("color") - h["color"]) * wfd, zero)
        return (coef * dx0, coef * dx1, coef * dx2)

    f0 = f1 = f2 = drho = de = torch.zeros_like(rsq)
    e_j = fj[RE]
    dv0 = fi[RVX] - fj[RVX]
    dv1 = fi[RVY] - fj[RVY]
    dv2 = fi[RVZ] - fj[RVZ]
    dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2

    if spec.tait or spec.morris or spec.ideal_gas or spec.lj:
        cut, live, wfd = term("cut")
        fi_ = h["fi"]
        fj_ = eos_over_rhosq(rho_j, e_j, m_j, lk.cj("rho0"),
                             lk.cj("tait_b"), lk.cj("gas_gamma"), spec)
        if spec.morris:
            fvisc = torch.where(
                live,
                (m_i * inv_rho_i) * (m_j * inv_rho_j)
                * 2.0 * lk.c2d("visc") * wfd, zero)
            fpair = torch.where(live, -m_i * m_j * (fi_ + fj_) * wfd, zero)
            f0 = f0 + fpair * dx0 + fvisc * dv0
            f1 = f1 + fpair * dx1 + fvisc * dv1
            f2 = f2 + fpair * dx2 + fvisc * dv2
            dvsq = dv0 * dv0 + dv1 * dv1 + dv2 * dv2
            de = de + torch.where(
                live, -0.5 * (fpair * dvdr + fvisc * dvsq), zero)
        else:
            h_ij = torch.clamp(cut, min=1e-30)
            ci = h["ci"]
            if _gas(spec):
                cj = gas_sound_speed(rho_j, e_j, m_j, lk.cj("gas_gamma"),
                                     spec)
            else:
                cj = lk.cj("c0")
            # mu and the Monaghan prefactor fused into one divide (the
            # reference kernels' form; equal to pair_terms.force_pair's
            # algebraically)
            fvisc = torch.where(
                dvdr < 0.0,
                -lk.c2d("visc") * (ci + cj) * h_ij * dvdr
                / ((rsq + 0.01 * h_ij * h_ij) * (rho_i + rho_j)), zero)
            fpair = torch.where(live, -m_i * m_j * (fi_ + fj_ + fvisc)
                                * wfd, zero)
            f0 = f0 + fpair * dx0
            f1 = f1 + fpair * dx1
            f2 = f2 + fpair * dx2
            de = de + torch.where(live, -0.5 * fpair * dvdr, zero)
        if spec.continuity:
            drho = drho + torch.where(live, m_j * dvdr * wfd, zero)

    if spec.heatconduction or spec.heat_phasechange:
        _, live, wfd = term("cut_heat")
        coef = (2.0 * m_i * m_j / (m_i + m_j)) * (inv_rho_i + inv_rho_j)
        ediff = fi[RE] - e_j
        if spec.heat_phasechange:
            # tsat > 0 pairs conduct against cv_i*T_sat (interface pinning)
            tsat = lk.c2d("tsat")
            ediff = torch.where(tsat > 0.0, fi[RE] - fi[RCV] * tsat, ediff)
        de = de + torch.where(live, coef * lk.c2d("heat_D") * ediff * wfd,
                              zero)

    if spec.surface_tension:
        _, live, wfd = term("cut_tension")
        coef = torch.where(live, m_i * m_j * wfd, zero)
        cgx_i, cgy_i, cgz_i = fi[RCGX], fi[RCGY], fi[RCGZ]
        a_i, b_i = h["a_i"], h["b_i"]
        cgx_j, cgy_j, cgz_j = fj[RCGX], fj[RCGY], fj[RCGZ]
        cg2_j = cgx_j * cgx_j + cgy_j * cgy_j + cgz_j * cgz_j
        inv_nr_j = 1.0 / (torch.sqrt(torch.clamp(cg2_j, min=1e-12))
                          * rho_j * rho_j)
        a_j = cg2_j * inv_nr_j / spec.dim
        cdi = (cgx_i * dx0 + cgy_i * dx1 + cgz_i * dx2) * b_i
        cdj = (cgx_j * dx0 + cgy_j * dx1 + cgz_j * dx2) * inv_nr_j
        f0 = f0 + coef * ((a_i + a_j) * dx0 - cdi * cgx_i - cdj * cgx_j)
        f1 = f1 + coef * ((a_i + a_j) * dx1 - cdi * cgy_i - cdj * cgy_j)
        f2 = f2 + coef * ((a_i + a_j) * dx2 - cdi * cgz_i - cdj * cgz_j)

    outs = (f0, f1, f2, drho, de)
    if spec.virial:
        # pair virial f_ij . r_ij from the pair's summed force terms
        outs = outs + (f0 * dx0 + f1 * dx1 + f2 * dx2,)
    return outs


def rho_self(fld: torch.Tensor, tab2: torch.Tensor, spec: PhysicsSpec):
    """(n,) rhosum self term: W(0, cut_rho[t, t]) per row, x m_i for the
    mass form (the number-density form's m_i multiplies the whole sum in
    force_stage). The port always folds it into the rho sweep — a per-type
    diagonal lookup is cheap on the card — where the reference folds it
    in-kernel only for a scalar cut_rho and otherwise adds it in XLA."""
    w_fn = kernels.kernel_w(spec.kernel, spec.dim)
    it = fld[RTYPE].long()
    cut = tab2[TABLES_2D.index("cut_rho")][it, it]
    w0 = torch.where(cut > 0.0,
                     w_fn(torch.zeros_like(cut), torch.clamp(cut, min=1e-30)),
                     0.0)
    if spec.rhosum_nd:
        return w0
    return fld[RM] * w0

