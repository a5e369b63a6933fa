"""How a run's ``correct`` is decided.

Three parts, each against what the benchmark itself made or computed:

- the start: the program's state before its first step against the
  inputs that ``scene.make_inputs`` made from the seed (exact);
- the ledgers after the window: every particle of the inputs owned
  exactly once and every inserted one once (exact), and the total mass
  against the inputs' (the configuration's stated guarantee);
- one step of the window's own entry on the window's own simulation at
  the timed size (``Simulation.run(1)`` after the window), from the
  program's state, against the plain reference (``reference/sph.py``) in
  float64: positions, velocities, energies, densities (the summation), the
  force stage's f, drho and de (pair forces with the colour gradient's
  capillary term, continuity, heat conduction), the mass ledger and, on a
  phase-change firing, which particles fire and what they insert.

The reference follows the program's state: it cannot follow hundreds of
chaotic float32 steps from the inputs. Which particles fire is a draw
over the program's rows (fix phase_change seeds a generator from (seed,
step) and draws one number per row), so the reference reads the rows'
order from the program's state and draws the same numbers; everything
else it works out again: neighbours, densities, forces, eligibility, the
direction to the nearest vapour particle.

The control (``control=True``) is the same reference computed in
bfloat16 and put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from sphbench.reference import sph
from sphbench.scene import LIQUID, VAPOUR

STEP_FIELDS = ("x", "v", "e", "rho", "f", "drho", "de")
# a decision within this share of its threshold may go either way by a
# float32 rounding: it is not judged
BORDER = 1e-4


def snapshot(sim) -> dict:
    """Host copy of the program's state rows, positions global."""
    from tpusph_torch.state import state_to_numpy
    snap = state_to_numpy(sim.state)
    snap["x"] = sim._host_x(snap)
    snap["ndev"] = len(sim.mesh) if sim.mesh else 1
    snap["device_type"] = sim.state.x.device.type
    return snap


def _owned_rows(snap) -> np.ndarray:
    rows = np.nonzero((snap["type"] > 0) & snap["owned"])[0]
    return rows[np.argsort(snap["tag"][rows], kind="stable")]


def start_numbers(sim, inputs: dict) -> dict:
    """The program's state before its first step against the inputs."""
    from tpusph_torch.state import state_to_numpy
    sim.get("tag")      # builds the state as the first run would
    snap = state_to_numpy(sim.state)
    rows = _owned_rows(snap)
    if len(rows) != len(inputs["x"]) or (
            snap["tag"][rows] != np.arange(1, len(rows) + 1)).any():
        return {"start_err": float("inf")}
    worst = 0.0
    for field, key in (("x", "x"), ("v", "v"), ("type", "type"),
                       ("rmass", "rmass"), ("e", "e"), ("rho", "rho"),
                       ("cv", "cv")):
        got = snap[field][rows].astype(np.float64)
        worst = max(worst, float(np.abs(got - inputs[key]).max()))
    return {"start_err": worst}


def ledger_numbers(snap, inputs: dict) -> dict:
    """Every input particle owned once, every inserted one once, and the
    total mass against the inputs'."""
    rows = _owned_rows(snap)
    tags = snap["tag"][rows].astype(np.int64)
    n0 = len(inputs["x"])
    old = tags[tags <= n0]
    seen = np.bincount(old, minlength=n0 + 1)[1:]
    new = tags[tags > n0]
    lost = int((seen != 1).sum()) + int(len(new) - len(np.unique(new)))
    m0 = float(inputs["rmass"].astype(np.float64).sum())
    m1 = float(snap["rmass"][rows].astype(np.float64).sum())
    return {"tags_lost": lost, "mass_drift": abs(m1 - m0) / m0}


def _u_draws(seed: int, istep: int, cap: int, device_type: str):
    """The firing's draws over one pool of ``cap`` rows: fix
    phase_change's rule (a torch.Generator on the state's device, seeded
    from (seed, step)), first draw of the firing."""
    s = np.random.SeedSequence([seed, istep]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device_type)
    gen.manual_seed(int(s))
    return torch.rand(cap, generator=gen, device=device_type).cpu().numpy()


class Reference:
    """The reference's step from the program's state ``snap_s`` (and, on
    a firing, its phase-change decisions), in ``dtype`` on ``device``."""

    def __init__(self, cfg, snap_s, dtype, device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.ph = sph.Physics(cfg, dtype, device)
        rows = _owned_rows(snap_s)
        self.tags = snap_s["tag"][rows].astype(np.int64)

        def t(name, dt=dtype):
            return torch.as_tensor(snap_s[name][rows]).to(device, dt)

        s = dict(x=t("x"), v=t("v"), vest=t("vest"), e=t("e"),
                 m=t("rmass"), cv=t("cv"), type=t("type", torch.int64))
        self.pre = s
        self.out, self.pl = sph.step(self.ph, s)
        self.pc = cfg.get("phase_change")
        if self.pc:
            m_liq = cfg["rho_liquid"] * cfg["dx"] ** 3
            self.dm = self.pc["dm_fraction"] * m_liq
            self.offset = self.pc["insert_offset"] * cfg["dx"]
            e, m, cv = self.out["e"], s["m"], s["cv"]
            latent = self.pc["latent"]
            self.e_cost = e / m * self.dm + latent * self.dm
            count, best = sph.vapour_near(self.ph, self.pl, s["type"],
                                          VAPOUR)
            self.best = best
            thr = self.pc["t_threshold"]
            temp = e / cv
            cut2 = self.ph.h ** 2
            self.eligible = ((s["type"] == LIQUID) & (temp > thr)
                             & (m > self.dm) & (e > self.e_cost)
                             & (count > 0))
            self.border = ((torch.abs(temp - thr) < BORDER * thr)
                           | (torch.abs(e - self.e_cost)
                              < BORDER * self.e_cost)
                           | (torch.abs(best - cut2) < BORDER * cut2))

    def directions(self, parents: torch.Tensor):
        return sph.nearest_directions(self.ph, self.pl, self.pre["type"],
                                      VAPOUR, parents, self.best, BORDER)


def _pool_rows(snap_p, tags_s):
    """Per owned row of each old tag in the program's state after the
    step: its row; and the rows that were dead when the firing ran (dead
    now, or holding a particle the firing inserted)."""
    alive = snap_p["type"] > 0
    owned_rows = np.nonzero(alive & snap_p["owned"])[0]
    tag_of = snap_p["tag"][owned_rows].astype(np.int64)
    order = np.argsort(tag_of, kind="stable")
    pos = np.searchsorted(tag_of[order], tags_s)
    pos = np.clip(pos, 0, max(len(order) - 1, 0))
    found = tag_of[order][pos] == tags_s
    row_of = np.where(found, owned_rows[order][pos], -1)
    old = np.isin(snap_p["tag"], tags_s)
    pre_dead = ~alive | (alive & ~old)
    return row_of, pre_dead


def fire(selected: np.ndarray, row_of: np.ndarray, pre_dead: np.ndarray,
         ndev: int) -> tuple[np.ndarray, np.ndarray]:
    """fix phase_change's insertion rule on the pools: in each brick's
    pool the k-th selected row (in row order) fills the k-th dead row, as
    far as there are dead rows. Returns (fired mask over the old tags,
    target row of each fired one, -1 elsewhere)."""
    cap = len(pre_dead) // ndev
    fired = np.zeros(len(selected), bool)
    target = np.full(len(selected), -1, np.int64)
    idx = np.nonzero(selected & (row_of >= 0))[0]
    rows = row_of[idx]
    for b in range(ndev):
        inb = (rows >= b * cap) & (rows < (b + 1) * cap)
        k = idx[inb][np.argsort(rows[inb], kind="stable")]
        dead = np.nonzero(pre_dead[b * cap:(b + 1) * cap])[0] + b * cap
        k = k[:len(dead)]
        fired[k] = True
        target[k] = dead[:len(k)]
    return fired, target


def program_candidate(snap_s, snap_p, ref: Reference) -> dict:
    """What the program's step produced, by old tag, with the particles
    it inserted by their parents."""
    tags = ref.tags
    row_of, pre_dead = _pool_rows(snap_p, tags)
    ok = row_of >= 0
    r = np.where(ok, row_of, 0)

    def field(name):
        a = snap_p[name][r].astype(np.float64)
        a[~ok] = np.nan
        return a

    cand = {k: field(k) for k in STEP_FIELDS}
    cand["m"] = field("rmass")
    if ref.pc:
        m_s = snap_s["rmass"][_owned_rows(snap_s)]
        parents = ok & (snap_p["rmass"][r] < m_s)
        _, target = fire(parents, row_of, pre_dead, snap_p["ndev"])
        cand["parents"] = parents
        t = np.where(target >= 0, target, 0)
        placed = target >= 0
        newborn = placed & (snap_p["type"][t] > 0) \
            & ~np.isin(snap_p["tag"][t], tags)
        cand["new_ok"] = newborn[parents]
        cand["new"] = {k: snap_p[k][t][parents].astype(np.float64)
                       for k in ("x", "v", "e", "rmass", "rho", "cv",
                                 "type")}
    return cand


def control_candidate(cfg, snap_s, snap_p, seed, istep, device) -> dict:
    """The reference in bfloat16 in the program's place: its step, and on
    a firing its own decisions on the program's rows and draws."""
    low = Reference(cfg, snap_s, torch.bfloat16, device)
    o = {k: v.double().cpu().numpy() for k, v in low.out.items()
         if k in STEP_FIELDS}
    cand = dict(o, m=low.pre["m"].double().cpu().numpy())
    row_of, pre_dead = _pool_rows(snap_p, low.tags)
    if low.pc:
        sel = _selection(low, row_of, snap_p, seed, istep)
        parents, _ = fire(sel, row_of, pre_dead, snap_p["ndev"])
        cand["parents"] = parents
        cand["m"] = cand["m"] - np.where(parents, low.dm, 0.0)
        p = torch.as_tensor(np.nonzero(parents)[0], device=device)
        k, d = low.directions(p)
        first = np.full(len(p), -1)
        kk = k.cpu().numpy()
        first[kk[::-1]] = np.arange(len(kk))[::-1]
        dirs = d.double().cpu().numpy()[np.clip(first, 0, None)]
        pre = {n: v.double().cpu().numpy()[parents]
               for n, v in (("x", low.out["x"]), ("v", low.out["v"]),
                            ("e", low.out["e"]), ("m", low.pre["m"]))}
        cand["e"] = cand["e"] - np.where(
            parents, low.e_cost.double().cpu().numpy(), 0.0)
        cand["new_ok"] = np.ones(len(p), bool)
        cand["new"] = dict(
            x=pre["x"] + low.offset * dirs, v=pre["v"],
            e=pre["e"] / pre["m"] * low.dm,
            rmass=np.full(len(p), low.dm), rho=np.full(
                len(p), float(torch.tensor(cfg["rho_vapor"],
                                           dtype=torch.bfloat16))),
            cv=np.full(len(p), low.dm), type=np.full(len(p), VAPOUR))
    return cand


def _selection(ref: Reference, row_of, snap_p, seed, istep) -> np.ndarray:
    """Which old tags the firing selects by ``ref``'s eligibility and the
    program's draws on their rows."""
    ndev = snap_p["ndev"]
    cap = len(snap_p["type"]) // ndev
    u = _u_draws(seed, istep, cap, snap_p["device_type"])
    ok = row_of >= 0
    uu = np.where(ok, u[np.where(ok, row_of, 0) % cap], 1.0)
    return ref.eligible.cpu().numpy() & ok & (uu < ref.pc["prob"])


def step_numbers(ref: Reference, cand: dict, snap_p, seed, istep,
                 firing: bool) -> dict:
    """The candidate's step against the reference's."""
    out = {k: v.double().cpu().numpy() for k, v in ref.out.items()}
    length = ref.ph.length
    m_ref = ref.pre["m"].double().cpu().numpy().copy()
    e_ref = out["e"].copy()
    nums = {}
    if firing:
        parents = cand["parents"]
        m_ref -= np.where(parents, ref.dm, 0.0)
        e_ref -= np.where(parents, ref.e_cost.double().cpu().numpy(), 0.0)
    vmax = np.abs(out["v"]).max()

    def worst(a, b, scale, d=None):
        d = np.abs(a - b) if d is None else d
        if not len(d):
            return 0.0
        return float(np.nan_to_num(d, nan=np.inf).max() / scale)

    dxx = cand["x"] - out["x"]
    dxx -= length * np.round(dxx / length)
    nums["x_err"] = worst(cand["x"], out["x"], ref.ph.dt * vmax,
                          np.abs(dxx))
    nums["v_err"] = worst(cand["v"], out["v"], vmax)
    nums["e_err"] = worst(cand["e"], e_ref, np.abs(e_ref).max())
    for k in ("rho", "f", "drho", "de"):
        nums[f"{k}_err"] = worst(cand[k], out[k],
                                 np.abs(out[k]).max())
    if not ref.pc:
        return nums
    nums["m_err"] = worst(cand["m"], m_ref, ref.dm)
    if not firing:
        nums.update(pc_events_off=0, pc_err=0.0, pc_x_err=0.0)
        return nums
    row_of, pre_dead = _pool_rows(snap_p, ref.tags)
    sel = _selection(ref, row_of, snap_p, seed, istep)
    want, _ = fire(sel, row_of, pre_dead, snap_p["ndev"])
    border = ref.border.cpu().numpy()
    parents = cand["parents"]
    nums["pc_events_off"] = int(((want != parents) & ~border).sum())
    idx = np.nonzero(parents)[0]
    new = cand["new"]
    if len(idx) == 0:
        nums.update(pc_err=0.0, pc_x_err=0.0)
        return nums
    e_exp = out["e"][idx] / ref.pre["m"].double().cpu().numpy()[idx] \
        * ref.dm
    vcv = ref.dm   # vapor_cv (1.0) times dm
    errs = np.stack([
        np.abs(new["v"] - out["v"][idx]).max(-1) / vmax,
        np.abs(new["e"] - e_exp) / np.abs(e_exp).max(),
        np.abs(new["rmass"] - ref.dm) / ref.dm,
        np.abs(new["rho"] - ref.cfg["rho_vapor"]) / ref.cfg["rho_vapor"],
        np.abs(new["cv"] - vcv) / vcv,
        (new["type"] != VAPOUR).astype(np.float64)], 0).max(0)
    errs = np.where(cand["new_ok"], errs, np.inf)
    ok = ~border[idx]
    nums["pc_err"] = float(np.nan_to_num(errs[ok], nan=np.inf).max()) \
        if ok.any() else 0.0
    # the inserted particle's position against every direction to a
    # vapour neighbour as near as the nearest
    k, d = ref.directions(torch.as_tensor(idx, device=ref.device))
    k, d = k.cpu().numpy(), d.double().cpu().numpy()
    exp = out["x"][idx][k] + ref.offset * d
    dd = new["x"][k] - exp
    dd -= length * np.round(dd / length)
    dist = np.sqrt((dd * dd).sum(-1)) / ref.offset
    best = np.full(len(idx), np.inf)
    np.minimum.at(best, k, dist)
    best = np.where(cand["new_ok"], best, np.inf)
    nums["pc_x_err"] = float(np.nan_to_num(best[ok], nan=np.inf).max()) \
        if ok.any() else 0.0
    return nums


LARGEST = float(np.finfo(np.float64).max)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or below its
    limit; a number without a limit, or a limit without its number, fails.
    A number that could not be formed (inf, nan) reads as the largest
    float, so that the result stays plain JSON."""
    table, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v <= lim
        ok &= good
        if v is not None and not np.isfinite(v):
            v = LARGEST
        table[name] = {"value": v, "limit": lim}
    return ok, table
