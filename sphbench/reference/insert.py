"""fix phase_change's ``mode insert`` as the check's rule: which liquid
particles fire on a firing step and what each inserts, worked out again
from the reference's step, and the numbers that hold the program's firing
to it.

On a firing step a liquid particle above ``t_threshold`` whose mass and
energy can pay (dm = ``dm_fraction`` of a liquid particle's mass, its
energy share and the latent heat) and that has a vapour neighbour fires
with probability ``prob``: it gives dm and that energy to a new vapour
particle placed ``insert_offset`` dx toward its nearest vapour neighbour,
with its velocity, rho_vapor and cv = dm (vapor_cv 1). Which particles
fire is a draw over the program's rows (a torch.Generator seeded from
(seed, step), one number per row of a brick's pool), so the rule reads the
rows' order from the program's state and draws the same numbers; the k-th
fired row of a pool fills the k-th dead row of that pool. Nothing of the
program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

# a decision within this share of its threshold may go either way by a
# float32 rounding: it is not judged
BORDER = 1e-4


def vapour_near(ph, pl, typ, vapour_type: int):
    """Per row: the vapour neighbours within the cutoff (count) and the
    smallest rsq to one (inf where none), from the step's pair list."""
    n = typ.shape[0]
    count = torch.zeros(n, dtype=torch.int64, device=typ.device)
    best = torch.full((n,), float("inf"), dtype=ph.dtype, device=ph.device)
    for sl, i, j, dx, rsq in pl.blocks():
        vap = typ[j] == vapour_type
        count.index_add_(0, i[vap], torch.ones_like(i[vap]))
        best.scatter_reduce_(0, i[vap], rsq[vap], reduce="amin")
    return count, best


def nearest_directions(ph, pl, typ, vapour_type: int, rows, best,
                       rel: float):
    """For each row in ``rows``: the unit directions to every vapour
    neighbour whose rsq is within ``rel`` of the smallest (a near tie may
    be broken either way by a rounding), as (pair row, direction)."""
    want = torch.full((typ.shape[0],), -1, dtype=torch.int64,
                      device=typ.device)
    want[rows] = torch.arange(rows.shape[0], device=typ.device)
    out_k, out_dir = [], []
    for sl, i, j, dx, rsq in pl.blocks():
        k = want[i]
        sel = (k >= 0) & (typ[j] == vapour_type) \
            & (rsq <= best[i] * (1.0 + rel))
        if bool(sel.any()):
            d = -dx[sel]          # toward the vapour: x_j - x_i
            out_k.append(k[sel])
            # a low precision can round two positions to one: no direction
            norm = torch.sqrt((d * d).sum(-1, keepdim=True))
            out_dir.append(d / torch.clamp(norm, min=1e-30))
    if not out_k:
        return (torch.zeros(0, dtype=torch.int64, device=typ.device),
                torch.zeros(0, 3, dtype=ph.dtype, device=ph.device))
    return torch.cat(out_k), torch.cat(out_dir)


def u_draws(seed: int, istep: int, cap: int, device_type: str):
    """The firing's draws over one pool of ``cap`` rows: fix
    phase_change's rule (a torch.Generator on the state's device, seeded
    from (seed, step)), first draw of the firing."""
    s = np.random.SeedSequence([seed, istep]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device_type)
    gen.manual_seed(int(s))
    return torch.rand(cap, generator=gen, device=device_type).cpu().numpy()


def pre_dead(snap_p, tags_s) -> np.ndarray:
    """The rows of the program's state after the step that were dead when
    the firing ran: dead now, or holding a particle the firing inserted."""
    alive = snap_p["type"] > 0
    old = np.isin(snap_p["tag"], tags_s)
    return ~alive | (alive & ~old)


def fire(selected: np.ndarray, row_of: np.ndarray, dead_rows: np.ndarray,
         ndev: int) -> tuple[np.ndarray, np.ndarray]:
    """The insertion on the pools: in each brick's pool the k-th selected
    row (in row order) fills the k-th dead row, as far as there are dead
    rows. Returns (fired mask over the old tags, target row of each fired
    one, -1 elsewhere)."""
    cap = len(dead_rows) // ndev
    fired = np.zeros(len(selected), bool)
    target = np.full(len(selected), -1, np.int64)
    idx = np.nonzero(selected & (row_of >= 0))[0]
    rows = row_of[idx]
    for b in range(ndev):
        inb = (rows >= b * cap) & (rows < (b + 1) * cap)
        k = idx[inb][np.argsort(rows[inb], kind="stable")]
        dead = np.nonzero(dead_rows[b * cap:(b + 1) * cap])[0] + b * cap
        k = k[:len(dead)]
        fired[k] = True
        target[k] = dead[:len(k)]
    return fired, target


class Insert:
    """The rule on the reference's step: ``s`` the state at the step's
    start and ``out`` after it (tensors by old tag), ``pl`` the pair list
    of the step's end positions; ``types`` the scene's type ids."""

    def __init__(self, cfg, types, ph, s, out, pl):
        self.cfg, self.ph, self.pre, self.pl = cfg, ph, s, pl
        self.pc = pc = cfg["phase_change"]
        self.liquid, self.vapour = types["liquid"], types["vapour"]
        m_liq = cfg["rho_liquid"] * cfg["dx"] ** 3
        self.dm = pc["dm_fraction"] * m_liq
        self.offset = pc["insert_offset"] * cfg["dx"]
        e, m, cv = out["e"], s["m"], s["cv"]
        latent = pc["latent"]
        self.e_cost = e / m * self.dm + latent * self.dm
        count, best = vapour_near(ph, pl, s["type"], self.vapour)
        self.best = best
        thr = pc["t_threshold"]
        temp = e / cv
        cut2 = ph.h ** 2
        self.eligible = ((s["type"] == self.liquid) & (temp > thr)
                         & (m > self.dm) & (e > self.e_cost)
                         & (count > 0))
        self.border = ((torch.abs(temp - thr) < BORDER * thr)
                       | (torch.abs(e - self.e_cost) < BORDER * self.e_cost)
                       | (torch.abs(best - cut2) < BORDER * cut2))

    def directions(self, parents: torch.Tensor):
        return nearest_directions(self.ph, self.pl, self.pre["type"],
                                  self.vapour, parents, self.best, BORDER)

    def selection(self, row_of, snap_p, seed, istep) -> np.ndarray:
        """Which old tags the firing selects by this eligibility and the
        program's draws on their rows."""
        ndev = snap_p["ndev"]
        cap = len(snap_p["type"]) // ndev
        u = u_draws(seed, istep, cap, snap_p["device_type"])
        ok = row_of >= 0
        uu = np.where(ok, u[np.where(ok, row_of, 0) % cap], 1.0)
        return self.eligible.cpu().numpy() & ok & (uu < self.pc["prob"])

    def program(self, cand: dict, snap_p, tags, row_of):
        """The program's firing, into ``cand``: its parents (old particles
        that lost mass) and what each inserted (``new``; ``new_ok`` where
        the row it had to fill holds a particle the firing inserted)."""
        ok = row_of >= 0
        r = np.where(ok, row_of, 0)
        m_s = self.pre["m"].cpu().numpy()
        parents = ok & (snap_p["rmass"][r] < m_s)
        _, target = fire(parents, row_of, pre_dead(snap_p, tags),
                         snap_p["ndev"])
        cand["parents"] = parents
        t = np.where(target >= 0, target, 0)
        placed = target >= 0
        newborn = placed & (snap_p["type"][t] > 0) \
            & ~np.isin(snap_p["tag"][t], tags)
        cand["new_ok"] = newborn[parents]
        cand["new"] = {k: snap_p[k][t][parents].astype(np.float64)
                       for k in ("x", "v", "e", "rmass", "rho", "cv",
                                 "type")}

    def control(self, cand: dict, out: dict, snap_p, tags, row_of, seed,
                istep):
        """This rule's own firing in the program's place, into ``cand``:
        its decisions on the program's rows and draws, in its dtype."""
        sel = self.selection(row_of, snap_p, seed, istep)
        parents, _ = fire(sel, row_of, pre_dead(snap_p, tags),
                          snap_p["ndev"])
        cand["parents"] = parents
        cand["m"] = cand["m"] - np.where(parents, self.dm, 0.0)
        p = torch.as_tensor(np.nonzero(parents)[0], device=self.ph.device)
        k, d = self.directions(p)
        first = np.full(len(p), -1)
        kk = k.cpu().numpy()
        first[kk[::-1]] = np.arange(len(kk))[::-1]
        dirs = d.double().cpu().numpy()[np.clip(first, 0, None)]
        pre = {n: v.double().cpu().numpy()[parents]
               for n, v in (("x", out["x"]), ("v", out["v"]),
                            ("e", out["e"]), ("m", self.pre["m"]))}
        cand["e"] = cand["e"] - np.where(
            parents, self.e_cost.double().cpu().numpy(), 0.0)
        cand["new_ok"] = np.ones(len(p), bool)
        cand["new"] = dict(
            x=pre["x"] + self.offset * dirs, v=pre["v"],
            e=pre["e"] / pre["m"] * self.dm,
            rmass=np.full(len(p), self.dm), rho=np.full(
                len(p), float(torch.tensor(self.cfg["rho_vapor"],
                                           dtype=self.ph.dtype))),
            cv=np.full(len(p), self.dm), type=np.full(len(p), self.vapour))

    def e_after(self, e: np.ndarray, cand: dict, firing: bool):
        """The old particles' energies after the firing: each parent pays
        its cost."""
        if not firing:
            return e
        return e - np.where(cand["parents"],
                            self.e_cost.double().cpu().numpy(), 0.0)

    def numbers(self, out: dict, cand: dict, snap_p, tags, row_of, seed,
                istep, firing: bool) -> dict:
        """m_err (the old particles' masses), and on a firing
        pc_events_off (particles that fire where the rule says not, or the
        reverse, off the border), pc_err (what each inserted particle
        carries) and pc_x_err (where it sits) against this rule on the
        reference's step (``out``, host float64)."""
        m_ref = self.pre["m"].double().cpu().numpy().copy()
        if firing:
            m_ref -= np.where(cand["parents"], self.dm, 0.0)
        d = np.abs(cand["m"] - m_ref)
        nums = {"m_err": float(np.nan_to_num(d, nan=np.inf).max() / self.dm)
                if len(d) else 0.0}
        if not firing:
            nums.update(pc_events_off=0, pc_err=0.0, pc_x_err=0.0)
            return nums
        sel = self.selection(row_of, snap_p, seed, istep)
        want, _ = fire(sel, row_of, pre_dead(snap_p, tags), snap_p["ndev"])
        border = self.border.cpu().numpy()
        parents = cand["parents"]
        nums["pc_events_off"] = int(((want != parents) & ~border).sum())
        idx = np.nonzero(parents)[0]
        new = cand["new"]
        if len(idx) == 0:
            nums.update(pc_err=0.0, pc_x_err=0.0)
            return nums
        vmax = np.abs(out["v"]).max()
        e_exp = out["e"][idx] / self.pre["m"].double().cpu().numpy()[idx] \
            * self.dm
        vcv = self.dm   # vapor_cv (1.0) times dm
        rho_v = self.cfg["rho_vapor"]
        errs = np.stack([
            np.abs(new["v"] - out["v"][idx]).max(-1) / vmax,
            np.abs(new["e"] - e_exp) / np.abs(e_exp).max(),
            np.abs(new["rmass"] - self.dm) / self.dm,
            np.abs(new["rho"] - rho_v) / rho_v,
            np.abs(new["cv"] - vcv) / vcv,
            (new["type"] != self.vapour).astype(np.float64)], 0).max(0)
        errs = np.where(cand["new_ok"], errs, np.inf)
        ok = ~border[idx]
        nums["pc_err"] = float(np.nan_to_num(errs[ok], nan=np.inf).max()) \
            if ok.any() else 0.0
        # the inserted particle's position against every direction to a
        # vapour neighbour as near as the nearest
        k, d = self.directions(torch.as_tensor(idx, device=self.ph.device))
        k, d = k.cpu().numpy(), d.double().cpu().numpy()
        exp = out["x"][idx][k] + self.offset * d
        dd = self.ph.box.min_image(new["x"][k] - exp)
        dist = np.sqrt((dd * dd).sum(-1)) / self.offset
        best = np.full(len(idx), np.inf)
        np.minimum.at(best, k, dist)
        best = np.where(cand["new_ok"], best, np.inf)
        nums["pc_x_err"] = float(np.nan_to_num(best[ok], nan=np.inf).max()) \
            if ok.any() else 0.0
        return nums
