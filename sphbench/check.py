"""How a run's ``correct`` is decided.

Three parts, each against what the benchmark itself made or computed:

- the start: the program's state before its first step against the
  inputs that the scene's ``make_inputs`` made from the seed (exact);
- the ledgers after the window: every particle of the inputs owned
  exactly once and every inserted one once (exact), and the total mass
  against the inputs' (the configuration's stated guarantee);
- one step of the window's own entry on the window's own simulation at
  the timed size (``Simulation.run(1)`` after the window), from the
  program's state, against the plain reference in float64 (the
  configuration's reference module, ``reference/sph.py`` where it names
  none): positions, velocities, energies, densities (the summation), the
  force stage's f, drho and de (pair forces with the colour gradient's
  capillary term, continuity, heat conduction) and, where the
  configuration has a phase change, the numbers of the reference
  module's rule: the mass ledger and, on a firing, which particles fire
  and what they insert (``reference/insert.py``).

The reference follows the program's state: it cannot follow hundreds of
chaotic float32 steps from the inputs. Everything it can, it works out
again: neighbours, densities, forces and the rule's decisions.

The control (``control=True``) is the same reference computed in
bfloat16 and put in the program's place.
"""

from __future__ import annotations

from types import ModuleType
from typing import NamedTuple

import numpy as np
import torch

from sphbench.pairs import Box

STEP_FIELDS = ("x", "v", "e", "rho", "f", "drho", "de")


class Case(NamedTuple):
    """What the reference is built from: the configuration, its scene's
    box and type ids, and its reference module."""

    cfg: dict
    box: Box
    types: dict
    module: ModuleType


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


class Reference:
    """The reference's step from the program's state ``snap_s``, in
    ``dtype`` on ``device``, and its rule (None without phase change)."""

    def __init__(self, case: Case, snap_s, dtype, device):
        mod = case.module
        self.ph = mod.Physics(case.cfg, case.box, dtype, device)
        rows = _owned_rows(snap_s)
        self.tags = snap_s["tag"][rows].astype(np.int64)

        def t(name, dt=dtype):
            return torch.as_tensor(snap_s[name][rows]).to(device, dt)

        # mobile: False on the rows of fix meso/stationary (walls)
        s = dict(x=t("x"), v=t("v"), vest=t("vest"), e=t("e"),
                 m=t("rmass"), cv=t("cv"), type=t("type", torch.int64),
                 mobile=t("mobile", torch.bool))
        self.pre = s
        self.out, self.pl = mod.step(self.ph, s)
        self.rule = mod.rule(case.cfg, case.types, self.ph, s, self.out,
                             self.pl)


def _row_of(snap_p, tags_s) -> np.ndarray:
    """Per old tag: its owned row in the program's state after the step,
    -1 where it has none."""
    alive = snap_p["type"] > 0
    owned_rows = np.nonzero(alive & snap_p["owned"])[0]
    tag_of = snap_p["tag"][owned_rows].astype(np.int64)
    order = np.argsort(tag_of, kind="stable")
    pos = np.searchsorted(tag_of[order], tags_s)
    pos = np.clip(pos, 0, max(len(order) - 1, 0))
    found = tag_of[order][pos] == tags_s
    return np.where(found, owned_rows[order][pos], -1)


def program_candidate(snap_p, ref: Reference) -> dict:
    """What the program's step produced, by old tag, with what the rule
    reads of its firing."""
    tags = ref.tags
    row_of = _row_of(snap_p, tags)
    ok = row_of >= 0
    r = np.where(ok, row_of, 0)

    def field(name):
        a = snap_p[name][r].astype(np.float64)
        a[~ok] = np.nan
        return a

    cand = {k: field(k) for k in STEP_FIELDS}
    cand["m"] = field("rmass")
    if ref.rule is not None:
        ref.rule.program(cand, snap_p, tags, row_of)
    return cand


def control_candidate(case: Case, snap_s, snap_p, seed, istep,
                      device) -> dict:
    """The reference in bfloat16 in the program's place: its step, and
    its rule's own decisions on the program's rows and draws."""
    low = Reference(case, snap_s, torch.bfloat16, device)
    o = {k: v.double().cpu().numpy() for k, v in low.out.items()
         if k in STEP_FIELDS}
    cand = dict(o, m=low.pre["m"].double().cpu().numpy())
    if low.rule is not None:
        low.rule.control(cand, low.out, snap_p, low.tags,
                         _row_of(snap_p, low.tags), seed, istep)
    return cand


def step_numbers(ref: Reference, cand: dict, snap_p, seed, istep,
                 firing: bool) -> dict:
    """The candidate's step against the reference's, and the rule's
    numbers."""
    out = {k: v.double().cpu().numpy() for k, v in ref.out.items()}
    rule = ref.rule
    e_ref = out["e"] if rule is None else rule.e_after(out["e"], cand,
                                                        firing)
    nums = {}
    vmax = np.abs(out["v"]).max()

    def worst(a, b, scale, d=None):
        d = np.abs(a - b) if d is None else d
        if not len(d):
            return 0.0
        return float(np.nan_to_num(d, nan=np.inf).max() / scale)

    dxx = ref.ph.box.min_image(cand["x"] - out["x"])
    nums["x_err"] = worst(cand["x"], out["x"], ref.ph.dt * vmax,
                          np.abs(dxx))
    nums["v_err"] = worst(cand["v"], out["v"], vmax)
    nums["e_err"] = worst(cand["e"], e_ref, np.abs(e_ref).max())
    for k in ("rho", "f", "drho", "de"):
        nums[f"{k}_err"] = worst(cand[k], out[k],
                                 np.abs(out[k]).max())
    if rule is not None:
        nums.update(rule.numbers(out, cand, snap_p, ref.tags,
                                 _row_of(snap_p, ref.tags), seed, istep,
                                 firing))
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
