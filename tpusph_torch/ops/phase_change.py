"""Evaporation / phase-change mass exchange — the ``fix phase_change`` of
``tpusph/ops/phase_change.py`` on torch tensors (SURVEY.md §2.3, §3.5).

At the end of every ``every``-th step, interface liquid particles above the
temperature threshold hand a mass quantum dm to the vapour phase: either a
new vapour particle in a dead pool slot (``insert``) or the nearest owned
vapour particle (``grow``). The liquid pays latent * dm of internal energy
on top of the energy the mass carries. Ledgers:

    total mass:  exactly conserved (dm moves between phases)
    energy:      sum(e) drops by latent * dm per event
    momentum:    new vapour takes the liquid particle's velocity (insert);
                 the grown vapour takes the mass-weighted velocity (grow)

The pool has a fixed capacity: insertion activates the k-th dead slot for
the k-th selected liquid particle with scatters on the device. The hook
never syncs with the host: whether it fires is a test on the host step
count, ``changed`` stays a device bool, and the dead-slot ranking is a
cumsum and a scatter.

Randomness: each firing draws from a ``torch.Generator`` on the state's
device, seeded from (config.seed, istep) — the analog of the reference's
``fold_in(PRNGKey(seed), istep)``, so a continuation after a geometry
re-choice replays the same stream. The draws keep the reference's order
(u, then theta and phi in insert mode). Torch's generators give other bits
than JAX's threefry, and the CPU and CUDA generators differ from each
other, so with prob < 1 the set of events is not expected to match the
JAX package's or another device's. With prob = 1 and require_interface no
draw decides anything.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpusph_torch.ops.band_pair import _scatter_rows
from tpusph_torch.params import PhysicsSpec
from tpusph_torch.state import Box, ParticleState


@dataclasses.dataclass(frozen=True)
class PhaseChangeConfig:
    t_threshold: float
    latent: float
    dm: float
    liquid_type: int
    vapor_type: int
    every: int = 1
    prob: float = 1.0
    m_min: float = 0.0
    insert_offset: float = 0.0
    mode: str = "insert"          # "insert" new vapor | "grow" nearest vapor
    vapor_rho: float = 1.0
    vapor_cv: float = 1.0         # heat capacity per unit mass of new vapor
    seed: int = 12345
    require_interface: bool = True
    cutoff: float = 0.0           # interface query radius; 0 = max pair cut

    @staticmethod
    def from_script_args(args):
        """``fix ID group phase_change Tc L dm liquid_type vapor_type
        [every N] [prob P] [mmin M] [offset D] [mode insert|grow]
        [vapor_rho R] [vapor_cv C] [seed S] [cutoff C] [nointerface]``."""
        tc, latent, dm = float(args[0]), float(args[1]), float(args[2])
        lt, vt = int(args[3]), int(args[4])
        keys = {"every": ("every", int), "prob": ("prob", float),
                "mmin": ("m_min", float), "offset": ("insert_offset", float),
                "mode": ("mode", str), "vapor_rho": ("vapor_rho", float),
                "vapor_cv": ("vapor_cv", float), "seed": ("seed", int),
                "cutoff": ("cutoff", float)}
        kw = {}
        i = 5
        while i < len(args):
            k = args[i]
            if k == "nointerface":
                kw["require_interface"] = False
                i += 1
                continue
            if k not in keys:
                raise ValueError(f"fix phase_change: unknown keyword '{k}'")
            name, conv = keys[k]
            kw[name] = conv(args[i + 1])
            i += 2
        return PhaseChangeConfig(tc, latent, dm, lt, vt, **kw)


def _generator(config: PhaseChangeConfig, istep: int,
               device: torch.device) -> torch.Generator:
    """The firing's generator, seeded from (seed, istep)."""
    seed = np.random.SeedSequence([config.seed, istep]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# (i, j) entries per row chunk of the dense vapor query
_DENSE_VAPOR_CHUNK = 1 << 22


def _vapor_neighbor_dense(state: ParticleState, box: Box, vtype: int,
                          cut: float):
    """(count, nearest, nearest_rsq, nearest_owned, nearest_owned_rsq) of
    the type-``vtype`` neighbours within ``cut`` of every row, over all
    pairs: the dense backend's query (``tpusph``'s
    ``_vapor_neighbor_dense``), exactly. rsq is formed as the cell-grid
    query forms it (``cellgrid._rsq_fma``, the reference's order on the
    CPU), the threshold is cut^2 in float32, and the nearest is the first
    minimum in row order (``jnp.argmin``'s tie rule; row 0 where there is
    none). Chunked over i rows."""
    from tpusph_torch.ops.cellgrid import _rsq_fma
    n = state.capacity
    dev = state.device
    cut2 = float(np.float32(cut * cut))
    alive = state.alive
    is_vap = (state.type == vtype) & alive
    jj = torch.arange(n, device=dev)
    out = {k: [] for k in ("count", "near", "rsq", "near_o", "rsq_o")}
    step = max(1, _DENSE_VAPOR_CHUNK // max(n, 1))
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        dx = box.min_image(state.x[i0:i1, None, :] - state.x[None, :, :])
        rsq = _rsq_fma(dx[..., 0], dx[..., 1], dx[..., 2])
        ii = torch.arange(i0, i1, device=dev)
        mask = (is_vap[None, :] & (ii[:, None] != jj[None, :])
                & (rsq < cut2) & alive[i0:i1, None])
        out["count"].append(mask.sum(1))
        for key, m in (("", mask), ("_o", mask & state.owned[None, :])):
            big = torch.where(m, rsq, float("inf"))
            mn = big.min(1).values
            first = torch.where(big == mn[:, None], jj[None, :], n).min(1)
            out["near" + key].append(first.values)
            out["rsq" + key].append(mn)
    return tuple(torch.cat(out[k]) for k in
                 ("count", "near", "rsq", "near_o", "rsq_o"))


def make_end_of_step_hook(config: PhaseChangeConfig, spec: PhysicsSpec):
    """hook(state, tabs, dt, istep, aux, backend, box) -> (state, aux),
    called by the Runner after final_integrate (Modify::end_of_step)."""

    def hook(state: ParticleState, tabs, dt, istep: int, aux, backend,
             box: Box):
        if istep % config.every != 0:
            return state, aux
        state, changed = _apply_phase_change(state, istep, config, spec,
                                             backend, box, aux)
        # insertion invalidates the sort (strip or cell grid): blow up the
        # displacement reference so the next prepare rebuilds before any
        # force pass (the dense backend keeps no sort)
        if hasattr(aux, "x_ref"):
            bump = torch.where(changed, float("inf"), 0.0)
            aux = dataclasses.replace(aux, x_ref=aux.x_ref + bump)
        return state, aux

    return hook


def _apply_phase_change(state: ParticleState, istep: int,
                        config: PhaseChangeConfig, spec: PhysicsSpec,
                        backend, box: Box, aux):
    """One firing; returns (state, changed) with ``changed`` a device
    bool."""
    n = state.capacity
    dev = state.device
    cut = config.cutoff if config.cutoff > 0.0 else 1.0

    t_part = state.e / torch.clamp(state.cv, min=1e-30)
    liquid = state.alive & state.owned & (state.type == config.liquid_type)

    if config.require_interface or config.mode == "grow":
        if hasattr(backend, "vapor_neighbor"):
            vcount, vnearest, _, vnear_o, vrsq_o = backend.vapor_neighbor(
                state, box, config.vapor_type, cut, aux)
        else:
            vcount, vnearest, _, vnear_o, vrsq_o = _vapor_neighbor_dense(
                state, box, config.vapor_type, cut)
    else:
        vcount = torch.ones(n, dtype=torch.int64, device=dev)
        vnearest = torch.zeros(n, dtype=torch.int64, device=dev)
        vnear_o = torch.zeros(n, dtype=torch.int64, device=dev)
        vrsq_o = torch.zeros(n, dtype=torch.float32, device=dev)

    # energy budget: the event must leave e positive after carried + latent
    dm = config.dm
    carried_per_mass = state.e / torch.clamp(state.rmass, min=1e-30)
    e_cost = carried_per_mass * dm + config.latent * dm
    eligible = (liquid
                & (t_part > config.t_threshold)
                & (state.rmass > config.m_min + dm)
                & (state.e > e_cost))
    if config.require_interface:
        eligible = eligible & (vcount > 0)

    gen = _generator(config, istep, dev)
    u = torch.rand(n, generator=gen, device=dev)
    sel = eligible & (u < config.prob)

    if config.mode == "grow":
        # grow the nearest OWNED vapor: a ghost copy's gain would be lost at
        # the next seam refresh while the liquid is debited
        tgt = torch.clamp(vnear_o, 0, n - 1)
        do = (sel & (vcount > 0) & torch.isfinite(vrsq_o)
              & state.owned.index_select(0, tgt))
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        dm_add = zero.clone().index_add_(0, tgt, torch.where(do, dm, 0.0))
        e_add = zero.clone().index_add_(
            0, tgt, torch.where(do, carried_per_mass * dm, 0.0))
        mom_add = torch.zeros(n, 3, dtype=torch.float32, device=dev
                              ).index_add_(0, tgt, torch.where(
                                  do[:, None], dm * state.v, 0.0))
        new_rmass = state.rmass + dm_add - torch.where(do, dm, 0.0)
        new_v = torch.where(
            (dm_add > 0)[:, None],
            (state.v * state.rmass[:, None] + mom_add)
            / torch.clamp(new_rmass, min=1e-30)[:, None],
            state.v)
        new_e = state.e + e_add - torch.where(do, e_cost, 0.0)
        new_cv = state.cv + torch.where(dm_add > 0, config.vapor_cv * dm_add,
                                        0.0)
        state = dataclasses.replace(state, rmass=new_rmass, e=new_e,
                                    v=new_v, cv=new_cv)
        return state, do.any()

    # ---- insert mode: activate dead slots ---------------------------------
    idx = torch.arange(n, device=dev)
    dead = ~state.alive
    n_dead = dead.sum()
    # dead_idx[k] = the k-th dead slot in pool order (n past the last one)
    rank_dead = torch.cumsum(dead.to(torch.int64), 0) - 1
    dead_idx = torch.full((n + 1,), n, dtype=torch.int64, device=dev
                          ).scatter_(0, torch.where(dead, rank_dead, n),
                                     idx)[:n]
    sel_rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    can = sel & (sel_rank < n_dead)
    target = torch.where(
        can, dead_idx.index_select(0, torch.clamp(sel_rank, 0, n - 1)), n)

    # liquid side (only where the insert actually happens)
    state = dataclasses.replace(
        state,
        rmass=state.rmass - torch.where(can, dm, 0.0),
        e=state.e - torch.where(can, e_cost, 0.0))

    # new vapor: TOWARD the nearest vapor neighbour when there is one, a
    # random direction otherwise
    theta = torch.rand(n, generator=gen, device=dev) * 2 * math.pi
    if spec.dim == 3:
        phi = torch.arccos(torch.clamp(
            torch.rand(n, generator=gen, device=dev) * 2 - 1, -1, 1))
        offset = torch.stack([torch.sin(phi) * torch.cos(theta),
                              torch.sin(phi) * torch.sin(theta),
                              torch.cos(phi)], dim=-1)
    else:
        offset = torch.stack([torch.cos(theta), torch.sin(theta),
                              torch.zeros_like(theta)], dim=-1)
    if config.require_interface:
        vx = state.x.index_select(0, torch.clamp(vnearest, 0, n - 1))
        to_vap = box.min_image(vx - state.x)
        nrm = torch.sqrt((to_vap * to_vap).sum(-1, keepdim=True))
        dir_v = to_vap / torch.clamp(nrm, min=1e-30)
        offset = torch.where(((vcount > 0) & (nrm[:, 0] > 1e-12))[:, None],
                             dir_v, offset)
    new_x = state.x + config.insert_offset * offset
    if getattr(backend, "is_dist", False):
        # inside a brick: the global largest tag strided by the brick
        # index times the pool capacity keeps minted tags unique across
        # bricks (bounds a brick's insertions per firing by its pool)
        max_tag = backend.tag_base(n)
    else:
        max_tag = torch.where(state.alive, state.tag, 0).max()
    new_tag = (max_tag + 1 + sel_rank).to(torch.int32)

    def full(val, dtype=torch.float32):
        return torch.full((n,), val, dtype=dtype, device=dev)

    def put(arr, vals):
        # arr[target[i]] = vals[i]; rows aimed at n are dropped
        return _scatter_rows(arr, target, vals, n)

    state = dataclasses.replace(
        state,
        x=put(state.x, new_x),
        v=put(state.v, state.v),
        vest=put(state.vest, state.v),
        f=put(state.f, torch.zeros_like(state.f)),
        rho=put(state.rho, full(config.vapor_rho)),
        drho=put(state.drho, full(0.0)),
        e=put(state.e, carried_per_mass * dm),
        de=put(state.de, full(0.0)),
        vir=put(state.vir, full(0.0)),
        cv=put(state.cv, full(config.vapor_cv * dm)),
        rmass=put(state.rmass, full(dm)),
        type=put(state.type, full(config.vapor_type, torch.int32)),
        tag=put(state.tag, new_tag),
        mobile=put(state.mobile, full(True, torch.bool)),
        owned=put(state.owned, full(True, torch.bool)))
    return state, can.any()
