"""Throughput benchmark of the torch port: particle-steps/s on the bench
configuration of ``tpusph/bench.py`` (3D periodic two-phase box: rhosum +
taitwater + heat conduction + CSF surface tension, a vapour sphere in
liquid), driven through ``Simulation.run``.

The JSON keys are the reference's, plus where the number was taken: torch
and CUDA versions, the device's name and its power limit. There is no
stepping down to a smaller size on failure: a failure is a failure.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

BASELINE_NODE_PSPS = 5.0e7  # estimated reference single-node particle-steps/s
WARMUP_MAX = 8               # warmup windows at most


def card_info() -> tuple[str, str]:
    """(name, power limit) of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return name, limit


def build_bench_sim(n_particles: int, dim: int = 3, multiphase: bool = True,
                    mode: str = "dynamic", device=None):
    """A periodic two-phase block: a vapour sphere inside liquid.

    Modes (``tpusph.bench.build_bench_sim``):
      uniform — both phases at rho0 = 1, zero velocities (kernel ceiling);
      dynamic — vapour rho0 = 0.1 via number-density rhosum plus a thermal
                velocity field (rebuilds inside every timed window).
    The boiling mode needs fix phase_change (ROADMAP Queue 1 item 8)."""
    from tpusph_torch.api import Simulation

    if mode not in ("uniform", "dynamic"):
        raise NotImplementedError(
            f"bench mode {mode!r} needs fix phase_change (ROADMAP Queue 1 "
            "item 8)")
    sim = Simulation(dim=dim, screen=False, device=device)
    per_side = int(round(n_particles ** (1.0 / dim)))
    dx = 1.0
    L = per_side * dx
    h = 3.0 * dx
    rho0 = 1.0
    m = rho0 * dx**dim
    contrast = mode == "dynamic"
    rho_v = 0.1 if contrast else rho0

    per = (True, True, True) if dim == 3 else (True, True, False)
    sim.create_box([0, 0, 0], [L, L, L if dim == 3 else 1.0],
                   periodic=per, ntypes=2 if multiphase else 1)
    ax = np.arange(per_side, dtype=np.float32) * dx
    if dim == 3:
        g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    else:
        g2 = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
        g = np.concatenate([g2, np.zeros((len(g2), 1), np.float32)], axis=1)

    types = np.ones(len(g), np.int32)
    if multiphase:
        c = L / 2.0
        r = np.linalg.norm(g - c, axis=1)
        types[r < L / 5.0] = 2
    vap = types == 2
    v = None
    if mode == "dynamic":
        # thermal velocity field (Mach ~0.06): max displacement reaches
        # skin/2 every ~40-60 steps -> >= 1 rebuild per 50-step window
        rng = np.random.default_rng(7)
        v = rng.normal(0.0, 0.35, g.shape).astype(np.float32)
        if dim == 2:
            v[:, 2] = 0.0
        v -= v.mean(axis=0, keepdims=True)
    sim.add_particles(g, types, v=v,
                      rho=np.where(vap, rho_v, rho0).astype(np.float32),
                      e=1.0, cv=1.0,
                      rmass=np.where(vap, rho_v * dx**dim, m
                                     ).astype(np.float32))
    sim.pair_rhosum(every=1, number_density=contrast)
    sim.pair_taitwater(morris=False)
    sim.pair_heatconduction()
    pairs = [(i, j) for i in ((1, 2) if multiphase else (1,))
             for j in range(i, (2 if multiphase else 1) + 1)]
    # cross pair first: set_taitwater writes rho0/c0 for BOTH types
    for i, j in sorted(pairs, key=lambda p: p[0] == p[1]):
        sim.tables.set_taitwater(i, j, rho0=rho_v if i == j == 2 else rho0,
                                 c0=10.0, viscosity=0.3, h=h)
        sim.tables.set_rhosum(i, j, h=h)
        sim.tables.set_heatconduction(i, j, d=0.05, h=h)
    if multiphase:
        sim.pair_surfacetension()
        sim.tables.set_surfacetension(1, 2, sigma=0.05, h=h)
    sim.neighbor_skin = 1.0 * dx
    sim.dt = 2e-3 if mode == "uniform" else 5e-3
    sim.thermo(0)
    return sim


def _sync(sim):
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def run_bench(n_particles: int = 1_000_000, n_steps: int = 50, dim: int = 3,
              multiphase: bool = True, n_windows: int = 3,
              mode: str = "dynamic", device=None, sim=None) -> dict:
    """Median of ``n_windows`` timed windows of ``n_steps`` each, after
    warmup windows that run until one passes with no geometry re-choice
    (the lattice-to-fluid transition re-chooses the margins; that belongs
    outside the timed region). Rebuild counts per window are reported so
    a window that rebuilt more often reads as slower, not as noise.
    ``sim`` takes a simulation already built by ``build_bench_sim``."""
    if sim is None:
        sim = build_bench_sim(n_particles, dim=dim, multiphase=multiphase,
                              mode=mode, device=device)
    n = sim.natoms

    def rebuilds():
        return int(sim.aux.nbuilds.sum())

    sim.run(n_steps)
    _sync(sim)
    warmup_windows = 1
    prev = -1
    while warmup_windows < WARMUP_MAX and sim._strip_violations != prev:
        prev = sim._strip_violations
        sim.run(n_steps)
        _sync(sim)
        warmup_windows += 1

    walls, nbuilds = [], []
    for _ in range(n_windows):
        nb0 = rebuilds()
        t0 = time.perf_counter()
        sim.run(n_steps)
        _sync(sim)
        walls.append(time.perf_counter() - t0)
        nbuilds.append(rebuilds() - nb0)

    dt_wall = float(np.median(walls))
    psps = n * n_steps / dt_wall
    styles = {"uniform": "rhosum+taitwater+heatcond+CSF, quiescent",
              "dynamic": "rhosum/multiphase+taitwater+heatcond+CSF, "
                         "density contrast 10x + thermal field"}[mode]
    name, limit = card_info() if sim.device.type == "cuda" \
        else (sim.device.type, "not measured")
    return {
        "metric": f"particle-steps/sec/chip @ {n} particles "
                  f"({dim}D multiphase: {styles}, backend=strip)",
        "mode": mode,
        "value": round(psps, 1),
        "unit": "particle-steps/s",
        # an ESTIMATED reference single-node LAMMPS CPU throughput; the
        # reference publishes no SPH numbers (tpusph/bench.py)
        "vs_baseline": round(psps / BASELINE_NODE_PSPS, 6),
        "baseline_range": [2.0e7, 1.0e8],
        "vs_baseline_range": [round(psps / 1.0e8, 6),
                              round(psps / 2.0e7, 6)],
        "wall_s": round(dt_wall, 3),
        "windows_s": [round(w, 3) for w in walls],
        "rebuilds_per_window": nbuilds,
        "geometry_rechoices": sim._strip_violations,
        "geometry_decays": 0,
        "warmup_windows": warmup_windows,
        "strip_w": sim._strip_geom.w,
        "steps": n_steps,
        "particles": int(n),
        "device": str(sim.device),
        "device_name": name,
        "power_limit": limit,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


if __name__ == "__main__":
    print(json.dumps(run_bench()))
