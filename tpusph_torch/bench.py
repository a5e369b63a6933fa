"""Throughput benchmark of the torch port: particle-steps/s on the bench
configuration of ``tpusph/bench.py`` (3D periodic two-phase box: rhosum +
taitwater + heat conduction + CSF surface tension, a vapour sphere in
liquid; in ``boiling`` mode with fix phase_change), driven through
``Simulation.run`` on the backend ``backend`` names (``auto``: the strip;
``band``: the band backend for a run without phase change; ``pallas``: the
column kernel on the cell grid).

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

from tpusph_torch.ops.band_pair import BandBackend
from tpusph_torch.ops.pallas_pair import PallasBackend

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
                    mode: str = "dynamic", device=None,
                    backend: str = "auto"):
    """A periodic two-phase block: a vapour sphere inside liquid.

    Modes (``tpusph.bench.build_bench_sim``):
      uniform — both phases at rho0 = 1, zero velocities (kernel ceiling);
      dynamic — vapour rho0 = 0.1 via number-density rhosum plus a thermal
                velocity field (rebuilds inside every timed window);
      boiling — dynamic + sph/heatconduction/phasechange (T_sat 1.5 on the
                liquid-vapour pair) + fix phase_change on a hot liquid
                shell around the sphere (insertions force rebuilds).
    ``device`` None means the card (``Simulation``); ``backend`` is the
    simulation's ``backend_name``."""
    from tpusph_torch.api import Simulation
    from tpusph_torch.ops.phase_change import PhaseChangeConfig

    if mode not in ("uniform", "dynamic", "boiling"):
        raise ValueError(f"unknown bench mode {mode!r}")
    sim = Simulation(dim=dim, screen=False, device=device)
    sim.backend_name = backend
    per_side = int(round(n_particles ** (1.0 / dim)))
    dx = 1.0
    L = per_side * dx
    h = 3.0 * dx
    rho0 = 1.0
    m = rho0 * dx**dim
    contrast = mode in ("dynamic", "boiling")
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
    if mode in ("dynamic", "boiling"):
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
    sim.pair_heatconduction(phasechange=mode == "boiling")
    pairs = [(i, j) for i in ((1, 2) if multiphase else (1,))
             for j in range(i, (2 if multiphase else 1) + 1)]
    # cross pair first: set_taitwater writes rho0/c0 for BOTH types
    for i, j in sorted(pairs, key=lambda p: p[0] == p[1]):
        sim.tables.set_taitwater(i, j, rho0=rho_v if i == j == 2 else rho0,
                                 c0=10.0, viscosity=0.3, h=h)
        sim.tables.set_rhosum(i, j, h=h)
        tsat = 1.5 if (mode == "boiling" and i != j) else 0.0
        sim.tables.set_heatconduction(i, j, d=0.05, h=h, tsat=tsat)
    if multiphase:
        sim.pair_surfacetension()
        sim.tables.set_surfacetension(1, 2, sigma=0.05, h=h)
    if mode == "boiling":
        # hot interface shell: T above threshold there, latent-throttled
        hot = ~vap & (r < L / 4.0)
        sim._staged["e"][:] = np.where(hot, 2.5, 1.0).astype(np.float32)
        sim.configure_phase_change(PhaseChangeConfig(
            t_threshold=2.0, latent=20.0, dm=0.05 * m, liquid_type=1,
            vapor_type=2, every=10, prob=0.05, insert_offset=0.5 * dx,
            cutoff=h, vapor_rho=rho_v))
    sim.neighbor_skin = 1.0 * dx
    sim.dt = 2e-3 if mode == "uniform" else 5e-3
    sim.thermo(0)
    return sim


BUBBLE_SIDE, BUBBLE_DX = 12, 0.25


def build_bubble_sim(device=None, mode: str = "insert", prob: float = 1.0,
                     seed: int = 7, tsat: bool = True, sim=None,
                     config_cls=None, backend: str | None = None,
                     nz: int | None = None):
    """The 12^3 vapour bubble in a hot liquid shell of
    ``tests/test_phase_change.py``: a jittered lattice, conduction with T_sat
    pinning (plain conduction, which conserves sum(e), with ``tsat=False``)
    and fix phase_change in ``mode``. With ``prob = 1`` and
    require_interface no random draw decides an event.

    ``sim`` and ``config_cls`` take an empty ``Simulation`` and the
    ``PhaseChangeConfig`` class of another package with the same API, so
    a reference run can be built from the same numpy inputs; by default
    they are this package's, on ``device``. ``backend`` sets the
    simulation's ``backend_name``: on the simulation built here it is
    "strip" unless given (the 1,728 particles are under ``auto``'s dense
    rung), a ``sim`` passed in keeps its own; ``nz`` cuts the box to that many
    lattice planes in z (a periodic column axis too short to strip when
    below 4 x (cutoff + skin), 12 planes)."""
    from tpusph_torch.api import Simulation
    from tpusph_torch.ops.phase_change import PhaseChangeConfig

    if sim is None:
        sim = Simulation(dim=3, screen=False, device=device)
        backend = backend or "strip"
    config_cls = config_cls or PhaseChangeConfig
    if backend is not None:
        sim.backend_name = backend
    n_side, dx = BUBBLE_SIDE, BUBBLE_DX
    nz = nz or n_side
    L = n_side * dx
    h = 2.4 * dx
    sim.create_box([0, 0, 0], [L, L, nz * dx], periodic=(True,) * 3,
                   ntypes=2)
    rng = np.random.default_rng(11)
    ax = np.arange(n_side, dtype=np.float32) * dx
    az = np.arange(nz, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, az, indexing="ij"), -1).reshape(-1, 3)
    g = (g + rng.uniform(-0.02 * dx, 0.02 * dx, g.shape)).astype(np.float32)
    r = np.linalg.norm(g - np.float32([L, L, nz * dx]) / 2, axis=1)
    vap = r < L / 4
    hot = ~vap & (r < L / 3)
    sim.add_particles(
        g, np.where(vap, 2, 1).astype(np.int32),
        rho=np.where(vap, 0.1, 1.0).astype(np.float32),
        e=np.where(vap, 1.0, np.where(hot, 3.0, 1.5)).astype(np.float32),
        cv=1.0, rmass=np.where(vap, dx**3 / 10, dx**3).astype(np.float32))
    sim.pair_heatconduction(phasechange=tsat)
    for i in (1, 2):
        for j in range(i, 3):
            sim.tables.set_heatconduction(
                i, j, d=0.05, h=h, tsat=2.0 if (tsat and i != j) else 0.0)
    sim.capacity_pad = 1024
    sim.configure_phase_change(config_cls(
        t_threshold=2.0, latent=100.0, dm=5e-3, liquid_type=1, vapor_type=2,
        every=2, prob=prob, m_min=8e-3, insert_offset=0.5 * dx, mode=mode,
        cutoff=h, vapor_rho=0.1, seed=seed))
    sim.neighbor_skin = 0.6 * dx
    sim.dt = 1e-4
    sim.thermo(0)
    return sim


def run_devices(sim) -> list:
    """The distinct devices a run uses, in order: every brick's where the
    bricks are set, else the simulation's."""
    return list(dict.fromkeys(sim.mesh)) if sim.mesh else [sim.device]


def sync(sim):
    """Wait for every device the run uses."""
    for dev in run_devices(sim):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_bench(n_particles: int = 1_000_000, n_steps: int = 50, dim: int = 3,
              multiphase: bool = True, n_windows: int = 3,
              mode: str = "dynamic", device=None, sim=None,
              backend: str = "auto") -> dict:
    """Median of ``n_windows`` timed windows of ``n_steps`` each, after
    warmup windows that run until one passes with no geometry re-choice
    (the lattice-to-fluid transition re-chooses the margins; that belongs
    outside the timed region). Rebuild counts per window are reported so
    a window that rebuilt more often reads as slower, not as noise;
    ``value_all_windows`` is all the timed work over all the timed wall
    time, so a re-choice inside a window counts there. ``sim`` takes a
    simulation already built by ``build_bench_sim``; its mode and backend
    are then the caller's ``mode`` and ``backend``. ``particles`` and the
    rate count the particles before the run, as the reference does."""
    if sim is None:
        sim = build_bench_sim(n_particles, dim=dim, multiphase=multiphase,
                              mode=mode, device=device, backend=backend)
    n = sim.natoms

    def rechoices():
        # escalations (violation recovery) + de-escalations (margin decay)
        return sim._strip_violations + sim._strip_decays

    sim.run(n_steps)
    sync(sim)
    warmup_windows = 1
    prev = -1
    while warmup_windows < WARMUP_MAX and rechoices() != prev:
        prev = rechoices()
        sim.run(n_steps)
        sync(sim)
        warmup_windows += 1

    walls, nbuilds, rechosen = [], [], []
    for _ in range(n_windows):
        nb0, rc0 = sim.rebuilds, rechoices()
        t0 = time.perf_counter()
        sim.run(n_steps)
        sync(sim)
        walls.append(time.perf_counter() - t0)
        nbuilds.append(sim.rebuilds - nb0)
        rechosen.append(rechoices() - rc0)

    dt_wall = float(np.median(walls))
    psps = n * n_steps / dt_wall
    # all the work over all the time of the timed windows: unlike the
    # median, it carries a window that holds a geometry re-choice
    psps_all = n * n_steps * n_windows / float(np.sum(walls))
    styles = {"uniform": "rhosum+taitwater+heatcond+CSF, quiescent",
              "dynamic": "rhosum/multiphase+taitwater+heatcond+CSF, "
                         "density contrast 10x + thermal field",
              "boiling": "rhosum/multiphase+taitwater+heatcond/phasechange"
                         "+CSF+fix phase_change"}[mode]
    name, limit = card_info() if sim.device.type == "cuda" \
        else (sim.device.type, "not measured")
    backend_obj = sim._runner.backend
    return {
        "metric": f"particle-steps/sec/chip @ {n} particles "
                  f"({dim}D multiphase: {styles}, backend={backend})",
        # the backend the timed windows ran on
        "backend": type(backend_obj).__name__,
        "mode": mode,
        "value": round(psps, 1),
        "unit": "particle-steps/s",
        # an ESTIMATED reference single-node LAMMPS CPU throughput; the
        # reference publishes no SPH numbers (tpusph/bench.py)
        "vs_baseline": round(psps / BASELINE_NODE_PSPS, 6),
        "baseline_range": [2.0e7, 1.0e8],
        "vs_baseline_range": [round(psps / 1.0e8, 6),
                              round(psps / 2.0e7, 6)],
        "value_all_windows": round(psps_all, 1),
        "wall_s": round(dt_wall, 3),
        "windows_s": [round(w, 3) for w in walls],
        "rebuilds_per_window": nbuilds,
        # geometry re-choices inside each timed window (the host chooser
        # runs there: such a window reads far slower)
        "rechoices_per_window": rechosen,
        "geometry_rechoices": rechoices(),
        "geometry_decays": sim._strip_decays,
        "warmup_windows": warmup_windows,
        # one device's strip, or the one every brick shares
        "strip_w": getattr(sim._current_strip_geom(), "w", None),
        "cell_cap": (backend_obj.geom.cap
                     if isinstance(backend_obj, PallasBackend) else None),
        # the band geometry the timed windows ran on (the strip subclasses
        # BandBackend, so the type is compared exactly)
        "band_geometry": ({k: getattr(backend_obj.geom, k)
                           for k in ("G", "c", "k", "nsub", "ncx", "ncy")}
                          if type(backend_obj) is BandBackend else None),
        "steps": n_steps,
        "particles": int(n),
        "device": str(sim.device),
        # the bricks (1 without set_mesh) and the CUDA devices they used
        "bricks": len(sim.mesh) if sim.mesh else 1,
        "cards": sum(d.type == "cuda" for d in run_devices(sim)),
        "device_name": name,
        "power_limit": limit,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


if __name__ == "__main__":
    print(json.dumps(run_bench()))
