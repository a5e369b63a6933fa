"""The inputs of a cell, made from its configuration file and ``--seed``,
and the simulation of the program that runs them.

The scene is the port's bench scene (a periodic box of liquid on a cubic
lattice with a vapour sphere of radius ``vapour_radius`` x L at its centre,
thermal velocities, and in boiling a hot liquid shell with fix
phase_change), rebuilt here from the configuration's numbers on the
program's public ``Simulation`` API. The seed draws the velocities and
seeds the phase change's draws; every seed has the same lattice, sizes and
physics.
"""

from __future__ import annotations

import numpy as np

LIQUID, VAPOUR = 1, 2


def make_inputs(cfg: dict, seed: int) -> dict:
    """Host float32 arrays of every particle, in tag order (tag = row + 1):
    x, type, v, rho, e, cv, rmass."""
    n_side, dx = int(cfg["per_side"]), float(cfg["dx"])
    length = n_side * dx
    ax = np.arange(n_side, dtype=np.float32) * np.float32(dx)
    x = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    r = np.linalg.norm(x - np.float32(length / 2.0), axis=1)
    vap = r < cfg["vapour_radius"] * length
    typ = np.where(vap, VAPOUR, LIQUID).astype(np.int32)
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, cfg["velocity_sigma"], x.shape).astype(np.float32)
    v -= v.mean(axis=0, keepdims=True)
    rho = np.where(vap, cfg["rho_vapor"], cfg["rho_liquid"]).astype(
        np.float32)
    e = np.full(len(x), cfg["e"], np.float32)
    if cfg.get("hot_radius"):
        hot = ~vap & (r < cfg["hot_radius"] * length)
        e[hot] = cfg["e_hot"]
    m = (rho * np.float32(dx) ** 3).astype(np.float32)
    return dict(x=x, type=typ, v=v, rho=rho, e=e,
                cv=np.full(len(x), cfg["cv"], np.float32), rmass=m)


def phase_change_config(cfg: dict, seed: int):
    """The configuration's fix phase_change, seeded from ``seed`` (None
    where the configuration has none)."""
    pc = cfg.get("phase_change")
    if not pc:
        return None
    from tpusph_torch.ops.phase_change import PhaseChangeConfig
    m = cfg["rho_liquid"] * cfg["dx"] ** 3
    return PhaseChangeConfig(
        t_threshold=pc["t_threshold"], latent=pc["latent"],
        dm=pc["dm_fraction"] * m, liquid_type=LIQUID, vapor_type=VAPOUR,
        every=pc["every"], prob=pc["prob"],
        insert_offset=pc["insert_offset"] * cfg["dx"], cutoff=cfg["h"],
        vapor_rho=cfg["rho_vapor"], seed=seed)


def build_sim(cfg: dict, inputs: dict, seed: int, device, backend: str):
    """The program's simulation of the inputs, as the port's bench builds
    it (``tpusph_torch.bench.build_bench_sim``), with ``backend`` as its
    ``backend_name``."""
    from tpusph_torch.api import Simulation

    sim = Simulation(dim=3, screen=False, device=device)
    sim.backend_name = backend
    length = cfg["per_side"] * cfg["dx"]
    h = cfg["h"]
    sim.create_box([0, 0, 0], [length] * 3, periodic=(True,) * 3, ntypes=2)
    sim.add_particles(inputs["x"], inputs["type"], v=inputs["v"],
                      rho=inputs["rho"], e=inputs["e"], cv=inputs["cv"],
                      rmass=inputs["rmass"])
    sim.pair_rhosum(every=1, number_density=cfg["rhosum_number_density"])
    sim.pair_taitwater(morris=False)
    sim.pair_heatconduction(phasechange=cfg["tsat"] > 0.0)
    # the cross pair first: set_taitwater writes rho0 and c0 of both types
    for i, j in ((LIQUID, VAPOUR), (LIQUID, LIQUID), (VAPOUR, VAPOUR)):
        rho0 = cfg["rho_vapor"] if i == j == VAPOUR else cfg["rho_liquid"]
        sim.tables.set_taitwater(i, j, rho0=rho0, c0=cfg["c0"],
                                 viscosity=cfg["viscosity"], h=h)
        sim.tables.set_rhosum(i, j, h=h)
        sim.tables.set_heatconduction(i, j, d=cfg["heat_D"], h=h,
                                      tsat=cfg["tsat"] if i != j else 0.0)
    sim.pair_surfacetension()
    sim.tables.set_surfacetension(LIQUID, VAPOUR, sigma=cfg["sigma"], h=h)
    pcc = phase_change_config(cfg, seed)
    if pcc is not None:
        sim.configure_phase_change(pcc)
    sim.neighbor_skin = cfg["skin"] * cfg["dx"]
    sim.dt = cfg["dt"]
    sim.thermo(0)
    return sim
