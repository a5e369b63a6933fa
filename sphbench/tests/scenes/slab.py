"""A scene for the tests, added as a configuration's files alone: the
bench physics (Tait, Monaghan viscosity, the colour gradient's capillary
force, conduction pinned at T_sat) in a 2:1:1 box periodic along x and y
and not along z (``boundary p p f``), with no phase change. A liquid slab
of 2n x n x n lattice sites (n = ``per_side``) fills x and y and leaves
``gap`` dx of room below and above it along z, so its lower corner is not
the origin; a vapour sphere sits at its centre inside a hot liquid shell.

The program builds it from an input script through its script layer
(``tpusph_torch.script.Interpreter``); ``make_inputs`` makes the same
particles here, independently, with the velocities drawn from the seed,
which the script's build then sets through ``Simulation.set_values``.
"""

from __future__ import annotations

import numpy as np

from sphbench.pairs import Box

LIQUID, VAPOUR = 1, 2
TYPES = {"liquid": LIQUID, "vapour": VAPOUR}


def _sites(cfg: dict):
    n, dx = int(cfg["per_side"]), float(cfg["dx"])
    return (2 * n, n, n), dx


def box(cfg: dict) -> Box:
    (nx, ny, nz), dx = _sites(cfg)
    gap = cfg["gap"] * dx
    return Box(lo=(0.0, 0.0, -gap),
               hi=(nx * dx, ny * dx, (nz - 1) * dx + gap),
               periodic=(True, True, False))


def _centre(cfg: dict) -> tuple:
    (nx, ny, nz), dx = _sites(cfg)
    return (nx * dx / 2.0, ny * dx / 2.0, (nz - 1) * dx / 2.0)


def _radii(cfg: dict) -> tuple:
    """The vapour sphere's and the hot shell's radius, fractions of n dx."""
    side = cfg["per_side"] * cfg["dx"]
    return cfg["vapour_radius"] * side, cfg["hot_radius"] * side


def make_inputs(cfg: dict, seed: int) -> dict:
    """Host float32 arrays of every particle, in tag order: x, type, v,
    rho, e, cv, rmass. The sites are i dx along each axis, x slowest."""
    (nx, ny, nz), dx = _sites(cfg)
    axes = [np.arange(k, dtype=np.float64) * dx for k in (nx, ny, nz)]
    x = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    d2 = ((x - np.asarray(_centre(cfg))) ** 2).sum(1)
    r_vap, r_hot = _radii(cfg)
    vap = d2 < r_vap ** 2
    hot = ~vap & (d2 < r_hot ** 2)
    typ = np.where(vap, VAPOUR, LIQUID).astype(np.int32)
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, cfg["velocity_sigma"], x.shape).astype(np.float32)
    v -= v.mean(axis=0, keepdims=True)
    rho = np.where(vap, cfg["rho_vapor"], cfg["rho_liquid"])
    e = np.where(hot, cfg["e_hot"], cfg["e"])
    return dict(x=x.astype(np.float32), type=typ, v=v,
                rho=rho.astype(np.float32), e=e.astype(np.float32),
                cv=np.full(len(x), cfg["cv"], np.float32),
                rmass=(rho * dx ** 3).astype(np.float32))


def script(cfg: dict) -> str:
    """The input script of the scene, velocities aside."""
    (nx, ny, nz), dx = _sites(cfg)
    b = box(cfg)
    cx, cy, cz = _centre(cfg)
    r_vap, r_hot = _radii(cfg)
    rl, rv, h = cfg["rho_liquid"], cfg["rho_vapor"], cfg["h"]
    tait = f"{cfg['c0']!r} {cfg['viscosity']!r} {h!r}"
    return f"""
dimension 3
units si
atom_style meso
boundary p p f
region box block {b.lo[0]!r} {b.hi[0]!r} {b.lo[1]!r} {b.hi[1]!r} &
    {b.lo[2]!r} {b.hi[2]!r} units box
create_box 2 box
lattice sc {dx!r}
region fill block 0 {(nx - 0.5) * dx!r} 0 {(ny - 0.5) * dx!r} &
    0 {(nz - 0.5) * dx!r} units box
create_atoms 1 region fill
region bubble sphere {cx!r} {cy!r} {cz!r} {r_vap!r} units box
set region bubble type 2
group liquid type 1
group vapor type 2
set group liquid meso/rho {rl!r} meso/e {cfg['e']!r} &
    meso/cv {cfg['cv']!r} mass {rl * dx ** 3!r}
set group vapor meso/rho {rv!r} meso/e {cfg['e']!r} &
    meso/cv {cfg['cv']!r} mass {rv * dx ** 3!r}
region hot sphere {cx!r} {cy!r} {cz!r} {r_hot!r} units box
set region hot meso/e {cfg['e_hot']!r}
set group vapor meso/e {cfg['e']!r}
pair_style hybrid/overlay sph/rhosum/multiphase 1 sph/taitwater &
    sph/heatconduction/phasechange sph/surfacetension
pair_coeff * * sph/rhosum/multiphase {h!r}
# the cross pair first: it writes rho0 and c0 of both types
pair_coeff 1 2 sph/taitwater {rl!r} {tait}
pair_coeff 1 1 sph/taitwater {rl!r} {tait}
pair_coeff 2 2 sph/taitwater {rv!r} {tait}
pair_coeff * * sph/heatconduction/phasechange {cfg['heat_D']!r} {h!r}
pair_coeff 1 2 sph/heatconduction/phasechange {cfg['heat_D']!r} {h!r} &
    {cfg['tsat']!r}
pair_coeff 1 2 sph/surfacetension {cfg['sigma']!r} {h!r}
fix integrate all meso
neighbor {cfg['skin'] * dx!r} bin
timestep {cfg['dt']!r}
thermo 0
"""


def build_sim(cfg: dict, inputs: dict, seed: int, device, backend: str):
    """The program's simulation of the scene, from ``script(cfg)`` through
    the script layer, with the inputs' velocities."""
    from tpusph_torch.api import Simulation
    from tpusph_torch.script import Interpreter

    sim = Simulation(dim=3, screen=False, device=device)
    Interpreter(sim=sim).run_string(script(cfg))
    sim.set_values(np.ones(sim.natoms, bool), v=inputs["v"])
    sim.backend_name = backend
    return sim
