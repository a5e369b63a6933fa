"""Python-first user API — the counterpart of ``tpusph/api.py``'s
``Simulation`` on one device, the object the input-script interpreter
(``tpusph_torch.script``) drives.

``Simulation`` owns the config, the particle state on one explicit torch
``device``, and the step loop. Particle setup is staged host-side in numpy;
``run`` builds the device state, chooses the backend (and its geometry from
the measured particle distribution), and steps.

Ported: the setup surface (dimension, kernel, create_box, add_particles,
create_atoms_lattice, groups, set, fix meso/stationary), every pair style
(rhosum, taitwater[/morris], idealgas, lj, heatconduction with the
/phasechange variant, surfacetension), the end-of-step hook registry and
configure_phase_change (fix phase_change), the backend ladder (dense at
2,048 particles or fewer; then strip, band for a run without phase change,
the column kernel), run (with the violation re-choice, the margin decay and
the strip retry after an abandoned geometry), the output scheduler (thermo
with every column, dumps, periodic restarts, each at its own cadence) and
the run-end Timer table, get, natoms; the cell grid's sweeps
(``backend_name = "cellgrid"``, and runs with more than 6 types), and
bricks (``set_mesh``, ``balance``: the spatial decomposition of
``tpusph_torch.dist``, with the recovery loop's re-choice over the bricks).

Entry points run on the card: ``Simulation()`` takes the CUDA device and
raises where there is none; the CPU is used only when asked for with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpusph_torch import grid as gridlib
from tpusph_torch import kernels, lattice
from tpusph_torch.io.thermo import ThermoWriter
from tpusph_torch.ops.band_pair import BandBackend, choose_band_geometry
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.ops.dense import DenseBackend
from tpusph_torch.ops.pallas_pair import PallasBackend
from tpusph_torch.ops.phase_change import (
    PhaseChangeConfig, make_end_of_step_hook,
)
from tpusph_torch.ops.rows import TABLES_1D, TABLES_2D
from tpusph_torch.ops.strip_pair import (
    StripBackend, choose_strip_geometry, pad_window_to_vreg,
)
from tpusph_torch.params import PairTables, PhysicsSpec
from tpusph_torch.runner import (
    Runner, thermo_pressure, thermo_scalars, thermo_virial_pressure,
)
from tpusph_torch.state import (
    Box, ParticleState, state_from_arrays, state_to_numpy,
)

# `auto` takes the dense backend at this many particles or fewer
DENSE_MAX = 2048


class CapacityOverflow(RuntimeError):
    """A rebuild counted dropped rows (a strip column or seam band, or a
    cell beyond its capacity) or a rank window that no longer covers
    cutoff+skin (the 'dangerous builds' analog, SURVEY §5.2)."""


class MarginDecay(RuntimeError):
    """Control flow: the strip margin floor shows measured, persistent
    slack, or an abandoned strip is due for a retry, and a geometry
    re-choice follows (``run`` continues as after a violation, with LOWER
    floors)."""


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _growth_bucket(natoms: int, prev: int) -> int:
    """Geometry cache-key bucket for the particle count: reuse the previous
    bucket while the count stays within [-20%, +25%] of it."""
    if prev and 0.8 * prev <= natoms <= 1.25 * prev:
        return prev
    return natoms


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tpusph_torch runs on the card; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


class Simulation:
    """One simulation: box + particles + physics + run loop."""

    def __init__(self, dim: int = 3, log: Optional[str] = None,
                 screen: bool = True, device=None):
        self.device = _default_device() if device is None \
            else torch.device(device)
        self.spec = PhysicsSpec(dim=dim)
        self.tables: Optional[PairTables] = None
        self.box: Optional[Box] = None
        self.state: Optional[ParticleState] = None
        self.aux = None
        self.dt: float = 0.005
        self.step_count: int = 0
        self.time_acc: float = 0.0
        self.capacity_pad: int = 0      # extra dead slots (phase-change pool)
        # "auto" (dense at DENSE_MAX particles or fewer; else strip, then
        # band for a run without phase change, then the column kernel),
        # "dense", "strip" (the ladder from the strip), "band" (band, then
        # the column kernel) or "pallas" (the column kernel on the cell
        # grid)
        self.backend_name: str = "auto"
        self.cell_cap: Optional[int] = None  # None = measured occupancy
        self.neighbor_skin: Optional[float] = None  # `neighbor <skin> bin`
        self.reneigh_every: int = 0     # `neigh_modify every N` (0 = check)
        self.log_path = log
        self.screen = screen
        self._staged: Dict[str, np.ndarray] = {}
        self._next_tag = 1
        self.groups: Dict[str, np.ndarray] = {}
        self.thermo_every: int = 0
        self.thermo_columns: List[str] = ["step", "time", "ke"]
        # `thermo_modify norm yes`: extensive columns (ke, pe, etotal) per
        # atom; the default prints totals
        self.thermo_norm: bool = False
        self.custom_columns: Dict[str, Callable] = {}
        self._thermo: Optional[ThermoWriter] = None
        self.dumps: list = []
        self.restart_schedule = None
        # the run-end Timer table splits the loop time by phase (marks
        # around every step's phases, Runner.phase_times)
        self.timer_detail = True
        self._runner: Optional[Runner] = None
        self._runner_key = None
        # Modify::end_of_step registry: named hooks (state, tabs, dt, istep,
        # aux, backend, box) -> (state, aux), composed in insertion order
        self._eos_hooks: Dict[str, Callable] = {}
        self.end_of_step_hook: Optional[Callable] = None
        self.phase_change_config = None
        self._backend_cache: Dict = {}
        # strip geometry state: the chooser's inputs and the violation
        # re-choice's escalation (run)
        self._strip_geom = None
        self._strip_geom_key = None
        self._strip_drift = 1.0
        self._strip_extra = (0, 0)
        self._strip_violations = 0
        # host seconds in the strip geometry chooser (one device's or the
        # bricks' shared one), summed over the run's choices
        self.chooser_s = 0.0
        self._margin_short = (0, 0)
        self._last_cb_step = 0
        self._rebuilds_before = 0   # strip builds under discarded layouts
        # margin decay (the inverse of the violation ratchet)
        self._strip_decays = 0
        self._decay_obs = 0
        self._decay_need = None
        self._decay_blocked = False
        self._decay_prev_w = None
        self._decay_nbuilds = None
        # the strip retry after an abandoned geometry
        self._strip_abandoned = False
        self._strip_retry_done = False
        self._retry_obs = 0
        self._retry_nbuilds = None
        # the band geometry and the chooser inputs it was measured under
        self._band_geom = None
        self._band_geom_key = None
        # the cell grid's measured capacity, its cache key and the
        # headroom boost each overflow re-choice applies
        self._mcap = None
        self._mcap_key = None
        self._cap_boost = 1.0
        # bricks (set_mesh): the devices the bricks are placed on, the
        # decomposition, and the per-brick pool capacity of the
        # partitioned state (positions are brick-local while it is set)
        self.mesh: Optional[List[torch.device]] = None
        self.brick_spec = None
        self.local_cap: Optional[int] = None
        self._dist_local_cap: Optional[int] = None
        self._balance_cuts = None
        self._mesh_axis_dim = 0
        self._mesh_shape = None
        self._mesh_axes = None
        # user overrides of the measured ghost / migrant capacities (the
        # remedy the brick overflow message names)
        self.dist_ghost_cap: Optional[int] = None
        self.dist_migrate_cap: Optional[int] = None

    # ------------------------------------------------------------ fix hooks

    def add_end_of_step_hook(self, name: str, hook: Callable):
        """Register a named Modify::end_of_step fix hook; hooks run in
        insertion order after final_integrate."""
        self._eos_hooks[name] = hook
        self._compose_eos_hooks()

    def remove_end_of_step_hook(self, name: str):
        if name in self._eos_hooks:
            del self._eos_hooks[name]
            self._compose_eos_hooks()

    def _compose_eos_hooks(self):
        hooks = tuple(self._eos_hooks.values())
        if not hooks:
            self.end_of_step_hook = None
        elif len(hooks) == 1:
            self.end_of_step_hook = hooks[0]
        else:
            def composed(state, tabs, dt, istep, aux, backend, box,
                         _hooks=hooks):
                for h in _hooks:
                    state, aux = h(state, tabs, dt, istep, aux, backend,
                                   box)
                return state, aux
            self.end_of_step_hook = composed
        self._runner = None

    def configure_phase_change(self, config: PhaseChangeConfig):
        """fix phase_change: evaporation mass exchange (SURVEY §2.3, §3.5).
        Installs the end-of-step hook over the particle pool."""
        if config.cutoff <= 0.0 and self.tables is not None:
            config = dataclasses.replace(config, cutoff=self.tables.max_cut())
        if self.capacity_pad == 0 and config.mode == "insert":
            # reserve pool headroom for insertions
            self.capacity_pad = max(len(self._staged.get("x", ())) // 4, 128)
        self.phase_change_config = config
        self.spec = dataclasses.replace(self.spec, phase_change=True)
        self.add_end_of_step_hook("phase_change",
                                  make_end_of_step_hook(config, self.spec))

    def set_mesh(self, ndev: Optional[int] = None, axis_dim: int = 0,
                 devices=None, shape=None, axes=None):
        """Decompose the run into ``ndev`` bricks (the ``processors``
        command; ``tpusph``'s ``set_mesh``). Call before the first run. The
        bricks go round-robin over ``devices``, by default every visible
        CUDA device where the simulation is on the card (one brick per card
        on a node of four; all on ``cuda:0`` only where one card is
        visible: ``CUDA_VISIBLE_DEVICES`` pins them), else its own device;
        ``ndev`` defaults to their number. Each brick's kernels launch on
        its own card. Default: 1D bricks along ``axis_dim``, or an
        auto-chosen multi-axis procgrid where those would be thinner than
        the halo margin; pass ``shape`` (e.g. (4, 2)) and ``axes`` (e.g.
        (0, 1)) to force one."""
        if devices is None:
            if self.device.type == "cuda":
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
            else:
                devices = [self.device]
        devices = [torch.device(d) for d in devices]
        if ndev is None:
            ndev = len(devices)
        self._pull_state()
        self.mesh = [devices[b % len(devices)] for b in range(ndev)]
        self._mesh_axis_dim = axis_dim
        self._balance_cuts = None
        self._mesh_shape = tuple(shape) if shape is not None else None
        self._mesh_axes = tuple(axes) if axes is not None else None
        self.brick_spec = None
        self._runner = None
        self._runner_key = None
        self.state = None
        self.aux = None
        self.local_cap = None

    def _make_brick_spec(self, cuts=None):
        from tpusph_torch import dist
        cutoff = self.tables.max_cut()
        return dist.make_brick_spec(
            self.box, len(self.mesh), cutoff, self._skin(cutoff),
            self.natoms, axis_dim=self._mesh_axis_dim,
            shape=self._mesh_shape, axes=self._mesh_axes,
            ghost_cap=self.dist_ghost_cap,
            migrate_cap=self.dist_migrate_cap, cuts=cuts)

    def balance(self):
        """Rebalance the bricks to the current particle distribution (the
        ``balance`` command, balance.cpp's shift balancer): per-axis brick
        boundaries at the particle-count quantiles, clamped to the halo
        margin; the bricks are repartitioned at the next run. Returns the
        cuts; no-op (None) without bricks."""
        if self.mesh is None:
            return None
        from tpusph_torch import dist
        self._pull_state()
        if self.brick_spec is None:
            # the axes and shape, so the quantiles know the procgrid
            self.brick_spec = self._make_brick_spec()
        spec = self.brick_spec
        self._balance_cuts = dist.compute_balance_cuts(
            np.asarray(self._staged["x"]), self.box, spec.axes, spec.shape,
            spec.margin)
        self._runner = None
        self._runner_key = None
        self.state = None
        self.aux = None
        self.local_cap = None
        return self._balance_cuts

    # ------------------------------------------------------------------ setup

    def set_dimension(self, dim: int):
        self.spec = dataclasses.replace(self.spec, dim=dim)

    def set_kernel(self, name: str):
        self.spec = dataclasses.replace(
            self.spec, kernel=kernels.kernel_id_from_name(name))

    def create_box(self, lo, hi, periodic=(True, True, True), ntypes: int = 1):
        self.box = Box.create(lo, hi, periodic, device=self.device)
        self.tables = PairTables.zeros(ntypes)

    def add_particles(self, x: np.ndarray, type, v=None, rho=1.0, e=0.0,
                      cv=1.0, rmass=1.0) -> np.ndarray:
        """Stage particles (create_atoms / read_data path). Returns the mask
        (over the staged arrays) of the newly added particles."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        if x.shape[1] == 2:
            x = np.concatenate([x, np.zeros((len(x), 1), np.float32)], axis=1)
        n = len(x)

        def full(val, shape=()):
            a = np.asarray(val, np.float32)
            return np.broadcast_to(a, (n,) + shape).copy() \
                if a.ndim <= len(shape) else a.astype(np.float32)

        new = dict(
            x=x, v=full(v if v is not None else 0.0, (3,)),
            type=np.broadcast_to(np.asarray(type, np.int32), (n,)).copy(),
            rho=full(rho), e=full(e), cv=full(cv), rmass=full(rmass),
            tag=np.arange(self._next_tag, self._next_tag + n, dtype=np.int32),
            mobile=np.ones(n, bool))
        self._next_tag += n
        if not self._staged:
            self._staged = new
        else:
            self._staged = {k: np.concatenate([self._staged[k], new[k]])
                            for k in new}
        mask = np.zeros(len(self._staged["x"]), bool)
        mask[len(self._staged["x"]) - n:] = True
        self._sync_groups(n)
        return mask

    def _sync_groups(self, n_new: int):
        for k in list(self.groups):
            self.groups[k] = np.concatenate(
                [self.groups[k], np.zeros(n_new, bool)])

    def create_atoms_lattice(self, type: int, style: str, spacing: float,
                             region: lattice.Region, **fields) -> np.ndarray:
        """create_atoms via a lattice fill of a region (SURVEY §2.4)."""
        box_region = lattice.Block(lo=self.box.lo.cpu().numpy(),
                                   hi=self.box.hi.cpu().numpy())
        pts = lattice.lattice_points(style, spacing, region,
                                     dim=self.spec.dim, box_region=box_region)
        return self.add_particles(pts, type, **fields)

    def define_group(self, name: str, mask: np.ndarray):
        self.groups[name] = np.asarray(mask, bool).copy()

    def group_mask(self, name: str) -> np.ndarray:
        if name == "all":
            return np.ones(len(self._staged["x"]), bool)
        return self.groups[name]

    def set_values(self, mask, **fields):
        """The `set` command: adjust per-particle values on the staged data
        (the device state, if any, is pulled first and rebuilt at the next
        run)."""
        self._pull_state()
        mask = np.asarray(mask, bool)
        for k, v in fields.items():
            self._staged[k][mask] = v
        self.state = None

    def set_stationary(self, mask):
        """fix meso/stationary on these particles (walls)."""
        self._pull_state()
        self._staged["mobile"][np.asarray(mask, bool)] = False
        self.state = None

    # pair styles --------------------------------------------------------

    def pair_taitwater(self, morris: bool = False):
        self.spec = dataclasses.replace(self.spec, tait=not morris,
                                        morris=morris)

    def pair_idealgas(self):
        self.spec = dataclasses.replace(self.spec, ideal_gas=True,
                                        tait=False)

    def pair_lj(self):
        self.spec = dataclasses.replace(self.spec, lj=True, tait=False)

    def pair_rhosum(self, every: int = 1, number_density: bool = False):
        """sph/rhosum N, or the multiphase number-density form
        (sph/rhosum/multiphase: rho_i = m_i sum_j W)."""
        self.spec = dataclasses.replace(self.spec, rhosum_every=every,
                                        rhosum_nd=bool(number_density))

    def pair_heatconduction(self, phasechange: bool = False):
        """sph/heatconduction, or the /phasechange variant: pairs whose
        tsat table entry is > 0 conduct against cv*T_sat."""
        if phasechange:
            self.spec = dataclasses.replace(self.spec, heat_phasechange=True)
        else:
            self.spec = dataclasses.replace(self.spec, heatconduction=True)

    def pair_surfacetension(self):
        self.spec = dataclasses.replace(self.spec, surface_tension=True)

    def thermo(self, every: int):
        self.thermo_every = every

    def thermo_style(self, columns: List[str]):
        self.thermo_columns = list(columns)
        self._thermo = None
        # `press` needs the pair virial of the force sweep (thermo.cpp
        # pressure): flip the spec flag so the sweeps write it
        want = "press" in self.thermo_columns
        if want != self.spec.virial:
            self.spec = dataclasses.replace(self.spec, virial=want)

    def add_thermo_column(self, name: str, fn: Callable):
        """fn(sim, scalars, istep) -> float, referenced by name in
        thermo_style (the v_ / c_ equation surface)."""
        self.custom_columns[name] = fn

    # ------------------------------------------------------------- state sync

    def _build_state(self):
        s = self._staged
        n = len(s["x"])
        extras = {k: s[k] for k in ("vest", "f", "de", "drho", "rho_c",
                                    "e_c") if k in s and len(s[k]) == n}
        self.state = state_from_arrays(
            s["x"], s["type"], rmass=s["rmass"], v=s["v"], rho=s["rho"],
            e=s["e"], cv=s["cv"], tag=s["tag"], mobile=s["mobile"],
            capacity=_round_up(n + self.capacity_pad, 128),
            device=self.device, **extras)
        self.local_cap = None   # one pool: positions are global

    def _host_x(self, dev: dict) -> np.ndarray:
        """Positions of a host copy of the state in GLOBAL coordinates:
        while the state is partitioned into bricks they are brick-local
        along the decomposed axes. Every host consumer of positions (get,
        dumps, restarts, _pull_state) goes through here."""
        x = dev["x"]
        if self.brick_spec is not None and self.local_cap is not None:
            from tpusph_torch.dist import globalize_positions
            x = globalize_positions(x, self.brick_spec, self.local_cap)
        return x

    def _pull_state(self):
        """Sync the device state back into the staged host arrays (staged
        order by tag), including the integrator fields a geometry re-choice
        needs to continue the leapfrog exactly."""
        if self.state is None or not self._staged:
            return
        dev = state_to_numpy(self.state)
        dev["x"] = self._host_x(dev)
        alive = (dev["type"] > 0) & dev["owned"]
        idx = np.nonzero(alive)[0]
        tags = dev["tag"][idx]
        order = np.argsort(tags, kind="stable")
        pos = np.searchsorted(tags[order], self._staged["tag"])
        ok = (pos < len(tags)) & (tags[order][np.clip(pos, 0, len(tags) - 1)]
                                  == self._staged["tag"])
        if len(idx) == len(self._staged["x"]) and ok.all():
            sel = idx[order[pos]]
        else:
            sel = idx
            self._staged["tag"] = tags
        for k in ("x", "v", "rho", "e", "cv", "rmass", "type", "mobile",
                  "vest", "f", "de", "drho", "rho_c", "e_c"):
            self._staged[k] = dev[k][sel]

    # ------------------------------------------------------------------- run

    def _select_backend(self):
        """The backend ladder of ``tpusph``'s ``_select_backend`` in its TPU
        form, the card taking the TPU's place. ``auto`` takes the dense
        backend at DENSE_MAX particles or fewer (counted when ``run``
        starts, as the reference does: a phase-change run that grows past
        it in one ``run`` stays dense), else the strip backend; where no
        strip geometry fits, a phase-change run takes the column kernel
        (``PallasBackend``: the band backend has no particle pool) and a
        run without phase change takes band; where no band geometry fits
        either, the column kernel. ``backend_name = "band"`` enters the
        ladder at band, ``"pallas"`` takes the column kernel for any run,
        ``"dense"`` the dense backend."""
        name = self.backend_name
        if name == "auto":
            name = "dense" if self.natoms <= DENSE_MAX else "strip"
        if name == "dense":
            return self._select_dense_backend()
        if name not in ("strip", "band", "pallas", "cellgrid"):
            raise ValueError(f"unknown backend {name!r}")
        if self.tables.ntypes > 6:
            # the strip, band and column kernels take at most 6 types
            name = "cellgrid"
        if name == "strip":
            backend = self._select_strip_backend()
            if backend is not None:
                return backend
            name = "pallas" if self.phase_change_config is not None \
                else "band"
        if name == "band":
            backend = self._select_band_backend()
            if backend is not None:
                return backend
            name = "pallas"
        return self._select_cell_backend(name)

    def _select_dense_backend(self) -> DenseBackend:
        key = ("dense", id(self.box))
        if self._backend_cache.get("key") != key:
            self._backend_cache = dict(key=key,
                                       backend=DenseBackend(self.box))
            self.aux = None
        return self._backend_cache["backend"]

    def _select_strip_backend(self) -> Optional[StripBackend]:
        """The strip backend for the current particle distribution, or None
        when the box cannot strip. When escalated margin floors push every
        candidate past the width cap, the strip is abandoned (a warning and
        a flag) until ``_maybe_retry_strip`` retries it."""
        cutoff = self.tables.max_cut()
        skin = self._skin(cutoff)
        # wider column headroom under phase change: the growing vapour
        # phase must not overflow the column budget between re-choices
        headroom = 1.35 if self.phase_change_config is not None else 1.08
        prev = self._strip_geom_key[3] if self._strip_geom_key else 0
        gkey = ("strip", cutoff, skin, _growth_bucket(self.natoms, prev),
                self.spec.dim, headroom, self._strip_drift,
                self._strip_extra)
        if self._strip_geom_key != gkey:
            if self.state is not None:
                self._pull_state()
            self._strip_geom_key = gkey
            t0 = time.perf_counter()
            self._strip_geom = choose_strip_geometry(
                self.box, cutoff, self.spec.dim, skin,
                x=np.asarray(self._staged["x"]), headroom=headroom,
                drift=self._strip_drift, extra_rows=self._strip_extra)
            self.chooser_s += time.perf_counter() - t0
        geom = self._strip_geom
        if geom is None:
            if self._strip_extra != (0, 0) or self._strip_drift > 1.0:
                # the loud-failure contract covers abandonment too: a
                # large, otherwise quiet step down to a slower backend
                self._strip_abandoned = True
                warnings.warn(
                    "strip geometry abandoned: escalated margin floor "
                    f"extra_rows={self._strip_extra} drift="
                    f"{self._strip_drift} pushed all candidates past the "
                    "window-width cap; falling back to a slower backend "
                    "(will retry after the transient)",
                    RuntimeWarning, stacklevel=2)
            return None
        key = ("strip", geom, self.reneigh_every)
        if self._backend_cache.get("key") != key:
            self._backend_cache = dict(key=key, backend=StripBackend(
                geom, ntypes=self.tables.ntypes,
                rebuild_every=self.reneigh_every, device=self.device))
            self.aux = None
        return self._backend_cache["backend"]

    def _select_band_backend(self) -> Optional[BandBackend]:
        """The band backend for the current particle distribution, or None
        where the run cannot band: a phase-change run (band has no particle
        pool) or no band geometry fits (``tpusph``'s
        ``_select_band_backend``). The geometry is measured once per
        (cutoff, skin, particle-count growth bucket, dim), so that it stays
        stable across ``run`` calls; an overflow re-choice clears the key
        and re-measures from the evolved state."""
        if self.phase_change_config is not None:
            return None
        cutoff = self.tables.max_cut()
        skin = self._skin(cutoff)
        prev = self._band_geom_key[2] if self._band_geom_key else 0
        gkey = (cutoff, skin, _growth_bucket(self.natoms, prev),
                self.spec.dim)
        if self._band_geom_key != gkey:
            if self.state is not None:
                self._pull_state()
            self._band_geom_key = gkey
            self._band_geom = choose_band_geometry(
                self.box, cutoff, self.spec.dim, skin,
                x=np.asarray(self._staged["x"]))
        geom = self._band_geom
        if geom is None:
            return None
        key = ("band", geom, self.reneigh_every)
        if self._backend_cache.get("key") != key:
            self._backend_cache = dict(key=key, backend=BandBackend(
                geom, ntypes=self.tables.ntypes,
                rebuild_every=self.reneigh_every))
            self.aux = None
        return self._backend_cache["backend"]

    def _select_cell_backend(self, name: str):
        """The column kernel's backend (``name`` "pallas") or the cell
        grid's plain sweeps ("cellgrid") on the cell grid. Its capacity is
        ``cell_cap`` or the measured occupancy, measured once per (cutoff,
        skin, particle-count growth bucket): a phase-change firing does not
        re-measure, and the overflow re-choice covers occupancy that
        outgrows the measure."""
        cutoff = self.tables.max_cut()
        skin = self._skin(cutoff)
        cap = self.cell_cap
        if cap is None:
            prev = self._mcap_key[-1] if self._mcap_key else 0
            mkey = (cutoff, skin, _growth_bucket(self.natoms, prev))
            if self._mcap_key != mkey:
                self._mcap_key = mkey
                self._mcap = self._measured_cell_cap(cutoff, skin)
            cap = self._mcap
        geom = gridlib.make_geometry(self.box, cutoff, self.spec.dim,
                                     skin=skin, cap=cap)
        key = (name, geom, self.reneigh_every)
        if self._backend_cache.get("key") != key:
            if name == "pallas":
                backend = PallasBackend(
                    geom, self.box, ntypes=self.tables.ntypes,
                    rebuild_every=self.reneigh_every, device=self.device)
            else:
                backend = CellGridBackend(
                    geom, rebuild_every=self.reneigh_every,
                    device=self.device, box=self.box)
            self._backend_cache = dict(key=key, backend=backend)
            self.aux = None
        return self._backend_cache["backend"]

    def _skin(self, cutoff: float) -> float:
        return self.neighbor_skin if self.neighbor_skin is not None \
            else 0.3 * cutoff

    def _measured_cell_cap(self, cutoff: float, skin: float,
                           frac: Optional[float] = None) -> int:
        """Cell capacity from the measured occupancy of the current
        configuration (``tpusph``'s ``_measured_cell_cap``): the fullest
        cell x 1.15 (x 1.6 under phase change, which inserts particles, or
        ``frac``) x the overflow boost, + 2, 8-aligned. The overflow guard
        raises if the dynamics outgrow it."""
        if self.state is not None:
            self._pull_state()
        x = np.asarray(self._staged["x"])
        lo = self.box.lo.cpu().numpy()
        length = self.box.hi.cpu().numpy() - lo
        side = cutoff + skin
        nc = np.maximum(np.floor(length / side).astype(int), 1)
        if self.spec.dim == 2:
            nc[2] = 1
        size = length / nc
        c = np.clip(((x - lo) // size).astype(int), 0, nc - 1)
        flat = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
        max_occ = int(np.bincount(flat).max()) if len(flat) else 8
        if frac is None:
            frac = 1.6 if self.phase_change_config else 1.15
        frac *= self._cap_boost
        return int(math.ceil((max_occ * frac + 2) / 8.0) * 8)

    def _derive_perf_flags(self):
        """Static perf flags from the concrete tables: tables uniform over
        the real types fold to scalars, and one shared active cutoff."""
        t = self.tables
        nt = t.ntypes
        scalar = []
        for name in TABLES_2D + TABLES_1D:
            arr = getattr(t, name)
            sub = arr[1:nt + 1, 1:nt + 1] if arr.ndim == 2 else arr[1:nt + 1]
            if sub.size and np.all(sub == sub.flat[0]):
                scalar.append(name)
        spec = self.spec
        active = []
        if spec.tait or spec.morris or spec.ideal_gas or spec.lj:
            active.append("cut")
        if spec.heatconduction or spec.heat_phasechange:
            active.append("cut_heat")
        if spec.surface_tension:
            active.append("cut_tension")
        shared = (len(active) > 0 and all(c in scalar for c in active)
                  and len({float(getattr(t, c)[1, 1]) for c in active}) == 1)
        self.spec = dataclasses.replace(spec, scalar_tables=tuple(sorted(
            scalar)), shared_wfd=bool(shared))

    def _ensure_runner(self):
        self._derive_perf_flags()
        if self.mesh is not None:
            return self._ensure_dist_runner()
        backend = self._select_backend()
        key = (self.spec, self.box.periodic, id(backend),
               self.end_of_step_hook)
        if self._runner is None or self._runner_key != key:
            self._runner = Runner(self.spec, self.box, backend,
                                  end_of_step=self.end_of_step_hook)
            self._runner_key = key
        return self._runner

    def _ensure_dist_runner(self):
        """The runner over the bricks (``tpusph``'s ``_ensure_dist_runner``):
        the decomposition, then the inner backend of every brick. Inner
        ladder: the strip where a geometry shared by every brick fits (on
        the card, or where ``backend_name`` is "strip" or "pallas"), else
        the column kernel on the card (or where named "pallas"), else the
        cell grid's sweeps; a brick on the card that cannot strip says so
        and takes the column kernel."""
        from tpusph_torch import dist
        key = (self.spec, self.box.periodic, tuple(self.mesh),
               self.end_of_step_hook)
        if self._runner is not None and self._runner_key == key:
            return self._runner
        if self.state is not None:
            # to the host under the brick spec the state was partitioned
            # with, before it is rebuilt below
            self._pull_state()
            self.state = None
        self.local_cap = None
        cutoff = self.tables.max_cut()
        skin = self._skin(cutoff)
        self.brick_spec = self._make_brick_spec(cuts=self._balance_cuts)
        on_card = self.device.type == "cuda"
        want_kernels = on_card or self.backend_name in ("strip", "pallas")
        strip_geom = None
        self._dist_local_cap = None
        if (self.backend_name in ("auto", "strip") and want_kernels
                and self.tables.ntypes <= 6):
            t0 = time.perf_counter()
            strip_geom, self._dist_local_cap = \
                dist.choose_strip_geometry_dist(
                    self.box, self.brick_spec, self.spec.dim, cutoff, skin,
                    np.asarray(self._staged["x"]),
                    headroom=(1.35 if self.phase_change_config is not None
                              else 1.15),
                    drift=self._strip_drift, extra_rows=self._strip_extra)
            self.chooser_s += time.perf_counter() - t0
            if strip_geom is None:
                if self._strip_extra != (0, 0) or self._strip_drift > 1.0:
                    # the abandonment-retry contract of one device
                    self._strip_abandoned = True
                    warnings.warn(
                        "brick strip geometry abandoned under escalated "
                        "margin floors; falling back (will retry after the "
                        "transient)", RuntimeWarning, stacklevel=2)
                else:
                    warnings.warn(
                        "a brick's local box cannot strip: the bricks take "
                        + ("the column kernel" if on_card
                           else "the cell grid"), RuntimeWarning,
                        stacklevel=2)
        use_pallas = self.tables.ntypes <= 6 and (
            self.backend_name == "pallas"
            or (on_card and self.backend_name in ("auto", "strip")))
        # the measured cell cap with headroom for ghost and migrant churn
        # at the brick edges
        cap = self.cell_cap
        if cap is None and strip_geom is None:
            cap = max(self._measured_cell_cap(cutoff, skin, frac=1.6), 16)
        backend = dist.DistBackend(
            self.brick_spec, self.box, self.spec.dim, cutoff, skin, cap=cap,
            rebuild_every=self.reneigh_every, use_pallas=use_pallas,
            ntypes=self.tables.ntypes, strip_geom=strip_geom,
            devices=self.mesh)
        self._runner = dist.DistRunner(self.spec, backend,
                                       end_of_step=self.end_of_step_hook)
        self._runner_key = key
        self.state = None       # repartition
        self.aux = None
        return self._runner

    def _current_strip_geom(self):
        """The strip geometry in use: one device's, or the one every brick
        shares (kept on the brick backend)."""
        if self._strip_geom is not None or self.mesh is None:
            return self._strip_geom
        return getattr(getattr(self._runner, "backend", None), "strip_geom",
                       None)

    def _thermo_values(self, state: ParticleState, istep: int):
        sc = thermo_scalars(state)
        natoms = sc["natoms"]
        dim = self.spec.dim
        # thermo_modify norm: extensive columns divided by natoms
        norm_div = max(natoms, 1) if self.thermo_norm else 1
        vals = {}
        for c in self.thermo_columns:
            if c == "step":
                vals[c] = istep
            elif c == "time":
                vals[c] = self.time_acc + (istep - self.step_count) * self.dt
            elif c == "dt":
                vals[c] = self.dt
            elif c == "atoms":
                vals[c] = natoms
            elif c == "ke":
                vals[c] = sc["ke"] / norm_div
            elif c == "pe":
                # internal energy plays PE's role
                vals[c] = sc["ie"] / norm_div
            elif c == "etotal":
                vals[c] = (sc["ke"] + sc["ie"]) / norm_div
            elif c == "temp":
                vals[c] = 2.0 * sc["ke"] / max(dim * natoms, 1)
            elif c == "density":
                vals[c] = sc["rho_avg"]
            elif c == "press":
                if self.spec.virial:
                    vals[c] = thermo_virial_pressure(state, self.box, dim)
                else:
                    vals[c] = thermo_pressure(
                        state, self.tables.stacked(self.device), self.spec)
            elif c in self.custom_columns:
                vals[c] = float(self.custom_columns[c](self, sc, istep))
            else:
                raise ValueError(f"unknown thermo column '{c}'")
        return vals

    def _ensure_thermo(self) -> ThermoWriter:
        if self._thermo is None:
            self._thermo = ThermoWriter(self.thermo_columns,
                                        screen=self.screen,
                                        log_path=self.log_path)
        return self._thermo

    def run(self, nsteps: int):
        """Run nsteps. If a rebuild counts an overflow (the margins chosen
        from the initial distribution no longer fit the evolved density
        field, or a cell outgrew its capacity), re-choose the geometry from
        the CURRENT state and continue: steps completed before the abort
        are kept, the re-chosen margins take the measured shortfall as an
        absolute floor (the reference's first-violation path), and the
        cell capacity's headroom grows x1.5 (at most x4). When the margin
        floor later shows persistent slack (``_maybe_decay_margins``), or
        an abandoned strip has seen three calm rebuilds on its fallback,
        band or the column kernel (``_maybe_retry_strip``), re-choose the
        same way."""
        attempts = 0
        remaining = nsteps
        pre = True
        while True:
            try:
                return self._run_once(remaining, pre=pre)
            except MarginDecay:
                # de-escalation re-choice: _maybe_decay_margins already
                # lowered the floors; keep executed progress
                self._strip_decays += 1
                done = self._continue_after_abort()
                attempts = 1 if done > 0 else attempts + 1
                if attempts > 2:
                    raise RuntimeError(
                        "strip margin decay made no progress twice — "
                        "decay logic bug, aborting instead of looping")
                remaining -= done
                pre = False
                if remaining <= 0:
                    return self
            except CapacityOverflow:
                if attempts >= 2:
                    raise
                self._strip_violations += 1
                short = self._margin_short
                if short[0] > 0 or short[1] > 0:
                    g = self._current_strip_geom()
                    base = ((g.mlo * g.ch, g.mhi * g.ch) if g is not None
                            else (0, 0))
                    prev = self._strip_extra
                    self._strip_extra = (
                        max(prev[0], base[0] + short[0] + 4),
                        max(prev[1], base[1] + short[1] + 4))
                elif self._strip_violations > 1:
                    # no measured window shortfall (a column or seam band
                    # overflowed): escalate the drift allowance
                    self._strip_drift = min(self._strip_drift * 2.0, 8.0)
                self._margin_short = (0, 0)
                # a fresh violation episode re-arms (and resets) the
                # margin-decay and strip-retry observers
                self._decay_obs = 0
                self._decay_need = None
                self._decay_blocked = False
                self._strip_retry_done = False
                self._retry_obs = 0
                done = self._continue_after_abort()
                # abort only on consecutive zero-progress re-chooses
                attempts = 1 if done > 0 else attempts + 1
                # more cell headroom, so the adaptation converges in a
                # re-choice or two instead of re-overflowing by epsilon
                self._cap_boost = min(self._cap_boost * 1.5, 4.0)
                remaining -= done
                # the continuation keeps the leapfrog half-step context:
                # no Verlet::setup force recompute (`run pre no`)
                pre = False
                if remaining <= 0:
                    return self

    def _continue_after_abort(self) -> int:
        """Credit the executed steps, pull the state to the host and drop
        every geometry-derived cache so the next run re-measures. Returns
        the executed-step count."""
        start = self.step_count
        done = max(self._last_cb_step - start, 0)
        done = min(done, self._runner.ok_steps)
        self.time_acc += done * self.dt
        self.step_count += done
        self._pull_state()
        self._rebuilds_before = self.rebuilds
        self._strip_geom_key = None
        self._band_geom_key = None
        self._mcap_key = None
        self._backend_cache = {}
        self._runner = None
        self._runner_key = None
        self.state = None
        self.aux = None
        self._decay_nbuilds = None  # rebuild counts restart
        self._retry_nbuilds = None
        return done

    _DECAY_K = 3          # consecutive rebuild observations with slack
    _DECAY_SAFETY = 4     # rows kept above the measured need

    def _maybe_decay_margins(self):
        """De-escalate the strip margin floor (the inverse of the violation
        ratchet, ``tpusph``'s api.py:899-975): after _DECAY_K consecutive
        rebuilds whose measured unclipped need (GridData.margin_need)
        shows at least one chunk of slack on both window sides, re-choose
        with the floors lowered to the measured need — but only if the
        128-row padded window would shrink (the pad is kept for geometry
        parity with the reference; a same-W re-choice blocks further
        attempts until the next violation episode). Off the strip, the
        retry observer watches instead."""
        g = self._current_strip_geom()
        aux = self.aux
        if g is None or not hasattr(aux, "margin_need"):
            self._maybe_retry_strip(aux)
            return
        if self._decay_prev_w is not None:
            # first observation under a decay re-choice: did it shrink?
            prev_w, self._decay_prev_w = self._decay_prev_w, None
            if g.w >= prev_w:
                self._decay_blocked = True
                return
        nb = int(aux.nbuilds.max())
        last, self._decay_nbuilds = self._decay_nbuilds, nb
        if last is not None and nb <= last:
            return  # no rebuild since the last observation
        # the worst brick's need (one device: its one row)
        nlo, nhi = (int(v) for v in
                    aux.margin_need.reshape(-1, 2).amax(dim=0).cpu())
        if nlo > -g.ch or nhi > -g.ch:
            # tight fit (or a violation pending): restart the streak
            self._decay_obs = 0
            self._decay_need = None
            return
        prev = self._decay_need or (nlo, nhi)
        self._decay_need = (max(prev[0], nlo), max(prev[1], nhi))
        self._decay_obs += 1
        if self._decay_obs < self._DECAY_K or self._decay_blocked:
            return
        rows_lo = max(g.mlo * g.ch + self._decay_need[0]
                      + self._DECAY_SAFETY, 0)
        rows_hi = max(g.mhi * g.ch + self._decay_need[1]
                      + self._DECAY_SAFETY, 0)
        mlo, mhi = pad_window_to_vreg(
            g.ts, g.ch, -(-rows_lo // g.ch), -(-rows_hi // g.ch),
            g.col_cap // g.ch)
        new_w = g.ts + g.ch * (mlo + mhi)
        if new_w >= g.w:
            # the pad eats the slack: stop watching until a violation
            self._decay_blocked = True
            return
        self._strip_extra = (rows_lo, rows_hi)
        self._strip_drift = 1.0
        self._decay_obs = 0
        self._decay_need = None
        self._decay_prev_w = g.w
        raise MarginDecay(
            f"strip margin slack measured over {self._DECAY_K} rebuilds: "
            f"window {g.w} -> {new_w} rows (floors {rows_lo}/{rows_hi})")

    def _maybe_retry_strip(self, aux):
        """The strip retry after an abandoned geometry (``tpusph``'s
        api.py:977-1011): after _DECAY_K calm rebuilds on the fallback
        backend, band for a run without phase change or the column kernel
        for one with it (calm: the overflow guard, which runs first, did
        not fire), re-choose the strip from fresh measures, the floors
        reset. One retry per violation episode: a second abandonment stays
        abandoned until a new violation re-arms the observer."""
        if not self._strip_abandoned or aux is None \
                or self._strip_retry_done:
            return
        nb = int(aux.nbuilds.max())
        last, self._retry_nbuilds = self._retry_nbuilds, nb
        if last is None or nb <= last:
            return  # no rebuild since the last observation
        self._retry_obs += 1
        if self._retry_obs < self._DECAY_K:
            return
        self._strip_extra = (0, 0)
        self._strip_drift = 1.0
        self._strip_abandoned = False
        self._strip_retry_done = True
        self._retry_obs = 0
        raise MarginDecay(
            f"strip was abandoned under escalated floors; {self._DECAY_K} "
            "calm rebuilds since: re-choosing with fresh measures")

    def _restore_integrator_fields(self):
        """Put the staged f/de/drho back into the re-sorted pool rows by tag
        (the rebuild zeroes them): the first initial_integrate after a
        re-choice must see the same de it would have seen uninterrupted."""
        s = self._staged
        if "de" not in s or self.state is None:
            return
        dev = state_to_numpy(self.state)
        alive = (dev["type"] > 0) & dev["owned"]
        idx = np.nonzero(alive)[0]
        tags = dev["tag"][idx]
        order = np.argsort(s["tag"], kind="stable")
        sorted_tags = s["tag"][order]
        pos = np.searchsorted(sorted_tags, tags)
        pos_c = np.clip(pos, 0, len(sorted_tags) - 1)
        ok = (pos < len(sorted_tags)) & (sorted_tags[pos_c] == tags)
        src = order[pos_c]
        upd = {}
        for k in ("f", "de", "drho"):
            arr = dev[k].copy()
            arr[idx[ok]] = np.asarray(s[k])[src[ok]]
            upd[k] = torch.as_tensor(arr, device=self.device)
        self.state = dataclasses.replace(self.state, **upd)

    def _run_once(self, nsteps: int, pre: bool = True):
        runner = self._ensure_runner()
        if self.state is None:
            if self.mesh is not None:
                from tpusph_torch import dist
                bricks, self.local_cap = dist.partition_state(
                    self._staged, self.brick_spec, self.mesh,
                    local_cap=self._dist_local_cap)
                self.state = runner.backend.concat(bricks)
            else:
                self._build_state()
            self.aux = None
        if self.aux is None:
            # initial sort and build (Verlet::setup's Neighbor::build; in
            # bricks also the exchange and borders)
            self.state, self.aux = runner.backend.init_aux(self.state,
                                                           self.box)
            if not pre and self.mesh is None:
                self._restore_integrator_fields()
        tabs = self.tables.stacked(self.device)
        tw = self._ensure_thermo() if self.thermo_every or nsteps else None
        # bricks always run Verlet::setup's force stage (it also fills the
        # ghosts' rho and colour gradient), as the reference does
        if pre or self.mesh is not None:
            self.state = runner.setup(self.state, tabs, self.step_count,
                                      self.aux)
        # the output scheduler (src/output.cpp): thermo, each dump and the
        # periodic restart at their own cadences; the run is chunked by
        # their gcd, so every output step is a chunk boundary (with no
        # cadence the run is one chunk)
        start = self.step_count
        last = start + nsteps
        cadences = [self.thermo_every] + [d.every for d in self.dumps]
        if self.restart_schedule is not None:
            cadences.append(self.restart_schedule.every)
        cadences = [c for c in cadences if c and c > 0]
        every = math.gcd(*cadences) if cadences else 0
        output_time = [0.0]

        def callback(state, istep, aux):
            t0 = time.perf_counter()
            self.state = state
            self.aux = aux
            self._last_cb_step = istep
            self._check_overflow()
            self._maybe_decay_margins()
            if tw is not None and (istep % max(self.thermo_every, 1) == 0
                                   or istep in (start, last)):
                tw.write_line(self._thermo_values(state, istep))
            for d in self.dumps:
                d.maybe_write(self, state, istep)
            rs = self.restart_schedule
            if rs is not None and istep > start and istep % rs.every == 0:
                from tpusph_torch.io.restart import write_restart
                # checkpoint at the current step (the counters advance
                # only at the end of the run)
                saved = (self.step_count, self.time_acc)
                self.step_count = istep
                self.time_acc = saved[1] + (istep - saved[0]) * self.dt
                write_restart(rs.path_template.replace("*", str(istep)),
                              self)
                self.step_count, self.time_acc = saved
            output_time[0] += time.perf_counter() - t0

        if tw is not None:
            tw.write_header()
        callback(self.state, start, self.aux)
        summary = tw is not None and bool(self.screen or self.log_path)
        t0 = runner.loop_time
        self.state, self.aux = runner.run(
            self.state, tabs, self.dt, nsteps, self.aux, istep0=start,
            every=every, callback=callback,
            phase_timer=summary and self.timer_detail)
        loop_time = runner.loop_time - t0
        if summary:
            tw.write_loop_summary(
                loop_time, len(self.mesh) if self.mesh else 1, nsteps,
                self.natoms,
                breakdown=self._timer_breakdown(runner, loop_time,
                                                output_time[0]))
        self.time_acc += nsteps * self.dt
        self.step_count += nsteps
        return self

    def _timer_breakdown(self, runner: Runner, loop_time: float,
                         output_time: float) -> Dict[str, float]:
        """The Pair/Neigh/Modify/Output split of the run-end Timer table
        (src/timer.cpp): Output measured on the host, the rest split in
        the shares of the phase times marked over the run's steps
        (``Runner.phase_times``: CUDA events on the card) where
        ``timer_detail`` asks for it, else all Pair."""
        out = min(output_time, loop_time)
        rest = max(loop_time - out, 0.0)
        breakdown = {"Output": out}
        phases = runner.phase_times if self.timer_detail else None
        total = sum(phases.values()) if phases else 0.0
        if total > 0.0:
            # Comm: the bricks' per-step forward comm
            names = ("Pair", "Neigh", "Modify") + (
                ("Comm",) if "Comm" in phases else ())
            for name in names:
                breakdown[name] = rest * phases.get(name, 0.0) / total
        else:
            breakdown["Pair"] = rest
        return breakdown

    def _restored(self, staged: Dict[str, np.ndarray]):
        """Install particle arrays read from a restart: the device state,
        the runner and every geometry are rebuilt at the next run."""
        self._staged = staged
        self._next_tag = int(staged["tag"].max()) + 1 \
            if len(staged["tag"]) else 1
        self.state = None
        self.aux = None
        self._runner = None
        self._runner_key = None
        self._backend_cache = {}
        self._strip_geom = None
        self._strip_geom_key = None
        self._band_geom_key = None
        self._mcap_key = None
        self.local_cap = None

    def _check_overflow(self):
        """Fixed-capacity overflow guard: dropped rows or an uncovered
        window mean silently dropped interactions — raise, with the strip's
        measured shortfall kept for the re-choice (a cell-capacity overflow
        carries none)."""
        ov = int(self.aux.overflow.sum())
        if ov > 0:
            ms = getattr(self.aux, "margin_short", None)
            if ms is not None:
                # the worst brick's shortfall (one device: its one row)
                ms = ms.reshape(-1, 2).amax(dim=0).cpu().numpy()
                self._margin_short = (int(ms[0]), int(ms[1]))
            remedy = (" Raise Simulation.cell_cap, or the bricks' "
                      "dist_ghost_cap / dist_migrate_cap, and rerun."
                      if self.mesh is not None else "")
            raise CapacityOverflow(
                f"capacity overflow ({ov} rows dropped from pair windows, "
                "halo or migration buffers, or coverage violations)."
                + remedy)

    # ------------------------------------------------------------- accessors

    def get(self, field: str) -> np.ndarray:
        """Per-particle array of the alive owned particles, in tag order
        (lammps_extract_atom)."""
        if self.state is None:
            self._build_state()
        dev = state_to_numpy(self.state)
        alive = (dev["type"] > 0) & dev["owned"]
        order = np.argsort(dev["tag"][alive], kind="stable")
        if field == "t":
            arr = dev["e"] / np.where(dev["cv"] > 0, dev["cv"], 1.0)
        elif field == "x":
            arr = self._host_x(dev)
        else:
            arr = dev[field]
        return np.asarray(arr)[alive][order]

    @property
    def rebuilds(self) -> int:
        """Rebuilds (strip, band or cell-grid builds) over the simulation's
        life, re-chosen geometries included (each layout's aux counts its
        own from 1; the bricks rebuild together and count once)."""
        own = int(self.aux.nbuilds.sum()) if self.aux is not None else 0
        return self._rebuilds_before + own

    @property
    def natoms(self) -> int:
        if self.state is None:
            return len(self._staged.get("x", ()))
        return self.state.nlocal()
