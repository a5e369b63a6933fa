"""The step loop — the counterpart of ``tpusph/runner.py`` (Verlet::setup +
Verlet::run, src/verlet.cpp, SURVEY.md §3.2).

PyTorch runs eagerly, so one step is a plain sequence of tensor ops and
kernel launches: initial_integrate -> prepare (skin/2 trigger, rebuild,
seam refresh) -> force stage -> final_integrate -> the end-of-step fix
hook (fix phase_change), when one is set. The host syncs once per
step for the rebuild trigger, and once more after each rebuild to read the
overflow counter. CUDA graphs that remove both are later work.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from tpusph_torch import integrate
from tpusph_torch.forces import compute_forces
from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import Box, ParticleState


class Runner:
    """Owns the step for one (spec, box, backend)."""

    def __init__(self, spec: PhysicsSpec, box: Box, backend,
                 end_of_step: Optional[Callable] = None):
        self.spec = spec
        self.box = box
        self.backend = backend
        # Modify::end_of_step: hook(state, tabs, dt, istep, aux, backend,
        # box) -> (state, aux), after final_integrate on non-frozen steps
        self.end_of_step = end_of_step
        self.loop_time = 0.0
        self.ok_steps = 0

    def setup(self, state: ParticleState, tabs: DeviceTables, istep: int,
              aux) -> ParticleState:
        """Verlet::setup: forces must exist before the first
        initial_integrate."""
        return compute_forces(state, tabs, self.spec, self.backend, istep,
                              aux)

    def run(self, state: ParticleState, tabs: DeviceTables, dt: float,
            nsteps: int, aux, istep0: int = 0, every: int = 0,
            callback: Optional[Callable] = None):
        """Run ``nsteps`` steps from global step ``istep0``; ``callback``
        is called as callback(state, istep, aux) every ``every`` steps
        (thermo cadence) and at the end. Returns (state, aux).

        Freeze-on-overflow: a rebuild that counts an overflow (dropped rows
        or a rank window that no longer covers cutoff+skin) would drop
        pairs asymmetrically, so that step's force pass never runs. The
        block stops with the PRE-step state and the counter-carrying aux,
        and the next callback surfaces the overflow to the host."""
        if every <= 0:
            every = nsteps
        done = 0
        self.ok_steps = 0
        frozen = int(aux.overflow.sum()) > 0
        t0 = time.perf_counter()
        while done < nsteps:
            chunk = min(every, nsteps - done)
            for k in range(chunk):
                if frozen:
                    break
                istep = istep0 + done + k
                st = integrate.initial_integrate(state, dt)
                st, aux1, rebuilt = self.backend.prepare(st, aux, istep,
                                                         self.box)
                if rebuilt and int(aux1.overflow.sum()) > 0:
                    aux = aux1
                    frozen = True
                    break
                st = compute_forces(st, tabs, self.spec, self.backend,
                                    istep, aux1)
                state = integrate.final_integrate(st, dt)
                if self.end_of_step is not None:
                    state, aux1 = self.end_of_step(state, tabs, dt, istep,
                                                   aux1, self.backend,
                                                   self.box)
                aux = aux1
                self.ok_steps += 1
            done += chunk
            if callback is not None:
                callback(state, istep0 + done, aux)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        self.loop_time += time.perf_counter() - t0
        return state, aux


def thermo_scalars(state: ParticleState) -> dict:
    """Global reductions for a thermo line over alive OWNED particles
    (seam ghosts are copies), fetched in one host transfer."""
    alive = state.alive & state.owned
    m = torch.where(alive, state.rmass, 0.0)
    ke = 0.5 * (m * (state.v * state.v).sum(-1)).sum()
    ie = torch.where(alive, state.e, 0.0).sum()
    natoms = alive.sum()
    nat = torch.clamp(natoms, min=1).to(torch.float32)
    cv = torch.where(alive, state.cv, 1.0)
    t_avg = torch.where(alive, state.e / cv, 0.0).sum() / nat
    rho_avg = torch.where(alive, state.rho, 0.0).sum() / nat
    vmax = torch.where(alive[:, None], state.v.abs(), 0.0).max()
    vals = torch.stack([ke, ie, natoms.to(torch.float32), t_avg, rho_avg,
                        m.sum(), vmax]).cpu().tolist()
    out = dict(zip(("ke", "ie", "natoms", "t_avg", "rho_avg", "mass",
                    "vmax"), vals))
    out["natoms"] = int(out["natoms"])
    return out
