"""The step loop — the counterpart of ``tpusph/runner.py`` (Verlet::setup +
Verlet::run, src/verlet.cpp, SURVEY.md §3.2).

PyTorch runs eagerly, so one step is a plain sequence of tensor ops and
kernel launches: initial_integrate -> prepare (skin/2 trigger, rebuild,
seam refresh) -> force stage -> final_integrate -> the end-of-step fix
hook (fix phase_change), when one is set. The host syncs once per
step for the rebuild trigger, and once more after each rebuild to read the
overflow counter. CUDA graphs that remove both are later work.

The run-end Timer table's split (src/timer.cpp, ``phase_times``) comes,
where the caller asks for it, from marks around the phases of every step:
CUDA events on the card (read after the run's last synchronize; an event
pair spans the host work of its phase too, as the device waits for it;
over bricks on several cards, the slowest card's interval), the host
clock on the CPU. The marks change no result.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from tpusph_torch import integrate
from tpusph_torch.forces import compute_forces
from tpusph_torch.ops.pair_terms import eos_pressure_over_rhosq
from tpusph_torch.ops.rows import TABLES_1D
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
        # {"Modify", "Neigh", "Pair": seconds} summed over the executed
        # steps of the last run call that asked for them (else None)
        self.phase_times = None

    def setup(self, state: ParticleState, tabs: DeviceTables, istep: int,
              aux) -> ParticleState:
        """Verlet::setup: forces must exist before the first
        initial_integrate."""
        return compute_forces(state, tabs, self.spec, self.backend, istep,
                              aux)

    def run(self, state: ParticleState, tabs: DeviceTables, dt: float,
            nsteps: int, aux, istep0: int = 0, every: int = 0,
            callback: Optional[Callable] = None, phase_timer: bool = False):
        """Run ``nsteps`` steps from global step ``istep0``; ``callback``
        is called as callback(state, istep, aux) at the multiples of
        ``every`` (the output cadences' gcd: a run that resumes from a
        re-choice between two of them still writes at each) and at the
        end; with ``every`` 0 (no output cadence) only at the end.
        Returns (state, aux).

        Freeze-on-overflow: a rebuild that counts an overflow (dropped rows
        or a rank window that no longer covers cutoff+skin) would drop
        pairs asymmetrically, so that step's force pass never runs. The
        block stops with the PRE-step state and the counter-carrying aux,
        and the next callback surfaces the overflow to the host.

        ``phase_timer``: mark the phases of every step (``phase_times``)."""
        done = 0
        self.ok_steps = 0
        frozen = int(aux.overflow.sum()) > 0
        timer = _PhaseTimer([state.device]) if phase_timer else None
        t0 = time.perf_counter()
        while done < nsteps:
            chunk = nsteps - done if every <= 0 else \
                min(every - (istep0 + done) % every, nsteps - done)
            for k in range(chunk):
                if frozen:
                    break
                istep = istep0 + done + k
                _mark(timer)
                st = integrate.initial_integrate(state, dt)
                _mark(timer, "Modify")
                st, aux1, rebuilt = self.backend.prepare(st, aux, istep,
                                                         self.box)
                _mark(timer, "Neigh")
                if rebuilt and int(aux1.overflow.sum()) > 0:
                    aux = aux1
                    frozen = True
                    break
                st = compute_forces(st, tabs, self.spec, self.backend,
                                    istep, aux1)
                _mark(timer, "Pair")
                state = integrate.final_integrate(st, dt)
                if self.end_of_step is not None:
                    state, aux1 = self.end_of_step(state, tabs, dt, istep,
                                                   aux1, self.backend,
                                                   self.box)
                _mark(timer, "Modify")
                if timer is not None:
                    timer.commit()
                aux = aux1
                self.ok_steps += 1
            done += chunk
            if callback is not None:
                callback(state, istep0 + done, aux)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        self.loop_time += time.perf_counter() - t0
        self.phase_times = timer.split() if timer is not None \
            and timer.steps else None
        return state, aux


class _PhaseTimer:
    """Marks between the phases of each step. On the card: at each mark one
    CUDA event on the current stream of each device (every brick's card;
    one device gives one event a mark), read after the run's synchronize;
    a phase's time is the slowest device's interval between its two marks,
    so over several cards the phases' times can add up to more than the
    run's wall time. The host clock on the CPU. A step's marks count once
    it is committed (a frozen step is not)."""

    def __init__(self, devices):
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.cuda = self.devices[0].type == "cuda"
        self.steps = []
        self.marks = []

    def mark(self, name):
        if name is None:
            self.marks = []
        if self.cuda:
            evs = []
            for dev in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(dev))
                evs.append(ev)
            self.marks.append((name, evs))
        else:
            self.marks.append((name, time.perf_counter()))

    def commit(self):
        self.steps.append(self.marks)
        self.marks = []

    def split(self) -> dict:
        out = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                dt = max(ea.elapsed_time(eb) for ea, eb in zip(a, b)) / 1e3 \
                    if self.cuda else b - a
                out[name] = out.get(name, 0.0) + dt
        return out


def _mark(timer, name=None):
    if timer is not None:
        timer.mark(name)


def thermo_pressure(state: ParticleState, tabs: DeviceTables,
                    spec: PhysicsSpec) -> float:
    """Mean EOS pressure over alive owned particles: the ``press`` thermo
    column without the virial (``tpusph.runner.thermo_pressure``), with
    the EOS of the active pair style."""
    alive = state.alive & state.owned
    t = state.type.long()

    def tab(name):
        return tabs.tab1[TABLES_1D.index(name)][t]

    rho = torch.where(alive, state.rho, 1.0)
    m = torch.clamp(state.rmass, min=1e-30)
    _, p = eos_pressure_over_rhosq(rho, state.e, m, tab("rho0"),
                                   tab("tait_b"), tab("gas_gamma"), spec)
    n = torch.clamp(alive.sum(), min=1)
    return float(torch.where(alive, p, 0.0).sum() / n)


def thermo_virial_pressure(state: ParticleState, box: Box,
                           dim: int) -> float:
    """LAMMPS-compatible pressure from the pair virial (src/thermo.cpp):
    P = (sum m v^2 + 0.5 sum_i vir_i)/(dim V), vir_i = sum_j f_ij . r_ij
    from the force sweep (``spec.virial``). The 0.5 corrects the full,
    not Newton-halved, per-i sums that visit every pair twice."""
    alive = state.alive & state.owned
    m = torch.where(alive, state.rmass, 0.0)
    mv2 = (m * (state.v * state.v).sum(-1)).sum()
    w = torch.where(alive, state.vir, 0.0).sum()
    L = box.length
    vol = L[0] * L[1] * (L[2] if dim == 3 else 1.0)
    return float((mv2 + 0.5 * w) / (dim * vol))


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
