"""Force-stage dispatch — the counterpart of ``tpusph/forces.py``
(``Pair::compute`` over the hybrid/overlay styles, SURVEY.md §3.2). The
port has one backend, the strip backend, whose fused stage runs the rho,
colour-gradient and force sweeps and adds gravity."""

from __future__ import annotations

from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import ParticleState


def compute_forces(state: ParticleState, tabs: DeviceTables,
                   spec: PhysicsSpec, backend, istep: int,
                   aux) -> ParticleState:
    """The full force stage of one step: fresh f, drho, de (and rho when
    rhosum fires this step)."""
    return backend.force_stage(state, tabs, spec, aux, istep)
