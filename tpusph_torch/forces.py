"""Force-stage dispatch — the counterpart of ``tpusph/forces.py``
(``Pair::compute`` over the hybrid/overlay styles, SURVEY.md §3.2). Both
of the port's backends, the strip backend and the column kernel's
(``ops/pallas_pair.PallasBackend``), have a fused stage that runs the rho,
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
