"""Force-stage dispatch — the counterpart of ``tpusph/forces.py``
(``Pair::compute`` over the hybrid/overlay styles, SURVEY.md §3.2). Every
backend of the port has a fused stage that runs the rho, colour-gradient
and force sweeps and adds gravity.

The stages of the cell grid, the column kernel and the strip and band
backends are written as generators (``force_stage_steps``): asked to,
they yield the fresh rho and colour gradient and go on with the fields
they are sent back. ``drive_stage`` runs one with a per-field callable
(``force_stage(..., halo=...)``); the bricks (``tpusph_torch.dist``) run
one per brick in lockstep and send back the fields after the owner ->
ghost refresh across bricks (the reference's ``Pair::pack_forward_comm``
between its sweeps)."""

from __future__ import annotations

from tpusph_torch.params import DeviceTables, PhysicsSpec
from tpusph_torch.state import ParticleState


def compute_forces(state: ParticleState, tabs: DeviceTables,
                   spec: PhysicsSpec, backend, istep: int,
                   aux) -> ParticleState:
    """The full force stage of one step: fresh f, drho, de (and rho when
    rhosum fires this step)."""
    return backend.force_stage(state, tabs, spec, aux, istep)


def drive_stage(steps, halo=None):
    """Run a ``force_stage_steps`` generator to its end, sending back
    ``halo(field)`` for every field it yields (the field itself without a
    ``halo``); returns the generator's result."""
    try:
        field = next(steps)
        while True:
            field = steps.send(field if halo is None else halo(field))
    except StopIteration as stop:
        return stop.value
