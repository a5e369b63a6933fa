"""The whole run on the CPU with the timed path broken underneath: the
check has to come out false for every fault a cell can have, and true
for the sound program. A small box of the benchmark's cell: four bricks
with phase change."""

import dataclasses

import pytest
import torch

from _tiny import run_tiny

BRICKS = dict(cell_name="boiling_4m.bricks4_card1", per_side=24,
              steps_per_call=10)


def _patch_forces(monkeypatch, change):
    """``change(b, state)`` applied to each brick's state after its force
    stage."""
    from tpusph_torch.dist import DistBackend
    orig = DistBackend.force_stage_all

    def broken(self, states, *args, **kw):
        out = orig(self, states, *args, **kw)
        return [change(b, s) for b, s in enumerate(out)]

    monkeypatch.setattr(DistBackend, "force_stage_all", broken)


@pytest.mark.parametrize("control", [False, True])
def test_sound_program_correct_and_control_not(control):
    r = run_tiny(**BRICKS, control=control)
    assert r["correct"] != control, r["checks"]


def test_step_that_returns_its_state_unchanged(monkeypatch):
    from tpusph_torch.dist import DistRunner

    def frozen(self, state, tabs, dt, nsteps, aux, istep0=0, every=0,
               callback=None, phase_timer=False):
        self.ok_steps = nsteps
        if callback is not None:
            callback(state, istep0 + nsteps, aux)
        return state, aux

    monkeypatch.setattr(DistRunner, "run", frozen)
    r = run_tiny(**BRICKS)
    assert not r["correct"]
    assert r["checks"]["x_err"]["value"] > r["checks"]["x_err"]["limit"]


def test_half_of_the_particles_left_out(monkeypatch):
    """The forces of two of the four bricks dropped."""
    def half(b, state):
        if b < 2:
            return state
        return dataclasses.replace(state, f=torch.zeros_like(state.f),
                                   drho=torch.zeros_like(state.drho),
                                   de=torch.zeros_like(state.de))

    _patch_forces(monkeypatch, half)
    r = run_tiny(**BRICKS)
    assert not r["correct"]
    assert r["checks"]["f_err"]["value"] > r["checks"]["f_err"]["limit"]


def test_one_answer_altered_where_it_is_produced(monkeypatch):
    def nudge(b, state):
        if b != 0:
            return state
        # the largest force of an owned particle (not a ghost copy)
        mag = torch.linalg.vector_norm(state.f, dim=1)
        k = int(torch.where(state.alive & state.owned, mag, 0.0).argmax())
        f = state.f.clone()
        f[k] *= 1.1
        return dataclasses.replace(state, f=f)

    _patch_forces(monkeypatch, nudge)
    r = run_tiny(**BRICKS)
    assert not r["correct"]
    assert r["checks"]["f_err"]["value"] > r["checks"]["f_err"]["limit"]


def test_exchange_between_bricks_left_out(monkeypatch):
    from tpusph_torch.dist import DistBackend
    monkeypatch.setattr(DistBackend, "_halo_refresh",
                        lambda self, fields, auxes: fields)
    r = run_tiny(**BRICKS)
    assert not r["correct"]


def test_inserted_particle_moved(monkeypatch):
    import tpusph_torch.ops.phase_change as pc
    orig = pc._apply_phase_change

    def moved(state, istep, config, spec, backend, box, aux):
        before = state.alive.clone()
        state, changed = orig(state, istep, config, spec, backend, box, aux)
        new = state.alive & ~before
        x = torch.where(new[:, None], state.x + 0.05, state.x)
        return dataclasses.replace(state, x=x), changed

    monkeypatch.setattr(pc, "_apply_phase_change", moved)
    r = run_tiny(**BRICKS)
    assert not r["correct"]
    assert r["checks"]["pc_x_err"]["value"] > \
        r["checks"]["pc_x_err"]["limit"]
