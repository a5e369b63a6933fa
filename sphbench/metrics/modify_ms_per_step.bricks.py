"""modify_ms_per_step.bricks: The Timer table's Modify: both halves of the
integrator and the end-of-step hook, fix phase_change with its vapor query
(``Runner.phase_times``, CUDA events; over cards the slowest card's
interval), summed over the timed window's calls, per step."""

from __future__ import annotations

from sphbench.metrics._read import timer_ms_per_step

NAME = "modify_ms_per_step.bricks"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "fix phase_change"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    return timer_ms_per_step(ctx, "Modify")
