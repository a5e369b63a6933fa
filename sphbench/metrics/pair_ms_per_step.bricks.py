"""pair_ms_per_step.bricks: The Timer table's Pair: the force stage (rho,
colour gradient, force sweeps and their packing) (``Runner.phase_times``,
CUDA events; over cards the slowest card's interval), summed over the timed
window's calls, per step."""

from __future__ import annotations

from sphbench.metrics._read import timer_ms_per_step

NAME = "pair_ms_per_step.bricks"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "force stage"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    return timer_ms_per_step(ctx, "Pair")
