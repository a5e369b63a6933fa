"""step_mfu.bricks: The window's pair operations (rho, colour gradient and
force of every step, by the frozen per-pair counts on the benchmark's pair
counts) over the timed window's host-clock wall time times 67 TFLOP/s per
card the run uses."""

from __future__ import annotations

from sphbench.metrics._read import step_mfu

NAME = "step_mfu.bricks"
UNIT = "%"
SOURCE = "host_clock"
LAYER = "the whole step"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    return step_mfu(ctx)
