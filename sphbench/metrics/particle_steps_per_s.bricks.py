"""particle_steps_per_s.bricks: on the brick path (``DistRunner``), the
timed window's particle-steps per second: the alive particles at each
call's start times its steps, summed over every call, over the wall time
from the window's start to the last call's end."""

from __future__ import annotations

NAME = "particle_steps_per_s.bricks"
UNIT = "particle-steps/s"
SOURCE = "host_clock"


def read(ctx):
    return ctx["window"]["rate"]
