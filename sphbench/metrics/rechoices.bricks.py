"""rechoices.bricks: geometry re-choices inside the timed window on the
brick path (the change in ``Simulation``'s violation and decay
counters)."""

from __future__ import annotations

NAME = "rechoices.bricks"
UNIT = "count"
SOURCE = "program_counter"
LAYER = "api.Simulation"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    return ctx["window"]["rechoices"]
