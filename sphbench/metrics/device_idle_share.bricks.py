"""device_idle_share.bricks: The largest card's idle share of the traced
window: 1 - busy / wall, busy the union of its device operations'
intervals."""

from __future__ import annotations

from sphbench.metrics._read import idle_share

NAME = "device_idle_share.bricks"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    return idle_share(ctx)
