"""chooser_s: Host seconds in the strip geometry chooser over set-up and the
window (``Simulation.chooser_s``); nothing where the chooser never ran."""

from __future__ import annotations

NAME = "chooser_s"
UNIT = "s"
SOURCE = "program_counter"
LAYER = "api.Simulation"
MOVES = "setup_s"


def read(ctx):
    return ctx["chooser_s"] if ctx["chooser_s"] > 0 else None
