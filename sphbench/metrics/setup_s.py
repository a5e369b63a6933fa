"""setup_s: From the process's start to the timed window's start: imports, the
CUDA context, the libraries, the scene, the geometry choice and the warm-up
(the start check's comparison and the traced run's pair count left out)."""

from __future__ import annotations

NAME = "setup_s"
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx["setup_s"]
