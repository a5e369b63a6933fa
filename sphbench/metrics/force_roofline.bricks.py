"""force_roofline.bricks: the force sweep's share of its roofline in the
traced window, on the bricks: the bound of one force stage of the whole box
(the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s,
``roofline.bound_s`` on the pair counts at the window's end) times the
stages the window ran (force launches over the bricks), over the force
kernels' device time summed over the cards."""

from __future__ import annotations


from sphbench.roofline import bound_s
from sphbench.trace import FORCE_KERNELS

NAME = "force_roofline.bricks"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "particle_steps_per_s.bricks"


def read(ctx):
    prof, p = ctx.get("profile"), ctx.get("pairs")
    if not prof or not p or "end" not in p:
        return None
    launches = sum(k["launches"] for n, k in prof["kernels"].items()
                   if n in FORCE_KERNELS)
    dev_s = sum(k["s"] for n, k in prof["kernels"].items()
                if n in FORCE_KERNELS)
    if not launches or dev_s <= 0.0:
        return None
    bound, _ = bound_s("force", p["end"])
    return 100.0 * bound * (launches / ctx["bricks"]) / dev_s
