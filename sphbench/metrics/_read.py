"""What the metrics' readers share. A reader's ``read(ctx)`` returns the
metric's value, or None where the run has nothing to read for it. ``ctx``
(``harness.run_cell``): cell, chips, cards, bricks, setup_s; window (the timed
window: wall_s, steps, calls, work, rate, rechoices, rebuilds, and with
--trace 1 timer, the Timer table's seconds by phase summed over its calls,
and timer_steps); chooser_s; profile (``trace.reduce`` of the traced
extra window, or None); pairs (``pairs.count`` at the window's start and
end, or None)."""

from __future__ import annotations


def timer_ms_per_step(ctx, phase: str):
    w = ctx["window"]
    if not w.get("timer") or not w.get("timer_steps"):
        return None
    if phase not in w["timer"]:
        return None
    return 1e3 * w["timer"][phase] / w["timer_steps"]


def step_mfu(ctx):
    """The window's pair operations (rho, colour gradient and force sweeps
    of every step, by the frozen per-pair counts and the benchmark's pair
    counts, the mean of the window's start and end) over the window's
    wall time times the cards' float32 peak, in %."""
    from sphbench import roofline
    p = ctx.get("pairs")
    if not p or "start" not in p or "end" not in p:
        return None
    w = ctx["window"]
    ops = 0.5 * (roofline.step_ops(p["start"]) + roofline.step_ops(p["end"]))
    return 100.0 * ops * w["steps"] / (
        w["wall_s"] * roofline.FP32_OPS_PER_S * ctx["cards"])


def idle_share(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["cards"]:
        return None
    busy = [c["busy_s"] for c in prof["cards"].values()]
    if max(busy) <= 0.0:
        return None
    return 100.0 * max(c["idle_share"] for c in prof["cards"].values())
