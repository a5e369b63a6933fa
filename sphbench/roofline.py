"""The yardstick's peaks and work counts.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3.
The port computes in float32 without tensor cores.

Per-pair float32 operations (add, multiply, compare, divide, sqrt: one
each) that the bench physics needs, counted from the equations (frozen
here; ``chip_smoke.PAIR_OPS`` holds the same hand counts): rsq with the
image shift 10 + sqrt; rho adds Lucy W and the sum (22); the colour
gradient the Lucy gradient, the colour coefficient and three sums, on
pairs of unlike types (30); the force Tait + Monaghan viscosity,
continuity and heat conduction (50), and the capillary terms on pairs
whose i or j has an unlike neighbour (25 more).

Bytes of a sweep: each field row read once and each output row written
once, one float32 per owned particle each (the layout's padding and
ghost copies are not the function's).
"""

from __future__ import annotations

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

PAIR_OPS = {"rho": 22, "cgrad": 30, "force": 50, "force_st": 25}
ROWS_IN = {"rho": 5, "cgrad": 7, "force": 15}
ROWS_OUT = {"rho": 1, "cgrad": 3, "force": 6}


def sweep_ops(counts: dict) -> dict:
    """Operations of each sweep on the pair counts of ``pairs.count``."""
    return {"rho": PAIR_OPS["rho"] * counts["pairs"],
            "cgrad": PAIR_OPS["cgrad"] * counts["unlike"],
            "force": PAIR_OPS["force"] * counts["pairs"]
            + PAIR_OPS["force_st"] * counts["interface"]}


def step_ops(counts: dict) -> float:
    """The pair operations of one step: its rho, colour-gradient and force
    sweeps."""
    return float(sum(sweep_ops(counts).values()))


def bound_s(sweep: str, counts: dict) -> tuple[float, str]:
    """(seconds, bound_by) of one launch of ``sweep``: the larger of its
    bytes over the bandwidth and its operations over the float32 peak."""
    nbytes = 4 * counts["rows"] * (ROWS_IN[sweep] + ROWS_OUT[sweep])
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sweep_ops(counts)[sweep] / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
