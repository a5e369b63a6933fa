"""Run one cell of the benchmark of ``tpusph_torch``.

    python3 -m sphbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints information lines, then as the last
line of standard output one JSON object (correct, attempted, failed,
metrics, device; with --trace 1 also breakdown; checks last: every number
the check compared with its limit). The numbers compared also end
standard error. Exits non-zero, printing no result, where no CUDA device
is visible, where fewer cards are visible than the cell asks for, or
where jax, jaxlib, flax or the JAX package tpusph is loaded at the end.
"""

from __future__ import annotations

import os
import time


def _since_process_start() -> float:
    """Seconds since this process started (/proc/self/stat), 0 where it
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            rest = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(rest[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS0 = time.perf_counter() - _since_process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the bfloat16 reference in the program's "
                         "place (the control; not a benchmark run)")
    args = ap.parse_args(argv)

    import torch

    from sphbench import harness

    _, cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("sphbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"sphbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS0,
                              control=args.control)
    print(json.dumps({"card": harness.card_info(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    bad = harness.forbidden_modules()
    if bad:
        print(f"sphbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
