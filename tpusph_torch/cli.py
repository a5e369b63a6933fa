"""Command-line entry point:
``python -m tpusph_torch.cli run in.script [-var k v]`` — the counterpart
of ``tpusph/cli.py``.

Reference parity: src/main.cpp + the lammps.cpp CLI switches -in, -var,
-log, -screen, -echo (SURVEY.md §5.6). Runs on the card (``--device
cuda``, the default; it raises where there is no CUDA device, with no
fallback) unless ``--device cpu`` asks for the CPU. ``--profile`` traces
the run with ``torch.profiler``. ``--mesh N`` runs the script in N bricks
(``Simulation.set_mesh``): round-robin over every visible card, one brick
per card on a node of N cards, every brick on the one card where one is
visible; ``CUDA_VISIBLE_DEVICES`` pins the cards.
"""

from __future__ import annotations

import argparse
import sys

# the Interpreter of the last ``run`` in this process, for a caller that
# inspects the simulation after ``main`` returns (chip_smoke.py)
last_run = None


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tpusph_torch",
        description="Multiphase SPH engine on one CUDA device (LAMMPS "
                    "USER-SPH capability surface)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run a LAMMPS-style input script")
    run_p.add_argument("script", help="input script path (or '-' for stdin)")
    run_p.add_argument("-var", nargs=2, action="append", default=[],
                       metavar=("NAME", "VALUE"),
                       help="define an index variable (like lmp -var)")
    run_p.add_argument("-log", "--log", default=None,
                       help="mirror thermo to this file")
    run_p.add_argument("-screen", "--screen", default=None,
                       help="'none' to silence stdout thermo")
    run_p.add_argument("-echo", "--echo", default=None,
                       choices=["none", "screen"], help="echo input lines")
    run_p.add_argument("--backend", default=None,
                       choices=["auto", "dense", "cellgrid", "pallas",
                                "band", "strip"],
                       help="force a compute backend")
    run_p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="the torch device (default: the card)")
    run_p.add_argument("--mesh", type=int, default=0,
                       help="decompose into N bricks, placed round-robin "
                            "over every visible card (CUDA_VISIBLE_DEVICES "
                            "pins them; on the CPU all on it)")
    run_p.add_argument("--profile", default=None, metavar="DIR",
                       help="trace the run with torch.profiler into DIR "
                            "(a Chrome trace)")

    bench_p = sub.add_parser("bench", help="run the throughput benchmark")
    bench_p.add_argument("--particles", type=int, default=1_000_000)
    bench_p.add_argument("--steps", type=int, default=200)
    bench_p.add_argument("--dim", type=int, default=3)
    bench_p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    args = parser.parse_args(argv)

    if args.cmd == "run":
        global last_run
        from tpusph_torch.api import Simulation
        from tpusph_torch.script import Interpreter

        if args.device == "cuda":
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: tpusph_torch runs on the card; pass "
                    "--device cpu to run on the CPU")
        sim = Simulation(log=args.log, screen=args.screen != "none",
                         device=args.device)
        if args.backend:
            sim.backend_name = args.backend
        if args.mesh:
            sim.set_mesh(args.mesh)
        interp = Interpreter(sim=sim,
                             variables={k: v for k, v in args.var})
        last_run = interp
        if args.script == "-":
            text = sys.stdin.read()
        else:
            try:
                text = open(args.script).read()
            except FileNotFoundError:
                print(f"tpusph_torch: input script not found: {args.script}",
                      file=sys.stderr)
                return 2
        if args.echo == "screen":
            for line in text.splitlines():
                print(f"> {line}")
        if args.profile:
            import os

            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if args.device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                interp.run_string(text)
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile,
                                                  "trace.json"))
        else:
            interp.run_string(text)
        return 0

    if args.cmd == "bench":
        import json

        from tpusph_torch.bench import run_bench
        result = run_bench(n_particles=args.particles, n_steps=args.steps,
                           dim=args.dim, device=args.device)
        print(json.dumps(result))
        return 0


if __name__ == "__main__":
    sys.exit(main())
