"""Measure the compacted force sweep (``ops/mxu_compact``) against the strip
force sweep on the same inputs, on the card — the counterpart of the
reference's ``tools/proto_mxu_compact.py``.

    python -m tpusph_torch.proto_mxu_compact [n] [mode] [headroom]
    python -m tpusph_torch.proto_mxu_compact 32768 dynamic --counts \
        --device cpu

Defaults: 1,000,000 particles, the ``uniform`` bench, headroom 1.3 (the
reference's). Builds the bench (``tpusph_torch.bench.build_bench_sim``),
runs 5 steps on the strip, and takes the layout the next step would sweep
(``StripBackend.prepare``). It packs the force sweep's field matrix as the
force stage does, rho sweep and patch, then colour-gradient sweep and
patch (the reference packs zero colour gradients, which leaves the
capillary terms unexercised), measures P over the alive rows
(``measure_union_cap``), runs the strip force kernel and the compacted
kernel on the same inputs, times both with CUDA events, and prints the
reference's fields — geometry, P, the lane ratio nnbr*W / P, both times,
the largest difference of each output row over its largest magnitude, the
overflow rows — then one JSON line with the card's name and power limit.
It is an entry point of its own: no path of ``Simulation`` runs the
compacted sweep. Needs a CUDA device. With ``--counts`` it times nothing
and prints, as one JSON line, the counts of the compacted kernel's phases
(``mxu_compact.compact_pass_counts``) and of the strip force kernel's
(``strip_pair.warp_pass_counts``) on the same layout, on ``--device``
(the CPU too: counts are no device measurement).
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch

from tpusph_torch.ops import strip_pair
from tpusph_torch.ops.mxu_compact import (
    OCNT, compact_force, compact_pass_counts, measure_union_cap,
)
from tpusph_torch.ops.rows import ODE, ODRHO, OFX, OFY, OFZ
from tpusph_torch.ops.strip_pair import StripBackend

ROWS = {"fx": OFX, "fy": OFY, "fz": OFZ, "drho": ODRHO, "de": ODE}


class CompactInputs(NamedTuple):
    """The inputs both force sweeps take, on one strip layout."""
    backend: StripBackend
    state: object       # ParticleState of the layout
    aux: object         # GridData of the layout
    fld: torch.Tensor   # the force sweep's field matrix
    tabs: object        # DeviceTables
    spec: object        # PhysicsSpec
    P: int
    cut: float
    headroom: float


def compact_inputs(sim, headroom: float = 1.3) -> CompactInputs:
    """The force sweep's inputs on the strip layout the simulation's next
    step would sweep, and P measured over its alive rows."""
    backend = sim._runner.backend if sim._runner is not None else None
    if type(backend) is not StripBackend:
        raise ValueError("the compacted sweep takes the strip layout: run "
                         f"the simulation on the strip first ({backend!r})")
    state, aux, _ = backend.prepare(sim.state, sim.aux, sim.step_count,
                                    sim.box)
    tabs = sim.tables.stacked(sim.device)
    fld, _ = backend.force_fields(state, tabs, sim.spec, aux,
                                  sim.step_count)
    cut = sim.tables.max_cut()
    x = state.x[state.alive].cpu().numpy()
    P = measure_union_cap(x, backend.geom, sim.box, cut, headroom=headroom)
    return CompactInputs(backend, state, aux, fld, tabs, sim.spec, P, cut,
                         headroom)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warmup call, by CUDA
    events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_strip(inp: CompactInputs) -> torch.Tensor:
    g = inp.backend
    return strip_pair.force_sweep(inp.fld, inp.tabs, g.win, inp.aux.delta,
                                  g.geom, inp.spec)


def run_compact(inp: CompactInputs) -> torch.Tensor:
    g = inp.backend
    return compact_force(inp.fld, inp.tabs, g.win, inp.aux.delta, g.geom,
                         inp.spec, inp.P, inp.cut)


def measure_inputs(inp: CompactInputs, reps: int = 5) -> dict:
    """Both sweeps on ``inp``: geometry, P, lane ratio, times, the largest
    row differences over the alive rows relative to the strip row's
    largest magnitude, and the overflow."""
    geom = inp.backend.geom
    ref = run_strip(inp)
    out = run_compact(inp)
    ms_strip = cuda_ms(lambda: run_strip(inp), reps)
    ms_compact = cuda_ms(lambda: run_compact(inp), reps)
    alive = inp.state.alive
    errs = {}
    for name, row in ROWS.items():
        a, b = ref[row][alive], out[row][alive]
        scale = float(a.abs().max()) + 1e-12
        errs[name] = float((b - a).abs().max()) / scale
    ocnt = out[OCNT][alive]
    return dict(
        W=geom.w, W_ceil128=-(-geom.w // 128) * 128, nnbr=geom.nnbr,
        ts=geom.ts, n_slots=geom.n_slots, alive=int(alive.sum()),
        P=inp.P, headroom=inp.headroom,
        lane_ratio=geom.nnbr * geom.w / inp.P, strip_force_ms=ms_strip,
        compact_force_ms=ms_compact, speedup=ms_strip / ms_compact,
        row_rel_err=errs, overflow_rows=int((ocnt > 0).sum()),
        overflow_max=float(ocnt.max()))


def measure(sim, headroom: float = 1.3, reps: int = 5) -> dict:
    """``measure_inputs`` on ``compact_inputs(sim, headroom)``: the
    prototype's path, on a simulation that has run on the strip."""
    return measure_inputs(compact_inputs(sim, headroom), reps)


def counts(inp: CompactInputs) -> dict:
    """The counts of the compacted kernel's phases and of the strip force
    kernel's on ``inp``, with the layout's geometry and P."""
    g, cutmax2 = inp.backend.geom, inp.tabs.cutmax2["force"]
    return dict(
        W=g.w, ts=g.ts, t_blk=g.t_blk, nnbr=g.nnbr, n_slots=g.n_slots,
        P=inp.P, compact=compact_pass_counts(
            inp.fld, inp.backend.win, inp.aux.delta, g, inp.P, inp.cut,
            cutmax2),
        strip_force=strip_pair.warp_pass_counts(
            inp.fld, inp.backend.win, inp.aux.delta, g, cutmax2))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("mode", nargs="?", default="uniform")
    ap.add_argument("headroom", nargs="?", type=float, default=1.3)
    ap.add_argument("--counts", action="store_true",
                    help="print the phases' counts, time nothing")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n, mode, headroom = args.n, args.mode, args.headroom
    if not args.counts and args.device != "cuda":
        raise SystemExit("proto_mxu_compact: the times need --device cuda")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("proto_mxu_compact: no CUDA device")
    from tpusph_torch.bench import build_bench_sim, card_info

    sim = build_bench_sim(n, mode=mode, device=args.device)
    sim.run(5)
    if args.counts:
        print(json.dumps(dict(counts(compact_inputs(sim, headroom)),
                              particles=n, mode=mode, device=args.device)))
        return
    rep = measure(sim, headroom)
    print(f"geom: W={rep['W']} (ceil128 {rep['W_ceil128']}) "
          f"nnbr={rep['nnbr']} ts={rep['ts']} n_slots={rep['n_slots']} "
          f"alive={rep['alive']}")
    print(f"P={rep['P']} (headroom {headroom}); candidate rows per i-row "
          f"{rep['nnbr'] * rep['W']} -> {rep['P']} "
          f"({rep['lane_ratio']:.1f}x cut)")
    print(f"force[strip]: {rep['strip_force_ms']:.3f} ms")
    print(f"force[compact]: {rep['compact_force_ms']:.3f} ms")
    for name, err in rep["row_rel_err"].items():
        print(f"max|d{name}|/max|{name}| = {err:.2e}")
    print(f"compaction overflow rows: {rep['overflow_rows']} (largest "
          f"count {rep['overflow_max']:.0f})")
    print(f"summary: strip {rep['strip_force_ms']:.3f} ms vs compact "
          f"{rep['compact_force_ms']:.3f} ms ({rep['speedup']:.2f}x)")
    name, limit = card_info()
    print(json.dumps(dict(rep, particles=n, mode=mode, device_name=name,
                          power_limit=limit)))


if __name__ == "__main__":
    main()
