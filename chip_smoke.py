#!/usr/bin/env python3
"""Smoke test of the torch port (tpusph_torch) on NVIDIA GPUs.

    python3 chip_smoke.py            # every phase; needs one card

Phases 1-22 run on one card; phases 23 and 24 spread their bricks over
every visible card (one brick per card on a node of four);
`CUDA_VISIBLE_DEVICES=0` pins the whole script to one card.

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device  — a CUDA device must exist; prints nvidia-smi's name and
               power limit.
  2. build   — compiles csrc/strip_sweeps.cu, csrc/column_sweeps.cu,
               csrc/band_sweeps.cu and csrc/compact_force.cu with nvcc
               (sm_90a, one nvcc each, in parallel) and loads them.
  3. kernels — on the bench `dynamic` state after the initial strip build,
               runs each of the rho / colour-gradient / force sweeps through
               its CUDA kernel and its plain PyTorch version, checks the
               largest difference of each output row against a stated
               tolerance, and times both with CUDA events; prints the
               counts of the strip rho / force kernels' phases
               (strip_pair.warp_pass_counts: candidates, warp box
               survivors, live pairs, body passes lockstep, with lane
               lists and with the warp pair queue), and fails if a live
               pair lies outside its warp's box in that host copy of the
               kernels' filter (the kernels' own filter is held by phase 6's
               bitwise comparison). The colour-gradient kernel (its warp
               box filter and colour gate) is also held against its
               one-pass check kernel (strip_cgrad_scan_launch) on the same
               inputs: fails if any alive row differs bitwise, times both
               in turns (new, check, check, new; fails unless the new one
               is the faster), and prints its counts (warp_pass_counts
               with the colours: blocks that exit on the gate, rows staged
               with their terms, box survivors, needed pairs, body passes;
               fails on a needed pair outside its warp's or its block's
               box or gate).
  4. dynamic — resets the kernels' launch counts, runs the `dynamic` bench
               (tpusph_torch.bench.run_bench: Simulation.run with warmup and
               timed windows), reads the counts, and checks every sweep was
               launched, no overflow, all fields finite, owned mass
               conserved and the momentum drift bounded.
  5. kernels — phase 3 again on the layout the next step after the main
               path would sweep (the re-chosen window W).
  6. compact — on that layout, the compacted force sweep's path
               (tpusph_torch.proto_mxu_compact: the force stage's rho and
               colour-gradient sweeps and patches, P from the alive rows,
               the strip force kernel and the compacted kernel on the same
               inputs), with the launch counts reset just before it and read
               just after; the compacted kernel against the strip force
               kernel (rows 0-4 within 2e-4 of the row's largest magnitude on
               the alive rows, no overflow) and against its plain version
               (rows 0-4 within 2e-4 on the owned particles, the overflow
               row equal and rows 5-6 zero on every slot); fails if any
               alive row differs bitwise between the strip force kernel and
               the compacted sweep, and prints phase 3's counts. The
               compacted kernel (the tile compaction, then the warp box
               filter and pair queue over each chunk of kept survivors) is
               also held against its one-pass check kernel
               (compact_force_scan_launch, which must launch 0 times on the
               path): fails if any alive row's rows 0-4 differ bitwise or
               any slot's overflow row differs; both timed in turns (new,
               check, check, new; fails unless the new one is the faster),
               with the counts of its phases
               (mxu_compact.compact_pass_counts: compaction steps,
               survivors, kept rows, chunks, warp box survivors, live
               pairs, body passes lockstep and queued; fails on a live pair
               outside its warp's box).
  7. uniform — the 1M `uniform` bench (the reference prototype's default),
               5 steps on the strip, then phase 6 on its layout.
  8. uniform main path — resets the counts, runs the `uniform` bench on
               the same simulation, and checks phase 4's ledgers (the
               momentum drift against the larger of sum m|v| before and
               after: the run starts at rest).
  9. kernels — on the bench `boiling` state after the initial strip build
               (column headroom 1.35, the T_sat-pinned heat branch), the
               three sweeps as in phase 3 and the vapor sweep's kernel
               against its plain version and its one-pass check kernel
               (strip_vapor_scan_launch): count, both slots and both rsq
               equal on every slot; the kernel and the check kernel timed
               in turns as in phase 3, with the counts of the kernel's
               type gate and boxes (strip_pair.vapor_pass_counts; fails on
               a needed pair outside a box or the gate).
 10. boiling — resets the counts, runs the `boiling` bench (fix
               phase_change), and checks all four kernels were launched,
               particles were inserted and the vapour count grew by as
               many, the owned mass and momentum ledgers, the liquid's
               mass debit, no overflow and finite fields.
 11. kernels — phase 9 again on the layout after the boiling path
               (re-chosen W, inserted particles rebuilt into columns).
 12. slices  — the 16^3 `dynamic` bench slice for 20 steps, and a 12^3
               vapour bubble with fix phase_change (prob 1) for 20 steps,
               each on the GPU (kernels) and on the CPU (plain versions):
               the results must agree.
 13. column  — on the bench `boiling` state under backend="pallas" (the
               column kernel on the cell grid) after the initial sort, the
               three column sweeps' kernels against their plain versions,
               as in phase 3; each (csrc/cell_sweep.cuh: the reach from
               each cell's alive prefix, the box filter, force's pair
               queue, cgrad's colour gate) also against its one-pass check
               kernel (column_{rho,cgrad,force}_scan_launch) on the same
               inputs: fails if any alive row differs bitwise, times both
               with CUDA events in turns (filtered, check, check, filtered;
               fails unless the filtered one is the faster), and prints the
               counts of its phases (cell_filter.cell_pass_counts: the
               reach pass's type reads beside a per-slot ballot pass's,
               blocks that exit and, for cgrad, that exit on the gate,
               staging rounds, box survivors, live pairs, body passes
               lockstep and in the kernel; fails if a needed pair lies
               outside its warp's or its block's box or gate in that host
               copy of the filter).
 14. column boiling — resets the counts, runs the `boiling` bench with
               backend="pallas", and checks the three column kernels were
               launched and no other was (the strip's and the one-pass
               check kernels column_{rho,cgrad,force}_scan included: every
               main path asserts every check kernel, strip_cgrad_scan and
               strip_vapor_scan among them, at 0), plus phase 10's
               ledgers.
 15. column  — phase 13 again on the layout after the column path, and the
               cell-grid vapor query's time per firing.
 16. column slice — the 12^3 bubble on the column kernel, GPU against CPU.
 17. band    — on the bench `dynamic` state under backend="band" (the
               slot-resident sub-cell layout) after the initial build, the
               three band sweeps' kernels against their plain versions, and
               each against its one-pass check kernel
               (band_{rho,cgrad,force}_scan_launch) as in phase 13: the
               queued force, and the rho and colour-gradient kernels of
               csrc/cell_sweep.cuh (box filter; the colour gradient's
               colour gate), each failing if any alive row differs bitwise,
               timed in turns beside its check kernel (fails unless the new
               one is the faster), with the counts of its phases
               (cell_filter.cell_pass_counts for the sweep: blocks that exit
               and, for the colour gradient, that exit on the gate; rows
               staged and staged with terms; box survivors; live pairs;
               body passes).
 18. band dynamic — resets the counts, runs the `dynamic` bench with
               backend="band", and checks the three band kernels were
               launched and no other was (the strip's, the column's and the
               one-pass check kernels band_rho_scan, band_cgrad_scan and
               band_force_scan included: every main path asserts them at
               0), the timed windows ran on BandBackend, plus phase 4's
               ledgers.
 19. band    — phase 17 again on the layout after the band path.
 20. band slice — the 16^3 `dynamic` bench slice on band, GPU against CPU.
 21. ladder  — a phase-change run whose periodic column axis is too short
               to strip takes the column kernel on the ladder from the
               strip; escalated floors abandon the strip for the column
               kernel (phase change on) and for band (phase change off),
               and three calm rebuilds later the strip comes back, each
               with the CPU run's trajectory. (These systems are under
               2,048 particles, where "auto" takes the dense rung: they
               name "strip", as do the slices of phases 10, 16 and 20.)
 22. cases   — the five cases/ scripts through `python -m tpusph_torch.cli
               run` (cli.main) on the card: at tools/generate_golden.py's
               settings each reproduces its tests/golden/log.<case> rows
               (rtol 2e-3, a floor of 1e-5 of the column's largest
               magnitude, Atoms exact; dense for water_collapse, droplet
               and boiling, the ladder for the other two); heat_slab as
               committed (dx 0.02, 1000 steps) keeps its PotEng (sum of
               e) to 1e-5 and writes its dump's three snapshots of every
               atom; bubble_rise at
               dx 0.01 (config 4, > 450,000 atoms) for 2 x 20 steps, with
               the backend that ran, its kernels launched and no check
               kernel, fix phase_change's mass ledger, the stationary wall
               rows bitwise unmoved, overflow 0, finite thermo, and its
               particle-steps/s over the second 20 steps.
 23. bricks  — the `dynamic` bench at 48^3 for 30 steps on one device (the
               strip) and in 4 bricks (Simulation.set_mesh: tpusph_torch.
               dist, round-robin over every visible card; prints each
               brick's device) with each inner —
               strip, column kernel, cell grid, and the strip on a 2 x 2
               procgrid (the corner relay): each held to the one-device
               run at tests/test_dist.py's bars (minimum-image x and v to
               5e-4, rho rtol 1e-4, 2e-4 for the column inner, e rtol 1e-4
               / atol 1e-5, the same tags and natoms), its inner, the
               kernels it launched and no other (no check kernel), overflow
               0; where several cards are visible, the strip's 4 bricks
               again all on cuda:0, and the across-cards run held to that
               run at the same bars (largest differences printed; one card:
               the same run, not repeated); then `python -m
               tpusph_torch.cli run <heat_slab> --mesh 4` (cli.main on the
               card by default) at its golden settings: the golden rows
               within phase 22's bar.
 24. config 5 — BASELINE.json config 5, the bench's `boiling` at 4M
               particles, its upper size (the cube rounding decides the
               count: 159^3 = 4,019,679), on one device on the column
               kernel (the strip chooser's SMEM reject, kept for parity,
               refuses a 159^3 box; the one-device strip boiling path is
               phase 10's) and with set_mesh(4) over every visible card
               (the strip in every brick), each one warmup that passes with
               no re-choice and ONE timed window of 20 steps (run_bench's
               three windows cut to one for the time limit): phase 10's
               ledgers, overflow 0, every tag owned once, the owned rows
               summing to natoms; prints each path's particle-steps/s, strip
               W, rebuilds, re-choices, events, launches (and per card),
               run-end Timer table, the cards the bricks used, each card's
               peak memory and the host chooser's time, and the rate of
               the strip bricks over the one-device column kernel's
               (recorded, not gated).
Prints the five bench JSON lines, one JSON line each of the cases, the
bricks and the config 5 phases, one JSON line of the kernels (launches
on the boiling paths, config 5's brick path (and per card), the band path
and the compacted sweep's two paths;
times and bounds from phases 11, 15, 19 and 6, the largest error of all
comparisons; for the strip colour-gradient and vapor kernels, the three
column and the three band kernels and the compacted kernel also the
one-pass check kernel's time in turns, the rows that differ bitwise from
it and the counts of their phases; for the compacted kernel also its
and its check kernel's registers and spill stores from the ptxas log),
and as the last line {"ok": true, "device": {...}}. The check kernels
are on no path and have no line of their own.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# tolerance of a kernel output row against its plain version: largest
# absolute difference over the largest magnitude of the plain row (sums in
# another order, float32; the physics is held to 2e-4 elsewhere, rho to
# 2e-5). The vapor sweep forms rsq in the plain version's order with
# round-to-nearest intrinsics: it must agree exactly.
KERNEL_RTOL = {"rho": 2e-5, "cgrad": 2e-4, "force": 2e-4, "vapor": 0.0}
SOURCES = {"strip": "tpusph_torch/csrc/strip_sweeps.cu",
           "column": "tpusph_torch/csrc/column_sweeps.cu",
           "band": "tpusph_torch/csrc/band_sweeps.cu",
           "compact": "tpusph_torch/csrc/compact_force.cu"}
REPLACES = {"strip_rho": "tpusph/ops/strip_pair.py:1106",
            "strip_cgrad": "tpusph/ops/strip_pair.py:1106",
            "strip_force": "tpusph/ops/strip_pair.py:1106",
            "strip_vapor": "tpusph/ops/strip_pair.py:1251",
            "column_rho": "tpusph/ops/pallas_pair.py:233",
            "column_cgrad": "tpusph/ops/pallas_pair.py:233",
            "column_force": "tpusph/ops/pallas_pair.py:233",
            "band_rho": "tpusph/ops/band_pair.py:484",
            "band_cgrad": "tpusph/ops/band_pair.py:484",
            "band_force": "tpusph/ops/band_pair.py:484",
            "compact_force": "tpusph/ops/mxu_compact.py:123"}
KERNELS = ("rho", "cgrad", "force", "vapor")
STRIP = tuple(f"strip_{k}" for k in KERNELS)
COLUMN = ("column_rho", "column_cgrad", "column_force")
BAND = ("band_rho", "band_cgrad", "band_force")

# the least time the card could take: the larger of the bytes moved over
# 3.35 TB/s and the float32 operations over 67 TFLOP/s (no tensor cores)
# of one NVIDIA H100 SXM at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# field rows each sweep reads and output rows it writes (one float32 per
# owned alive particle each, read or written once)
ROWS_IN = {"rho": 5, "cgrad": 7, "force": 15, "vapor": 5}
ROWS_OUT = {"rho": 1, "cgrad": 3, "force": 6, "vapor": 5}
# float32 operations (add, multiply, compare, divide, sqrt: one each) per
# live (i, j) pair that the bench physics needs, counted from the kernels'
# arithmetic: rsq with the image shift 10 + sqrt; rho adds Lucy W and the
# sum; cgrad the Lucy gradient, the colour coefficient and three sums;
# force Tait + Monaghan viscosity, continuity and heat conduction (50), and
# the capillary terms on pairs of tiles flagged mixed (25 more); vapor rsq,
# two compares, the count and the two running minima
PAIR_OPS = {"rho": 22, "cgrad": 30, "force": 50, "force_st": 25,
            "vapor": 16}


def cuda_ms(fn, reps):
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_pairs(fld, win, delta, geom, cut2, own, keep=None):
    """(i, j) pairs with 1e-12 < rsq < cut2 in the sweeps' windows whose i
    is an owned alive row: the pairs the function needs on these inputs,
    not the nnbr*W candidates, nor the pairs of seam-ghost rows, whose
    sums are discarded. ``keep(pi, pj)`` filters them further."""
    from tpusph_torch.ops import strip_pair
    cstep = strip_pair._column_step(geom)
    total = 0
    for c0 in range(0, geom.ncols, cstep):
        pi, pj, *_ = strip_pair._window_pairs(
            fld, win, delta, geom, c0, min(c0 + cstep, geom.ncols), cut2)
        need = own[pi] if keep is None else own[pi] & keep(pi, pj)
        total += int(need.sum())
    return total


def pass_counts(label, fld, win, delta, geom, cut2):
    """``strip_pair.warp_pass_counts`` on a strip layout, printed with the
    ratios that decide the strip rho / force kernels' design; the host copy
    of the kernels' warp box filter must keep every live pair. Returns the
    counts."""
    from tpusph_torch.ops import strip_pair
    c = strip_pair.warp_pass_counts(fld, win, delta, geom, cut2)
    rows, warps = max(c["rows"], 1), max(c["warps"], 1)
    print(f"  {label} counts: {json.dumps(c)}")
    print(f"  {label}: per row {c['candidates'] / rows:.1f} candidates, "
          f"{c['live_pairs'] / rows:.1f} live pairs; per warp "
          f"{c['box_survivors'] / warps:.1f} box survivors, body passes "
          f"{c['old_passes'] / warps:.1f} lockstep, "
          f"{c['list_passes'] / warps:.1f} lane lists, "
          f"{c['queue_passes'] / warps:.1f} queue "
          f"({c['old_passes'] / max(c['queue_passes'], 1):.2f}x fewer); "
          "lanes working in a body pass "
          f"{c['live_pairs'] / (32 * max(c['old_passes'], 1)):.1%}, "
          f"{c['live_pairs'] / (32 * max(c['list_passes'], 1)):.1%}, "
          f"{c['live_pairs'] / (32 * max(c['queue_passes'], 1)):.1%}")
    assert c["live_outside_box"] == 0, c
    return c


def gated_counts(label, c):
    """The counts of a gated strip kernel (``strip_pair.warp_pass_counts``
    with the colours, ``strip_pair.vapor_pass_counts``), printed with the
    ratios that decide its design; the host copy of its boxes and gate must
    keep every pair it needs. Returns the counts."""
    rows, warps = max(c["rows"], 1), max(c["warps"], 1)
    print(f"  {label} counts: {json.dumps(c)}")
    print(f"  {label}: {c['rows']} rows summed; per row "
          f"{c['candidates'] / rows:.1f} one-pass candidates, "
          f"{c['live_pairs'] / rows:.1f} live pairs, "
          f"{c['needed_pairs'] / rows:.2f} needed; blocks {c['blocks']}, "
          f"{c['gate_exits']} of them with no candidate; "
          f"{c['staged_rows']} rows read at staging of which "
          f"{c['staged_with_terms']} staged as candidates; per warp "
          f"{c['box_survivors'] / warps:.1f} box survivors, body passes "
          f"{c['old_passes'] / warps:.1f} lockstep, "
          f"{c['body_passes'] / warps:.1f} in the kernel")
    assert c["live_outside_box"] == 0, c
    return c


def bound(name, n_rows, ops):
    """(bound_ms, bound_by) of one launch over ``n_rows`` owned alive
    particles (each input row read once, each output row written once; the
    slot layout's dead padding and seam-ghost copies are not the
    function's) doing ``ops`` float32 operations."""
    nbytes = 4 * n_rows * (ROWS_IN[name] + ROWS_OUT[name])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def layout_state(sim, after_run):
    """(backend, state, aux, tables) of the layout the sweeps see: after
    the initial sort and build (``after_run`` False), or, after a main
    path, the state its next step's force stage would get (the rebuild
    trigger, a rebuild where it fires — over the slots inserted by a
    last-step phase-change firing too — and, on the strip, the seam
    refresh)."""
    if after_run:
        backend = sim._runner.backend
        state, aux, _ = backend.prepare(sim.state, sim.aux, sim.step_count,
                                        sim.box)
    else:
        backend = sim._ensure_runner().backend
        sim._build_state()
        state, aux = backend.init_aux(sim.state, sim.box)
    return backend, state, aux, sim.tables.stacked(sim.device)


def timed(name, run_kernel, run_plain, n_rows, ops, reps, kind=None):
    """Kernel and plain times by CUDA events, the bound (of the sweep
    ``kind``, by default ``name``) and the roofline share (bound over
    kernel time), printed."""
    ms = cuda_ms(run_kernel, reps)
    plain_ms = cuda_ms(run_plain, 1)
    bound_ms, bound_by = bound(kind or name, n_rows, ops)
    share = bound_ms / ms
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), roofline share {share:.2%}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, roofline_share=share)


def compare_rows(label, sweep, out_k, out_p, alive, rows):
    """Each output row of a kernel against its plain version on the alive
    slots, within the sweep's tolerance of the row's largest magnitude;
    returns the largest absolute differences, printed."""
    import torch
    torch.cuda.synchronize()
    errs = []
    for r in rows:
        a, b = out_k[r][alive], out_p[r][alive]
        assert torch.isfinite(a).all(), f"{label} row {r}: non-finite"
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        errs.append(err)
        print(f"  {label} row {r}: max_abs_err {err:.3e} max|plain| "
              f"{scale:.3e} rel {err / max(scale, 1e-30):.3e} (tolerance "
              f"{KERNEL_RTOL[sweep]:.0e})")
        assert err <= KERNEL_RTOL[sweep] * scale, (label, r, err, scale)
    return errs


def hold_to_plain(sim, names, after_run=False, reps=10):
    """Each kernel of ``names`` against its plain version on the strip
    state of ``layout_state``, fed as the main path feeds them (the three
    sweeps as the force stage does: rho patched before cgrad, cg before
    force; the vapor sweep as the phase-change query does, with vtype and
    the cutoff of the simulation's config). Returns {name: report}."""
    import torch
    from tpusph_torch.ops import strip_pair
    from tpusph_torch.ops.band_pair import pack_fields
    from tpusph_torch.ops.rows import (
        OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RCGZ, RMIX, RRHO,
        RTYPE, TABLES_1D)

    backend, state, aux, tabs = layout_state(sim, after_run)
    geom, spec = backend.geom, sim.spec
    alive = state.alive
    own = alive & state.owned
    n_own = int(own.sum())
    print(f"  geometry W {geom.w}, {geom.n_slots} slots, {int(alive.sum())} "
          f"alive rows of which {n_own} owned particles")
    report = {}
    sweeps = [s for s in names if s != "vapor"]
    fld = pack_fields(state, aux.mix)
    if sweeps:
        cut2 = tabs.cutmax2["force"]
        npairs = live_pairs(fld, backend.win, aux.delta, geom, cut2, own)
        mixed = {th: live_pairs(fld, backend.win, aux.delta, geom, cut2, own,
                                keep=lambda pi, pj, th=th: fld[RMIX][pi] > th)
                 for th in (0.25, 0.75)}
        # the colour gradient is summed over the pairs of unlike types of
        # the rows of tiles flagged mixed
        typ = fld[RTYPE]
        unlike = live_pairs(fld, backend.win, aux.delta, geom, cut2, own,
                            keep=lambda pi, pj: (fld[RMIX][pi] > 0.75)
                            & (typ[pi] != typ[pj]))
        ops = {"rho": PAIR_OPS["rho"] * npairs,
               "cgrad": PAIR_OPS["cgrad"] * unlike,
               "force": PAIR_OPS["force"] * npairs
               + PAIR_OPS["force_st"] * mixed[0.25]}
        print(f"  live pairs {npairs} ({npairs / n_own:.1f} per particle), "
              f"in tiles flagged > 0.25: {mixed[0.25]}, > 0.75: "
              f"{mixed[0.75]}, of those of unlike types {unlike}")
        counts = pass_counts(f"W {geom.w} t_blk {geom.t_blk}", fld,
                             backend.win, aux.delta, geom, cut2)
    rows = {"rho": (ORHO,), "cgrad": (OCGX, OCGY, ODE),
            "force": (OFX, OFY, OFZ, ODRHO, ODE)}
    for sweep in sweeps:
        kern = strip_pair.SWEEPS[sweep]

        def run_kernel():
            return kern(fld, tabs, backend.win, aux.delta, geom, spec)

        def run_plain():
            return strip_pair.plain_sweep(sweep, fld, tabs, backend.win,
                                          aux.delta, geom, spec)

        out_k = run_kernel()
        out_p = run_plain()
        errs = compare_rows(sweep, sweep, out_k, out_p, alive, rows[sweep])
        report[sweep] = dict(max_abs_err=max(errs), **timed(
            sweep, run_kernel, run_plain, n_own, ops[sweep], reps))
        if sweep != "cgrad":
            report[sweep]["warp_passes"] = counts
        else:
            report[sweep].update(cgrad_to_scan(
                fld, tabs, backend, aux, spec, alive, out_k, run_kernel,
                reps))
        if sweep == "rho":
            total = out_p[ORHO] * state.rmass if spec.rhosum_nd \
                else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            cg = torch.stack([out_p[OCGX], out_p[OCGY], out_p[ODE]])
            fld[RCGX:RCGZ + 1] = torch.where(alive, cg, 0.0)
    if "vapor" in names:
        report["vapor"] = vapor_to_plain(sim, backend, state, aux, own, reps)
    return report


def cgrad_to_scan(fld, tabs, backend, aux, spec, alive, out_k, run_kernel,
                  reps):
    """The strip colour-gradient kernel against its one-pass check kernel
    on the same inputs: no alive row may differ bitwise; both timed in
    turns, the new one the faster; and the counts of its gated filter.
    Returns the report's additions."""
    import torch
    from tpusph_torch.ops import strip_pair
    from tpusph_torch.ops.rows import OCGX, OCGY, ODE, TABLES_1D

    geom, scan = backend.geom, strip_pair.SCANS["cgrad"]

    def run_scan():
        return scan(fld, tabs, backend.win, aux.delta, geom, spec)

    out_s = run_scan()
    sel = [OCGX, OCGY, ODE]
    differ = int((out_k[sel][:, alive].view(torch.int32)
                  != out_s[sel][:, alive].view(torch.int32)).any(0).sum())
    print(f"  cgrad: alive rows that differ bitwise between the filtered "
          f"kernel and the one-pass check kernel: {differ} of "
          f"{int(alive.sum())} (must be 0)")
    assert differ == 0, ("strip cgrad", differ)
    ms, scan_ms = in_turns("cgrad", run_kernel, run_scan, reps)
    counts = gated_counts(
        f"cgrad W {geom.w}", strip_pair.warp_pass_counts(
            fld, backend.win, aux.delta, geom, tabs.cutmax2["cgrad"],
            tabs.tab1[TABLES_1D.index("color")]))
    return dict(ms_in_turns=ms, scan_ms=scan_ms, rows_differ_bitwise=differ,
                warp_passes=counts)


def vapor_to_plain(sim, backend, state, aux, own, reps):
    """The vapor kernel vs its plain version and its one-pass check
    kernel as ``StripBackend.vapor_neighbor`` calls it: every output row
    equal on every slot; the kernel and the check kernel timed in turns
    (the kernel the faster), with the counts of its gated filter."""
    import torch
    from tpusph_torch.ops import strip_pair
    from tpusph_torch.ops.band_pair import pack_fields
    from tpusph_torch.ops.rows import (
        OCGX, OCGY, OFX, OFY, ORHO, RSLOT, RTYPE)

    cfg = sim.phase_change_config
    geom = backend.geom
    cut = min(cfg.cutoff, geom.margin_dist)
    fld = pack_fields(state)
    slot = torch.arange(geom.n_slots, dtype=torch.float32,
                        device=sim.device)
    fld[RSLOT] = torch.where(state.owned, slot, -slot - 1.0)
    kern = strip_pair.vapor_sweep

    def run_kernel():
        return kern(fld, backend.win, aux.delta, geom, cfg.vapor_type, cut)

    def run_plain():
        return strip_pair.plain_vapor_sweep(fld, backend.win, aux.delta,
                                            geom, cfg.vapor_type, cut)

    def run_scan():
        return strip_pair.SCANS["vapor"](fld, backend.win, aux.delta, geom,
                                         cfg.vapor_type, cut)

    out_k = run_kernel()
    out_p = run_plain()
    out_s = run_scan()
    torch.cuda.synchronize()
    alive = state.alive
    errs, differ = [], 0
    for r, what in ((ORHO, "count"), (OCGX, "nearest slot"),
                    (OCGY, "nearest rsq"), (OFX, "nearest owned slot"),
                    (OFY, "nearest owned rsq")):
        a, b = out_k[r], out_p[r]
        neq = int((a != b).sum())
        neq_s = int((a != out_s[r]).sum())
        errs.append(float((a[alive] - b[alive]).abs().max()))
        print(f"  vapor {what}: {neq} of {a.numel()} slots differ from the "
              f"plain version, {neq_s} from the one-pass check kernel "
              "(tolerance: none)")
        assert neq == 0 and neq_s == 0, (what, neq, neq_s)
        differ += neq_s
    ms, scan_ms = in_turns("vapor", run_kernel, run_scan, reps)
    counts = gated_counts(
        f"vapor W {geom.w}", strip_pair.vapor_pass_counts(
            fld, backend.win, aux.delta, geom, cfg.vapor_type, cut))
    nvap = int((out_p[ORHO][alive] > 0).sum())
    assert nvap > 0, "no row has a vapour neighbour"
    typ = fld[RTYPE]
    npairs = live_pairs(fld, backend.win, aux.delta, geom,
                        strip_pair._vapor_cut2(cut), own,
                        keep=lambda pi, pj: typ[pj] == cfg.vapor_type)
    print(f"  {nvap} rows with a vapour neighbour, {npairs} live pairs")
    return dict(max_abs_err=max(errs), ms_in_turns=ms, scan_ms=scan_ms,
                rows_differ_bitwise=differ, warp_passes=counts, **timed(
                    "vapor", run_kernel, run_plain, int(own.sum()),
                    PAIR_OPS["vapor"] * npairs, reps))


def hold_compact(sim, label, reps=10):
    """The compacted force sweep on the strip layout the simulation's next
    step would sweep. Its path, ``tpusph_torch.proto_mxu_compact``'s
    ``compact_inputs`` and ``measure_inputs``, runs with the launch counts
    reset just before it and read just after (the force stage's sweeps,
    the strip force kernel and the compacted kernel must have launched,
    no other: its one-pass check kernel compact_force_scan included); then
    the compacted kernel against the strip force kernel on the same
    inputs, against its one-pass check kernel (bit for bit; both timed in
    turns, the new one the faster), with the counts of its phases, and
    against its plain version. Returns the report."""
    import torch
    from tpusph_torch import proto_mxu_compact as proto
    from tpusph_torch.ops import cuda_build, mxu_compact
    from tpusph_torch.ops.rows import ODE, ODRHO, OFX, OFY, OFZ, RMIX

    spec = sim.spec
    names = (("strip_rho",) if spec.rhosum_every > 0 else ()) \
        + (("strip_cgrad",) if spec.surface_tension else ()) \
        + ("strip_force", "compact_force")
    reset_counts()
    inp = proto.compact_inputs(sim)
    rep = proto.measure_inputs(inp, reps)
    launches = read_counts(names)
    geom = inp.backend.geom
    print(f"  {label}: geometry W {geom.w}, nnbr {geom.nnbr}, ts {geom.ts}, "
          f"{geom.n_slots} slots, {rep['alive']} alive rows; P {inp.P} "
          f"(headroom {inp.headroom}); candidate rows per i-row nnbr*W "
          f"{geom.nnbr * geom.w} -> P ({rep['lane_ratio']:.2f}x)")
    print(f"  {label}: strip force kernel {rep['strip_force_ms']:.3f} ms, "
          f"compacted kernel {rep['compact_force_ms']:.3f} ms on the same "
          f"inputs ({rep['speedup']:.2f}x)")
    for name, err in rep["row_rel_err"].items():
        print(f"  {label} compact vs strip force {name}: max|d|/max|strip| "
              f"{err:.3e} (tolerance {KERNEL_RTOL['force']:.0e})")
        assert err <= KERNEL_RTOL["force"], (label, name, err)
    print(f"  {label}: overflow rows {rep['overflow_rows']} (must be 0)")
    assert rep["overflow_rows"] == 0, rep["overflow_rows"]
    # the same pairs summed in the same order through the same pair body,
    # each kernel with its own filter: equal bit for bit on every alive row
    # (a pair the strip force's warp box dropped would show here)
    alive = inp.state.alive
    rows5 = [OFX, OFY, OFZ, ODRHO, ODE]
    out_k = proto.run_compact(inp)
    strip_differ = int((proto.run_strip(inp)[rows5][:, alive]
                        != out_k[rows5][:, alive]).any(0).sum())
    print(f"  {label}: alive rows whose rows 0-4 differ bitwise between the "
          f"strip force and the compacted sweep: {strip_differ} of "
          f"{int(alive.sum())} (must be 0)")
    assert strip_differ == 0, (label, strip_differ)

    def run_kernel():
        return proto.run_compact(inp)

    def run_scan():
        return mxu_compact.compact_force_scan(
            inp.fld, inp.tabs, inp.backend.win, inp.aux.delta, geom,
            inp.spec, inp.P, inp.cut)

    def run_plain():
        return mxu_compact.plain_compact_force(
            inp.fld, inp.tabs, inp.backend.win, inp.aux.delta, geom,
            inp.spec, inp.P, inp.cut)

    # against the one-pass check kernel: rows 0-4 of every alive row bit
    # for bit, the overflow row equal on every slot
    out_s = run_scan()
    differ = int((out_k[rows5][:, alive].view(torch.int32)
                  != out_s[rows5][:, alive].view(torch.int32)).any(0).sum())
    ocnt_neq = int((out_k[mxu_compact.OCNT] != out_s[mxu_compact.OCNT]).sum())
    print(f"  {label}: alive rows whose rows 0-4 differ bitwise between the "
          f"filtered kernel and the one-pass check kernel: {differ} of "
          f"{int(alive.sum())}, overflow row {ocnt_neq} slots (must be 0)")
    assert differ == 0 and ocnt_neq == 0, (label, differ, ocnt_neq)
    ms, scan_ms = in_turns(f"{label} compact", run_kernel, run_scan, reps)
    print(f"  {label}: compacted kernel / strip force kernel on the same "
          f"inputs {ms / rep['strip_force_ms']:.3f} (in-turns mean over "
          "the strip force's time above)")
    out_p = run_plain()
    # rows 0-4 on the owned particles: the seam-ghost rows' sums are
    # discarded (refresh_seam re-copies the ghosts every step), and on the
    # `uniform` layout a ghost at its band's edge sums a z force up to ~10
    # while its x and y sums cancel to ~1e-5, so float32 sums in any two
    # orders differ there by more than 2e-4 of the x row's largest value
    # (plain version against float64 sums at 32^3: 4.5e-6 on ghost rows,
    # 1.8e-7 on owned rows); against the strip force kernel and the check
    # kernel above, and in the overflow row below, ghost rows are held too
    own = inp.state.alive & inp.state.owned
    errs = compare_rows(f"{label} compact", "force", out_k, out_p, own,
                        (OFX, OFY, OFZ, ODRHO, ODE))
    assert float(out_k[5:7].abs().max()) == 0.0, "rows 5-6 not zero"
    neq = int((out_k[mxu_compact.OCNT] != out_p[mxu_compact.OCNT]).sum())
    print(f"  {label} compact overflow row: {neq} slots differ (tolerance: "
          "none)")
    assert neq == 0, neq
    # the bound is the strip force sweep's: the same function over the
    # same live pairs
    fld, cut2 = inp.fld, inp.tabs.cutmax2["force"]
    npairs = live_pairs(fld, inp.backend.win, inp.aux.delta, geom, cut2, own)
    st_pairs = live_pairs(fld, inp.backend.win, inp.aux.delta, geom, cut2,
                          own, keep=lambda pi, pj: fld[RMIX][pi] > 0.25)
    ops = PAIR_OPS["force"] * npairs + PAIR_OPS["force_st"] * st_pairs
    print(f"  {label}: live pairs {npairs}, in tiles flagged > 0.25: "
          f"{st_pairs}")
    counts = pass_counts(f"{label} W {geom.w} t_blk {geom.t_blk}", fld,
                         inp.backend.win, inp.aux.delta, geom, cut2)
    ccounts = compact_counts(label, inp)
    times = timed(f"{label} compact", run_kernel, run_plain, int(own.sum()),
                  ops, reps, kind="force")
    torch.cuda.synchronize()
    log = cuda_build.load().ptxas_log
    regs, spill = cuda_build.kernel_resources(log, "compact_filter_kernel")
    scan_regs, scan_spill = cuda_build.kernel_resources(
        log, "compact_scan_kernel")
    return dict(max_abs_err=max(errs), launches=launches["compact_force"],
                strip_force_ms=rep["strip_force_ms"],
                ms_beside_strip=rep["compact_force_ms"], P=inp.P, W=geom.w,
                lane_ratio=rep["lane_ratio"],
                overflow_rows=rep["overflow_rows"],
                rows_differ_from_strip=strip_differ, ms_in_turns=ms,
                scan_ms=scan_ms, rows_differ_bitwise=differ,
                registers=regs, spill_stores=spill,
                scan_registers=scan_regs, scan_spill_stores=scan_spill,
                warp_passes=counts, compact_passes=ccounts, **times)


def compact_counts(label, inp):
    """``mxu_compact.compact_pass_counts`` on the compacted sweep's inputs,
    printed with the ratios that decide its design; the host copy of its
    warp box filter must keep every live pair of a kept row. Returns the
    counts."""
    from tpusph_torch.ops import mxu_compact
    c = mxu_compact.compact_pass_counts(
        inp.fld, inp.backend.win, inp.aux.delta, inp.backend.geom, inp.P,
        inp.cut, inp.tabs.cutmax2["force"])
    tiles, warps = max(c["tiles"], 1), max(c["warps"], 1)
    print(f"  {label} compact counts: {json.dumps(c)}")
    print(f"  {label} compact: per tile {c['steps'] / tiles:.1f} compaction "
          f"steps, {c['survivors'] / tiles:.1f} survivors, "
          f"{c['kept'] / tiles:.1f} kept, {c['chunks'] / tiles:.2f} chunks; "
          f"per warp {c['box_survivors'] / warps:.1f} box survivors, "
          f"{c['live_pairs'] / warps:.1f} live pairs, body passes "
          f"{c['lockstep_passes'] / warps:.1f} lockstep (check kernel), "
          f"{c['queue_passes'] / warps:.1f} queue "
          f"({c['lockstep_passes'] / max(c['queue_passes'], 1):.2f}x fewer)")
    assert c["live_outside_box"] == 0, c
    return c


def uniform_compact(n):
    """The `uniform` bench after 5 steps on the strip (the reference
    prototype's run), then ``hold_compact`` on its layout. Returns (sim,
    report)."""
    from tpusph_torch.bench import build_bench_sim

    sim = build_bench_sim(n, mode="uniform", device="cuda")
    sim.run(5)
    print(f"  backend {type(sim._runner.backend).__name__}, strip W "
          f"{sim._strip_geom.w}")
    return sim, hold_compact(sim, "uniform")


def owned_totals(sim):
    """(total owned mass, momentum vector, sum of m|v|, liquid mass,
    vapour count) in float64."""
    import torch
    st = sim.state
    own = st.alive & st.owned
    m = torch.where(own, st.rmass, 0.0).double()
    p = (m[:, None] * st.v.double()).sum(0)
    return (float(m.sum()), p.cpu().numpy(),
            float((m * st.v.double().norm(dim=1)).sum()),
            float(torch.where(st.type == 1, m, 0.0).sum()),
            int((own & (st.type == 2)).sum()))


def reset_counts():
    from tpusph_torch.ops import all_kernels
    for k in all_kernels().values():
        k.reset()


def card_counts(names):
    """The launch counts of the kernels ``names`` since the last reset, by
    card index."""
    from tpusph_torch.ops import all_kernels
    kernels = all_kernels()
    return {s: dict(sorted(kernels[s].by_card.items())) for s in names}


def read_counts(names):
    """The launch counts of the kernels ``names`` since the last reset; each
    must have launched, and no other kernel may have."""
    from tpusph_torch.ops import all_kernels
    kernels = all_kernels()
    launches = {s: kernels[s].launches for s in names}
    others = {s: k.launches for s, k in kernels.items() if s not in names}
    print(f"  launches on the main path: {launches}; other kernels: "
          f"{others}")
    for s, n in launches.items():
        assert n > 0, f"{s} kernel never launched on the main path"
    for s, n in others.items():
        assert n == 0, f"{s} kernel launched off its path ({n})"
    return launches


def phase_main(sim, mode, steps, windows, backend="strip"):
    """One bench main path, ``mode`` "dynamic" or "boiling", on
    ``backend`` ("strip": the strip; "band": the band backend; "pallas":
    the column kernel); returns (launches, bench line)."""
    import numpy as np
    import torch
    from tpusph_torch.bench import run_bench

    if sim.aux is None:
        sim._build_state()
    mass0, p0, mv0, liq0, nvap0 = owned_totals(sim)
    n0 = sim.natoms
    if backend == "pallas":
        names = COLUMN
    elif backend == "band":
        names = BAND
    else:
        names = STRIP if mode == "boiling" else STRIP[:3]
    reset_counts()
    bench = run_bench(sim=sim, n_steps=steps, n_windows=windows, mode=mode,
                      backend=backend)
    launches = read_counts(names)
    if backend == "band":
        # the timed windows ran on band (bench "backend" is that of the
        # last window's runner)
        print(f"  backend {bench['backend']}, band geometry "
              f"{bench['band_geometry']}")
        assert bench["backend"] == "BandBackend", bench["backend"]
    assert int(sim.aux.overflow.sum()) == 0, "overflow at the end"
    st = sim.state
    for name in ("x", "v", "vest", "f", "rho", "drho", "e", "de"):
        assert torch.isfinite(getattr(st, name)).all(), f"{name} not finite"
    assert bench["particles"] == n0
    mass1, p1, mv1, liq1, nvap1 = owned_totals(sim)
    dmass = abs(mass1 - mass0) / mass0
    # `uniform` starts at rest: its scale is the larger of sum m|v| before
    # and after
    scale = max(mv0, mv1) if mode == "uniform" else mv0
    dp = float(np.abs(p1 - p0).max()) / scale
    print(f"  owned mass drift {dmass:.3e} (bound 1e-6); momentum drift "
          f"{dp:.3e} of sum m|v| {scale:.6e} (bound 1e-4)")
    assert dmass <= 1e-6, dmass
    assert dp <= 1e-4, dp
    if mode == "boiling":
        inserted = sim.natoms - n0
        dm = sim.phase_change_config.dm
        debit = liq0 - liq1
        print(f"  insertions {inserted}, vapour particles {nvap0} -> "
              f"{nvap1}; liquid mass debit {debit:.6f} vs dm x insertions "
              f"{dm * inserted:.6f} (bound 1e-5 relative: float64 sums of "
              "float32 masses, each debit rounded to float32); geometry "
              f"re-choices {sim._strip_violations}, decays "
              f"{sim._strip_decays}")
        assert inserted > 0, "no insertion on the boiling path"
        assert nvap1 - nvap0 == inserted, (nvap0, nvap1, inserted)
        assert abs(debit - dm * inserted) <= 1e-5 * dm * inserted, debit
        bench["insertions"] = inserted
    return launches, bench


def phase_slices():
    """The CPU tests' slices on the GPU against the plain versions on the
    CPU: the 16^3 `dynamic` bench (tests/test_torch_slice.py) and the 12^3
    boiling bubble (tests/test_torch_phase_change.py)."""
    dynamic_slice("strip")
    bubble_slice("strip")


def dynamic_slice(backend):
    """The 16^3 `dynamic` bench (lattice moved off the cell edges by half a
    spacing, a rebuild every 5 steps) for 20 steps on ``backend``, on the
    GPU against the CPU."""
    import numpy as np
    from tpusph_torch.bench import build_bench_sim

    sims = {}
    for dev in ("cuda", "cpu"):
        sim = build_bench_sim(4096, mode="dynamic", device=dev,
                              backend=backend)
        sim._staged["x"] += 0.5
        sim.reneigh_every = 5
        sim.run(20)
        sims[dev] = sim
    kind = type(sims["cuda"]._runner.backend).__name__
    assert kind == type(sims["cpu"]._runner.backend).__name__
    for field in ("rho", "e", "v", "x"):
        a, b = sims["cpu"].get(field), sims["cuda"].get(field)
        d = b - a
        if field == "x":
            d -= 16.0 * np.round(d / 16.0)
        err = float(np.abs(d).max())
        print(f"  dynamic slice on {kind} {field}: max |gpu - cpu| "
              f"{err:.3e} (bound 5e-5)")
        assert err <= 5e-5, (field, err)


def bubble_slice(backend):
    """The 12^3 boiling bubble (prob 1) for 20 steps on ``backend``, on the
    GPU against the CPU: the same events, sums, originals and inserted
    positions."""
    import numpy as np
    from tpusph_torch.bench import build_bubble_sim

    sims = {}
    for dev in ("cuda", "cpu"):
        sim = build_bubble_sim(dev, backend=backend)
        n0 = sim.natoms
        sim.run(20)
        sims[dev] = sim
    a, b = sims["cpu"], sims["cuda"]
    kind = type(b._runner.backend).__name__
    assert kind == type(a._runner.backend).__name__
    print(f"  boiling slice on {kind}: insertions gpu {b.natoms - n0}, cpu "
          f"{a.natoms - n0}")
    assert a.natoms == b.natoms and a.natoms > n0
    for field in ("rmass", "e"):
        for phase in (1, 2):
            sa = float(a.get(field)[a.get("type") == phase].sum(
                dtype=np.float64))
            sb = float(b.get(field)[b.get("type") == phase].sum(
                dtype=np.float64))
            print(f"  boiling slice sum {field} phase {phase}: gpu {sb!r} "
                  f"cpu {sa!r} (bound 1e-6 relative)")
            assert abs(sb - sa) <= 1e-6 * abs(sa), (field, phase, sa, sb)

    def by_tag(sim, f):
        tag = sim.get("tag")
        keep = tag <= n0
        return sim.get(f)[keep][np.argsort(tag[keep])]

    for f in ("x", "e", "rmass"):
        err = float(np.abs(by_tag(b, f) - by_tag(a, f)).max())
        print(f"  boiling slice originals {f}: max |gpu - cpu| {err:.3e} "
              "(bound 1e-5)")
        assert err <= 1e-5, (f, err)
    def inserted(sim):
        # a multiset of positions: the two runs mint tags in pool order
        x = sim.get("x")[sim.get("tag") > n0]
        return x[np.lexsort(np.round(x, 4).T)]

    err = float(np.abs(inserted(b) - inserted(a)).max())
    print(f"  boiling slice inserted positions: max |gpu - cpu| {err:.3e} "
          "(bound 1e-5)")
    assert err <= 1e-5, err


def cell_layout(kind, backend, state, aux):
    """(fld, layout, kernels, the one-pass check kernels by sweep, plain
    sweep, pair counter) of the column kernel's cell grid (``kind``
    "column") or the band's slot-resident sub-cells ("band"); every sweep
    of either has a check kernel. Every alive row of either
    layout is an owned particle. ``count(fld, cut2, keep)`` counts the
    (i, j) pairs with both types alive and 1e-12 < rsq < cut2 in the
    sweeps' windows, filtered by ``keep(pi, pj)`` when given."""
    from tpusph_torch.ops import band_pair, pallas_pair

    if kind == "column":
        cg = backend.colgrid
        fld, _, _ = pallas_pair.pack_dense(state, aux, cg)
        reach = band_pair.live_reach(fld, cg.cap)
        nblocks = cg.ncols * cg.ncz
        step = max(1, band_pair._PLAIN_CHUNK // (reach * reach * 3
                                                 * cg.nnbr))

        def pairs(fld, b0, b1, cut2):
            return pallas_pair._column_pairs(fld, cg, b0, b1, cut2, reach)

        layout, mod, plain = cg, pallas_pair, pallas_pair.plain_column_sweep
    else:
        geom = backend.geom
        fld = band_pair.pack_fields(state)
        reach = band_pair.live_reach(fld, geom.c)
        nblocks = geom.ncols * geom.ngroups
        step = max(1, band_pair._PLAIN_CHUNK // (
            geom.G * reach * geom.nnbr * (geom.G + 2 * geom.k) * reach))

        def pairs(fld, b0, b1, cut2):
            return band_pair._band_pairs(fld, geom, b0, b1, cut2, reach)

        layout, mod, plain = geom, band_pair, band_pair.plain_band_sweep

    def count(fld, cut2, keep=None):
        total = 0
        for b0 in range(0, nblocks, step):
            pi, pj, _ = pairs(fld, b0, min(b0 + step, nblocks), cut2)
            total += pi.numel() if keep is None else int(keep(pi, pj).sum())
        return total

    return fld, layout, mod.KERNELS, mod.SCANS, plain, count


def cell_counts(label, fld, layout, cut2, sweep="force", colors=None):
    """``cell_filter.cell_pass_counts`` of ``sweep``'s kernel on a column
    or band layout, printed with the ratios that decide its design; the
    host copy of the kernel's box filter (and colour gate) must keep every
    pair the sweep needs. Returns the counts."""
    from tpusph_torch.ops import cell_filter
    c = cell_filter.cell_pass_counts(fld, layout, cut2, sweep, colors)
    rows, warps = max(c["rows"], 1), max(c["warps"], 1)
    print(f"  {label} counts: {json.dumps(c)}")
    print(f"  {label}: per row {c['candidates'] / rows:.1f} one-pass "
          f"candidates, {c['live_pairs'] / rows:.1f} live pairs, "
          f"{c['needed_pairs'] / rows:.2f} needed; reach pass "
          f"{c['reach_reads']} type reads ({c['ballot_reads']} in a "
          "per-slot ballot pass); blocks "
          f"{c['blocks_alive']} of {c['blocks']} hold an alive row, "
          f"{c['gate_exits']} of those exit on the colour gate; "
          f"{c['rounds']} staging rounds ({c['multi_round_windows']} windows "
          f"in more than one), {c['staged_rows']} rows staged of which "
          f"{c['staged_with_terms']} with their terms; per warp "
          f"{c['box_survivors'] / warps:.1f} box survivors, body passes "
          f"{c['old_passes'] / warps:.1f} lockstep, "
          f"{c['body_passes'] / warps:.1f} in the kernel "
          f"({c['old_passes'] / max(c['body_passes'], 1):.2f}x fewer); "
          "lanes on a needed pair in a body pass "
          f"{c['needed_pairs'] / (32 * max(c['old_passes'], 1)):.1%} "
          "lockstep, "
          f"{c['needed_pairs'] / (32 * max(c['body_passes'], 1)):.1%} in "
          "the kernel")
    assert c["live_outside_box"] == 0, c
    return c


def in_turns(label, run_new, run_scan, reps):
    """CUDA-event times of a filtered kernel and its one-pass check kernel
    on the same inputs, in turns (new, scan, scan, new); the filtered one
    must be the faster. Returns (ms, scan_ms), each the mean of its two
    turns."""
    t = [cuda_ms(f, reps) for f in (run_new, run_scan, run_scan, run_new)]
    ms, scan_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"  {label}: filtered {t[0]:.3f} / {t[3]:.3f} ms, one-pass "
          f"check {t[1]:.3f} / {t[2]:.3f} ms in turns ({ms / scan_ms:.2f}x)")
    assert ms < scan_ms, (label, ms, scan_ms)
    return ms, scan_ms


def hold_cells_to_plain(sim, kind, after_run=False, reps=10):
    """Each column (``kind`` "column") or band ("band") kernel against its
    plain version on the layout of ``layout_state``, fed as the backend's
    force stage feeds them (rho patched before cgrad, cg before force);
    each kernel also against its one-pass check kernel (no alive row may
    differ bitwise;
    both timed in turns, the filtered one the faster) with the counts of
    its phases; after a main path with phase change also the cell-grid
    vapor query's time per firing. Returns {name: report}."""
    import torch
    from tpusph_torch.ops.rows import (
        OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RCGZ, RM, RRHO,
        RTYPE, TABLES_1D)

    backend, state, aux, tabs = layout_state(sim, after_run)
    fld, layout, kernels, scans, plain, count = cell_layout(kind, backend,
                                                            state, aux)
    spec = sim.spec
    alive = fld[RTYPE] > 0.5
    n_own = int(alive.sum())
    if kind == "column":
        print(f"  cell grid {layout.ncols} columns x {layout.ncz} cells, cap "
              f"{layout.cap}, {layout.n_slots} slots, {n_own} particles, "
              f"overflow {int(aux.overflow.sum())}")
    else:
        print(f"  band geometry {layout.ncols} columns x {layout.nsub} "
              f"sub-cells (G {layout.G}, c {layout.c}, k {layout.k}; window "
              f"{layout.w_real} rows), {layout.n_slots} slots, {n_own} "
              f"particles, overflow {int(aux.overflow.sum())}")
    assert int(aux.overflow.sum()) == 0
    cut2 = tabs.cutmax2["force"]
    typ = fld[RTYPE]
    npairs = count(fld, cut2)
    # the colour gradient is summed over pairs of unlike types only
    mixed = count(fld, cut2, keep=lambda pi, pj: typ[pi] != typ[pj])
    print(f"  live pairs {npairs} ({npairs / n_own:.1f} per particle), of "
          f"unlike types {mixed}")
    rows = {"rho": (ORHO,), "cgrad": (OCGX, OCGY, ODE),
            "force": (OFX, OFY, OFZ, ODRHO, ODE)}
    report = {}
    for sweep in ("rho", "cgrad", "force"):
        kern = kernels[sweep]

        def run_kernel():
            return kern(fld, tabs, layout, spec)

        def run_plain():
            return plain(sweep, fld, tabs, layout, spec)

        out_k = run_kernel()
        out_p = run_plain()
        errs = compare_rows(f"{kind} {sweep}", sweep, out_k, out_p, alive,
                            rows[sweep])
        if sweep == "rho":
            ops = PAIR_OPS["rho"] * npairs
        elif sweep == "cgrad":
            ops = PAIR_OPS["cgrad"] * mixed
        else:
            # the capillary terms need the pairs where either side carries
            # a colour gradient
            cgn = (fld[RCGX:RCGZ + 1] != 0).any(0)
            st_pairs = count(fld, cut2, keep=lambda pi, pj: cgn[pi] | cgn[pj])
            print(f"  pairs with a colour gradient on either side "
                  f"{st_pairs}")
            ops = PAIR_OPS["force"] * npairs + PAIR_OPS["force_st"] * st_pairs
        report[sweep] = dict(max_abs_err=max(errs), **timed(
            f"{kind} {sweep}", run_kernel, run_plain, n_own, ops, reps,
            kind=sweep))
        # the same pairs in the same order through the same pair body:
        # equal bit for bit on every alive row (a pair the kernel's
        # filter or colour gate dropped would show here)
        scan = scans[sweep]

        def run_scan():
            return scan(fld, tabs, layout, spec)

        out_s = run_scan()
        sel = list(rows[sweep])
        differ = int((out_k[sel][:, alive].view(torch.int32)
                      != out_s[sel][:, alive].view(torch.int32))
                     .any(0).sum())
        print(f"  {kind} {sweep}: alive rows that differ bitwise between "
              f"the filtered kernel and the one-pass check kernel: "
              f"{differ} of {n_own} (must be 0)")
        assert differ == 0, (kind, sweep, differ)
        ms, scan_ms = in_turns(f"{kind} {sweep}", run_kernel, run_scan,
                               reps)
        report[sweep].update(
            ms_in_turns=ms, scan_ms=scan_ms, rows_differ_bitwise=differ,
            warp_passes=cell_counts(
                f"{kind} {sweep}", fld, layout, tabs.cutmax2[sweep],
                sweep, tabs.tab1[TABLES_1D.index("color")]))
        if sweep == "rho":
            total = out_p[ORHO] * fld[RM] if spec.rhosum_nd else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            fld[RCGX:RCGZ + 1] = torch.where(alive, out_p[[OCGX, OCGY, ODE]],
                                             0.0)
    if after_run and sim.phase_change_config is not None:
        cfg = sim.phase_change_config
        ms = cuda_ms(lambda: backend.vapor_neighbor(
            state, sim.box, cfg.vapor_type, cfg.cutoff, aux), 3)
        nvap = int((state.alive & (state.type == cfg.vapor_type)).sum())
        print(f"  cell-grid vapor query (plain PyTorch): {ms:.3f} ms per "
              f"firing, {nvap} vapour particles")
        report["vapor_query_ms"] = ms
    return report


def retry_sim(device, phase_change=True):
    """tests/test_torch_margin_decay.py's retry system: a 6 x 6 x nz
    lattice, heat conduction, a rebuild and an observation every 2 steps,
    and margin floors so high that no strip geometry fits. With
    ``phase_change`` fix phase_change is on (no vapour type present: no
    event fires, but the fallback is the column kernel) and nz is 36;
    without it the fallback is band, and nz is 44
    (tests/test_torch_band_path.py: at the strip's lower column headroom
    the 36-plane box still strips)."""
    import numpy as np
    from tpusph_torch.api import Simulation
    from tpusph_torch.ops.phase_change import PhaseChangeConfig

    nz = 36 if phase_change else 44
    sim = Simulation(dim=3, screen=False, device=device)
    sim.backend_name = "strip"
    sim.create_box([0, 0, 0], [6.0, 6.0, float(nz)], periodic=(True,) * 3,
                   ntypes=1)
    ax = np.arange(6, dtype=np.float32)
    az = np.arange(nz, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, az, indexing="ij"), -1).reshape(-1, 3)
    sim.add_particles(g, np.ones(len(g), np.int32), rho=1.0,
                      e=np.where(g[:, 0] < 3.0, 1.5, 1.0).astype(np.float32),
                      cv=1.0, rmass=1.0)
    sim.pair_heatconduction()
    sim.tables.set_heatconduction(1, 1, d=0.5, h=2.4)
    sim.neighbor_skin = 0.4
    sim.dt = 1e-3
    sim.thermo(2)
    sim.reneigh_every = 2
    sim._strip_extra = (4096, 4096)
    if phase_change:
        sim.configure_phase_change(PhaseChangeConfig(
            t_threshold=2.0, latent=1.0, dm=1e-3, liquid_type=1,
            vapor_type=2, every=2, cutoff=2.4))
    return sim


def phase_ladder():
    """The backend ladder on the card: a phase-change bubble whose periodic
    z axis (10 planes, 2.5 < 4 x (cutoff + skin)) cannot strip runs on the
    column kernel on the ladder from the strip (its 1,440 particles would
    take the dense rung under "auto"); and the retry systems abandon the strip
    for the column kernel (phase change on) and for band (phase change
    off), then come back to it after three calm rebuilds, each with the CPU
    run's trajectory."""
    import warnings
    import numpy as np
    from tpusph_torch.bench import build_bubble_sim
    from tpusph_torch.ops.band_pair import BandBackend
    from tpusph_torch.ops.pallas_pair import PallasBackend
    from tpusph_torch.ops.strip_pair import StripBackend

    reset_counts()
    sim = build_bubble_sim("cuda", backend="strip", nz=10)
    n0 = sim.natoms
    sim.run(10)
    print(f"  short column axis: {type(sim._runner.backend).__name__}, "
          f"{sim.natoms - n0} insertions in 10 steps")
    assert isinstance(sim._runner.backend, PallasBackend)
    assert sim.natoms > n0
    # heat conduction alone: the force sweep is the bubble's only sweep
    read_counts(("column_force",))

    for phase_change, fallback in ((True, PallasBackend),
                                   (False, BandBackend)):
        es = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            sim = retry_sim(dev, phase_change)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sim.run(2)
            assert any("abandoned" in str(w.message) for w in caught)
            first = type(sim._runner.backend).__name__
            assert type(sim._runner.backend) is fallback, first
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sim.run(28)
            print(f"  retry on {dev}: {first} -> "
                  f"{type(sim._runner.backend).__name__}, extra "
                  f"{sim._strip_extra}, steps {sim.step_count}")
            assert isinstance(sim._runner.backend, StripBackend)
            assert sim._strip_extra == (0, 0) and sim.step_count == 30
            if dev == "cuda":
                # the fallback's force kernel and then the strip's ran (and
                # with phase change the strip's vapor query, every 2 steps)
                read_counts(("column_force", "strip_force", "strip_vapor")
                            if phase_change else ("band_force", "strip_force"))
            es[dev] = sim.get("e")
            assert np.isfinite(es[dev]).all()
        err = float(np.abs(es["cuda"] - es["cpu"]).max())
        print(f"  retry via {fallback.__name__} e: max |gpu - cpu| "
              f"{err:.3e} (bound 5e-6)")
        assert err <= 5e-6, err


# the kernels of each backend's path (the dense rung launches none)
PATH_KERNELS = {"StripBackend": STRIP, "PallasBackend": COLUMN,
                "BandBackend": BAND, "DenseBackend": ()}


def run_case_cli(tag, script, var, out_dir, extra=()):
    """Write ``script`` and run it through ``python -m tpusph_torch.cli
    run`` (``cli.main``, with the arguments ``extra``) on the card from
    ``out_dir``, where its log and the files it names (dumps) go; returns
    (simulation, log path, wall seconds)."""
    import os
    from tpusph_torch import cli

    path = os.path.join(out_dir, f"in.{tag}")
    with open(path, "w") as f:
        f.write(script)
    log = os.path.join(out_dir, f"log.{tag}")
    args = ["run", path, "--log", log, "--screen", "none", *extra]
    for k, v in var.items():
        args += ["-var", k, v]
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        t0 = time.perf_counter()
        assert cli.main(args) == 0
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return cli.last_run.sim, log, wall


def case_launches(sim):
    """The launches since the last reset: the force kernel of the backend
    that ran (where it has kernels) launched, no check kernel and no
    kernel of a backend that did not run; returns the nonzero counts."""
    from tpusph_torch.ops import all_kernels
    kind = type(sim._runner.backend).__name__
    counts = {s: k.launches for s, k in all_kernels().items()}
    ran = {k for k, n in counts.items() if n > 0}
    print(f"  backend {kind}; launches {dict((k, counts[k]) for k in sorted(ran))}")
    assert not {k for k in ran if k.endswith("_scan")}, ran
    path = PATH_KERNELS[kind]
    if path:
        assert counts[path[2]] > 0, f"{path[2]} never launched"
        # a re-choice may leave the strip for its ladder's next rung and
        # come back
        assert ran <= set(STRIP) | set(COLUMN) | set(BAND), ran
    else:
        assert not ran, ran
    return kind, {k: counts[k] for k in sorted(ran)}


def phase_cases():
    """The five case scripts through the CLI on the card (phase 22 of the
    module docstring), their scripts, logs and restarts in a temporary
    directory; prints config 4's log; returns the phase's JSON record."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cases_") as out_dir:
        return _phase_cases(out_dir)


def _phase_cases(out_dir):
    import os
    import numpy as np
    import torch
    from tpusph_torch import cases as caselib

    record = {}
    for name, spec in caselib.GOLDEN.items():
        reset_counts()
        sim, log, wall = run_case_cli(name, caselib.golden_script(name),
                                      spec["var"], out_dir)
        header, rows = caselib.parse_log(log)
        gold_header, gold = caselib.parse_log(
            os.path.join("tests", "golden", f"log.{name}"))
        assert header == gold_header, (header, gold_header)
        assert rows[-1, 0] == gold[-1, 0], rows[:, 0]
        errs = caselib.rows_within_bar(header, rows, gold)
        kind, launches = case_launches(sim)
        worst = max(e / a for e, a in errs.values() if a > 0)
        print(f"  {name}: {sim.natoms} atoms, {len(rows)} rows within the "
              f"golden bar (largest error {worst:.3f} of the bar; "
              f"{errs}), {wall:.1f} s")
        record[name] = dict(backend=kind, atoms=sim.natoms, wall_s=wall,
                            worst_of_bar=worst, launches=launches)

    # heat_slab as committed (dx 0.02, 1000 steps, its dump): sum(e)
    # (PotEng) is conserved by conduction; the dump holds its three
    # snapshots of every atom
    reset_counts()
    sim, log, wall = run_case_cli(
        "heat_slab_dx0.02", open("cases/heat_slab/in.heat_slab").read(),
        {}, out_dir)
    header, rows = caselib.parse_log(log)
    assert np.isfinite(rows).all() and rows[-1, 0] == 1000, rows[:, 0]
    pe = rows[:, header.index("PotEng")]
    drift = float(np.abs(pe - pe[0]).max() / pe[0])
    kind, launches = case_launches(sim)
    dump = open(os.path.join(out_dir, "dump.heat_slab")).read().split("\n")
    snaps = [int(dump[k + 1]) for k, line in enumerate(dump)
             if line == "ITEM: TIMESTEP"]
    natoms = [int(dump[k + 1]) for k, line in enumerate(dump)
              if line == "ITEM: NUMBER OF ATOMS"]
    print(f"  heat_slab dx 0.02: {sim.natoms} atoms, PotEng drift {drift:.2e} "
          f"(bound 1e-5), dump steps {snaps} of {natoms} atoms, {wall:.1f} s")
    assert drift <= 1e-5, drift
    assert snaps == [0, 500, 1000], snaps
    assert natoms == [sim.natoms] * 3, natoms
    record["heat_slab_dx0.02"] = dict(backend=kind, atoms=sim.natoms,
                                      wall_s=wall, pe_drift=drift,
                                      dump_steps=snaps, launches=launches)

    # bubble_rise at dx 0.01: config 4 at its full size
    lines = caselib.build_lines("cases/bubble_rise/in.bubble_rise")
    snap = [os.path.join(out_dir, f"bubble_rise_full.{k}.npz")
            for k in (0, 1)]
    script = "\n".join(lines + [
        "thermo 10", "thermo_style custom step time ke atoms",
        f"write_restart {snap[0]}", "run 20", "run 20",
        f"write_restart {snap[1]}"]) + "\n"
    reset_counts()
    sim, log, wall = run_case_cli("bubble_rise_dx0.01", script,
                                  {"dx": "0.01"}, out_dir)
    kind, launches = case_launches(sim)
    header, rows = caselib.parse_log(log)
    assert np.isfinite(rows).all() and rows[-1, 0] == 40, rows
    assert int(sim.aux.overflow.sum()) == 0, "overflow at the end"
    print("  " + open(log).read().replace("\n", "\n  ").rstrip())
    loops = [line.split() for line in open(log)
             if line.startswith("Loop time of")]
    loop_s, steps, atoms = float(loops[-1][3]), int(loops[-1][8]), \
        int(loops[-1][11])
    rate = atoms * steps / loop_s
    a, b = (dict(np.load(p)) for p in snap)
    n0 = len(a["staged_tag"])
    assert n0 > 450_000, n0
    ia, ib = np.argsort(a["staged_tag"]), np.argsort(b["staged_tag"])
    np.testing.assert_array_equal(a["staged_tag"][ia], b["staged_tag"][ib])
    wall_a = ~a["staged_mobile"][ia]
    assert wall_a.sum() > 0
    moved = int((a["staged_x"][ia][wall_a]
                 != b["staged_x"][ib][wall_a]).any(1).sum())
    m0, m1 = (z["staged_rmass"].astype(np.float64) for z in (a, b))
    t0, t1 = a["staged_type"], b["staged_type"]
    cfg = sim.phase_change_config
    debit = float(m0[t0 == 1].sum() - m1[t1 == 1].sum())
    gain = float(m1[t1 == 2].sum() - m0[t0 == 2].sum())
    dmass = abs(float(m1.sum() - m0.sum())) / float(m0.sum())
    events = debit / cfg.dm
    rechoices = sim._strip_violations + sim._strip_decays
    print(f"  bubble_rise dx 0.01: {n0} atoms on {kind} (strip W "
          f"{getattr(sim._strip_geom, 'w', None)}), {rechoices} re-choices "
          f"({sim._strip_violations} violations, {sim._strip_decays} "
          f"decays); {rate:.4g} particle-steps/s over the last {steps} "
          f"steps ({loop_s:.3f} s); wall rows moved {moved} of "
          f"{int(wall_a.sum())}; mass drift {dmass:.2e} (bound 1e-6); "
          f"liquid debit {debit:.6e} vs vapour gain {gain:.6e} "
          f"(~{events:.1f} events of dm {cfg.dm:.3e}); {wall:.1f} s")
    assert moved == 0, moved
    assert dmass <= 1e-6, dmass
    assert abs(debit - gain) <= 1e-5 * max(abs(debit), cfg.dm), (debit,
                                                                  gain)
    record["bubble_rise_dx0.01"] = dict(
        backend=kind, atoms=n0, particle_steps_per_s=rate, loop_s=loop_s,
        steps=steps, rechoices=rechoices,
        violations=sim._strip_violations, decays=sim._strip_decays,
        strip_w=getattr(sim._strip_geom, "w", None), launches=launches,
        wall_rows=int(wall_a.sum()), wall_rows_moved=moved,
        mass_drift=dmass, events=events, wall_s=wall,
        card=torch.cuda.get_device_name(0))
    return record


# bricks vs one device (phase 23): the inner of each 4-brick run, the
# procgrid, the kernels it launches, and its rho bar (tests/test_dist.py)
BRICK_CASES = (
    ("strip 4", "strip", None, None, STRIP[:3], 1e-4),
    ("column 4", "pallas", None, None, COLUMN, 2e-4),
    ("cellgrid 4", "cellgrid", None, None, (), 1e-4),
    ("strip 2x2", "strip", (2, 2), (0, 1), STRIP[:3], 1e-4),
)
BRICK_INNERS = {"strip": "StripBackend", "pallas": "PallasBackend",
                "cellgrid": "CellGridBackend"}


def brick_run(n, steps, backend, nbricks=1, shape=None, axes=None,
              device="cuda", mode="dynamic", devices=None):
    """The bench in ``mode`` at ``n`` particles for ``steps`` steps on one
    device or in ``nbricks`` bricks (``Simulation.set_mesh``: over
    ``devices``, by default every visible card), the launch counts reset
    just before the run; returns (simulation, fields by tag, wall
    seconds)."""
    from tpusph_torch.bench import build_bench_sim, sync
    sim = build_bench_sim(n, mode=mode, device=device, backend=backend)
    if nbricks > 1:
        sim.set_mesh(nbricks, shape=shape, axes=axes, devices=devices)
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps)
    sync(sim)
    wall = time.perf_counter() - t0
    return sim, {f: sim.get(f) for f in ("x", "v", "rho", "e", "tag")}, wall


def hold_bricks(label, a, b, L, rho_tol):
    """Hold a brick run's fields ``b`` to ``a`` (by tag) at
    tests/test_dist.py's bars: minimum-image x and v to 5e-4, rho rtol
    ``rho_tol``, e rtol 1e-4 / atol 1e-5, the same tags. Returns the
    largest differences."""
    import numpy as np
    dx = b["x"] - a["x"]
    dx = float(np.abs(dx - L * np.round(dx / L)).max())
    dv = float(np.abs(b["v"] - a["v"]).max())
    drho = float((np.abs(b["rho"] - a["rho"]) / np.abs(a["rho"])).max())
    de = float((np.abs(b["e"] - a["e"]) / np.abs(a["e"])).max())
    assert np.array_equal(a["tag"], b["tag"]), label
    assert dx <= 5e-4 and dv <= 5e-4, (label, dx, dv)
    np.testing.assert_allclose(b["rho"], a["rho"], rtol=rho_tol)
    np.testing.assert_allclose(b["e"], a["e"], rtol=1e-4, atol=1e-5)
    return dict(max_dx=dx, max_dv=dv, rho_rel=drho, e_rel=de)


def phase_bricks_small(n=48 ** 3, steps=30, device="cuda"):
    """Phase 23: the `dynamic` bench at ``n`` particles for ``steps`` steps
    on one device (the strip) and in 4 bricks over every visible card with
    each inner (strip, column kernel, cell grid; and the strip on a 2 x 2
    procgrid, the corner relay): each brick run held to the one-device run
    at tests/test_dist.py's bars (hold_bricks; rho rtol 1e-4, 2e-4 for
    the column inner), its inner, the kernels it launched and no other (no
    check kernel), and no overflow. Where several cards are visible, the
    strip's 4 bricks run again all on cuda:0 and the across-cards run is
    held to that run at the same bars. Returns the phase's record."""
    import numpy as np
    import torch
    one, a, wall1 = brick_run(n, steps, "strip", device=device)
    if device == "cuda":
        read_counts(STRIP[:3])
    ncards = torch.cuda.device_count() if device == "cuda" else 1
    L = one.box.length.cpu().numpy().astype(np.float64)
    record = dict(particles=one.natoms, steps=steps, one_device_s=wall1,
                  cards_visible=ncards, runs={})
    print(f"  one device: {one.natoms} particles, strip W "
          f"{one._strip_geom.w}, {steps} steps in {wall1:.2f} s; "
          f"{ncards} card(s) visible")
    fields = {}
    for label, backend, shape, axes, names, rho_tol in BRICK_CASES:
        sim, b, wall = brick_run(n, steps, backend, 4, shape, axes, device)
        be = sim._runner.backend
        launches = read_counts(names) if device == "cuda" else {}
        by_card = card_counts(names) if device == "cuda" else {}
        devs = [str(d) for d in be.devices]
        ov = int(sim.aux.overflow.sum())
        w = be.strip_geom.w if be.strip_geom is not None else None
        assert type(be.inner).__name__ == BRICK_INNERS[backend], be.inner
        assert sim.natoms == one.natoms
        assert ov == 0, ov
        if device == "cuda":
            # the default devices: every visible card, round-robin
            assert devs == [f"cuda:{b % ncards}" for b in range(4)], devs
        err = hold_bricks(label, a, b, L, rho_tol)
        print(f"  {label}: inner {type(be.inner).__name__}, procgrid "
              f"{sim.brick_spec.shape} over axes {sim.brick_spec.axes}, "
              f"bricks on {devs}, strip W {w}, halo rows "
              f"{be.halo_rows(sim.aux)}, rebuilds {sim.rebuilds}; max |dx| "
              f"{err['max_dx']:.3e}, |dv| {err['max_dv']:.3e}, rho rel "
              f"{err['rho_rel']:.3e}, e rel {err['e_rel']:.3e}; overflow "
              f"{ov}; launches by card {by_card}; {wall:.2f} s")
        fields[label] = b
        record["runs"][label] = dict(
            inner=type(be.inner).__name__, shape=sim.brick_spec.shape,
            devices=devs, strip_w=w, halo_rows=be.halo_rows(sim.aux),
            rebuilds=sim.rebuilds, launches=launches,
            launches_by_card=by_card, wall_s=wall, **err)
    if ncards > 1:
        # the same 4 strip bricks all on cuda:0: same kernels, builds and
        # geometry, so the across-cards run should match it to a few ulp
        sim, b, wall = brick_run(n, steps, "strip", 4, device=device,
                                 devices=["cuda:0"])
        read_counts(STRIP[:3])
        assert [str(d) for d in sim._runner.backend.devices] \
            == ["cuda:0"] * 4
        assert int(sim.aux.overflow.sum()) == 0
        err = hold_bricks("strip 4 across cards vs on cuda:0",
                          b, fields["strip 4"], L, 1e-4)
        print(f"  strip 4 across {ncards} cards vs all on cuda:0: max |dx| "
              f"{err['max_dx']:.3e}, |dv| {err['max_dv']:.3e}, rho rel "
              f"{err['rho_rel']:.3e}, e rel {err['e_rel']:.3e}; cuda:0 run "
              f"{wall:.2f} s")
        record["across_cards_vs_cuda0"] = dict(wall_cuda0_s=wall, **err)
    elif device == "cuda":
        print("  one card visible: the 4-brick runs above are all on "
              "cuda:0; the across-cards run would be the same run")
    if device == "cuda":
        record["cli_mesh4"] = cli_mesh_case()
    return record


def cli_mesh_case(name="heat_slab"):
    """``python -m tpusph_torch.cli run <script> --mesh 4`` on the card by
    default (cli.main, no --device): the golden run of ``name`` in four
    bricks, its thermo rows within the golden bar (phase 22's), the force
    kernel of the inner launched and no other. Returns its record."""
    import os
    import tempfile
    from tpusph_torch import cases as caselib
    spec = caselib.GOLDEN[name]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as out_dir:
        reset_counts()
        sim, log, wall = run_case_cli(f"{name}_mesh4",
                                      caselib.golden_script(name),
                                      spec["var"], out_dir,
                                      extra=("--mesh", "4"))
        header, rows = caselib.parse_log(log)
        _, gold = caselib.parse_log(os.path.join("tests", "golden",
                                                 f"log.{name}"))
        assert rows[-1, 0] == gold[-1, 0], rows[:, 0]
        errs = caselib.rows_within_bar(header, rows, gold)
    inner = type(sim._runner.backend.inner).__name__
    assert sim.device.type == "cuda" and len(sim.mesh) == 4
    launches = read_counts({"StripBackend": ("strip_force",),
                            "PallasBackend": ("column_force",)}[inner])
    share = max(e / a for e, a in errs.values() if a > 0)
    print(f"  cli --mesh 4, {name} (golden settings): {sim.natoms} atoms "
          f"in bricks {sim.brick_spec.shape} on {inner} on "
          f"{[str(d) for d in sim.mesh]}, golden rows "
          f"within the bar (largest share {share:.3g}), {wall:.1f} s")
    return dict(case=name, inner=inner, atoms=sim.natoms,
                devices=[str(d) for d in sim.mesh], bar_share=share,
                launches=launches, wall_s=wall)


def config5_run(sim, label, steps, out_dir):
    """One config 5 path (``run_bench``: warmup windows until one passes
    with no geometry re-choice, then ONE timed window of ``steps``) with
    the run-end Timer table written to a log in ``out_dir``; the boiling
    ledgers (phase_main's: owned mass drift <= 1e-6, momentum drift <=
    1e-4 of sum m|v0|, insertions > 0 with the vapour count and the
    liquid debit to match), overflow 0, every tag owned by exactly one
    brick and the owned rows summing to natoms. Records each card's peak
    memory (``torch.cuda.max_memory_allocated``, every visible card) and
    the host strip chooser's seconds. Returns (launches, launches by card,
    bench line)."""
    import os
    import numpy as np
    import torch
    cards = range(torch.cuda.device_count())
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    sim.log_path = os.path.join(out_dir, f"log.config5_{label}")
    n0 = sim.natoms
    bricks = sim.mesh is not None
    # one device: the column kernel (see phase_config5)
    launches, bench = phase_main(sim, "boiling", steps, 1,
                                 "strip" if bricks else "pallas")
    by_card = card_counts(launches)
    be = sim._runner.backend
    tags = sim.get("tag")
    owned = int((sim.state.alive & sim.state.owned).sum())
    assert len(np.unique(tags)) == len(tags) == owned == sim.natoms, (
        len(tags), owned, sim.natoms)
    assert sim.natoms == n0 + bench["insertions"]
    if bricks:
        cap = sim.local_cap
        per = [int((sim.state.alive & sim.state.owned)[b * cap:(b + 1) * cap]
                   .sum()) for b in range(len(sim.mesh))]
        assert sum(per) == sim.natoms, per
        bench["owned_per_brick"] = per
        bench["halo_rows"] = be.halo_rows(sim.aux)
        bench["brick_devices"] = [str(d) for d in be.devices]
        # every card the bricks used launched every strip kernel
        for s in STRIP:
            assert sorted(by_card[s]) == sorted(
                {d.index for d in be.devices}), (s, by_card[s])
    with open(sim.log_path) as f:
        lines = [ln.rstrip() for ln in f]
    # the timed window's table: the last one in the log
    last = max(i for i, ln in enumerate(lines) if ln.startswith("Loop time"))
    timer = [ln for ln in lines[last:] if "time (%)" in ln
             or ln.startswith("Loop time")]
    peak = {c: torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}
    bench.update(rebuilds=sim.rebuilds, timer=timer,
                 inner=type(be.inner).__name__ if bricks
                 else type(be).__name__, launches_by_card=by_card,
                 peak_mem_gib_by_card=peak, chooser_s=sim.chooser_s)
    print(f"  config 5 {label}: {bench['particles']} particles, "
          f"{bench['value']} particle-steps/s over {steps} steps (one "
          f"window), strip W {bench['strip_w']}, rebuilds "
          f"{bench['rebuilds']} (per timed window "
          f"{bench['rebuilds_per_window']}), re-choices "
          f"{bench['geometry_rechoices']}, events {bench['insertions']}, "
          f"launches {launches}, by card {by_card}, {bench['bricks']} "
          f"brick(s) on {bench['cards']} card(s), peak memory by card "
          f"{ {c: round(g, 3) for c, g in peak.items()} } GiB, host "
          f"chooser {sim.chooser_s:.1f} s, {bench['power_limit']} "
          f"{bench['device_name']}")
    for ln in timer:
        print(f"    {ln}")
    return launches, by_card, bench


def phase_config5(n=4_000_000, steps=20):
    """Phase 24: BASELINE.json config 5 (3D boiling at 2-4M particles, here
    its upper size) in the bench's `boiling` mode, on one device on the
    column kernel and in 4 bricks over every visible card (the strip in
    every brick), one warmup passing with no re-choice and one timed
    window of ``steps`` each (config5_run). One device cannot strip at 4M:
    the strip chooser's SMEM-budget reject, a TPU cost term kept for
    parity (ROADMAP, "Kept for parity"), refuses every strip candidate of
    a 159^3 box (its delta tables would take more than 512 KiB), and the
    reference's ladder takes the column kernel there too; each 4-brick box
    strips. The strip bricks' rate over the one-device column kernel's is
    recorded, not gated. Returns (brick launches, brick launches by card,
    record)."""
    import tempfile
    import torch
    from tpusph_torch.bench import build_bench_sim
    record = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c5_") as out_dir:
        sim = build_bench_sim(n, mode="boiling", device="cuda")
        print(f"  the bench's cube rounding: {sim.natoms} particles")
        _, _, record["one_device"] = config5_run(sim, "one", steps, out_dir)
        assert record["one_device"]["inner"] == "PallasBackend"
        del sim
        torch.cuda.empty_cache()
        sim = build_bench_sim(n, mode="boiling", device="cuda")
        sim.set_mesh(4)
        launches, by_card, record["bricks4"] = config5_run(
            sim, "bricks4", steps, out_dir)
        assert record["bricks4"]["inner"] == "StripBackend"
        assert record["bricks4"]["cards"] == min(
            4, torch.cuda.device_count())
        del sim
    ratio = record["bricks4"]["value"] / record["one_device"]["value"]
    record["strip_bricks4_over_one_device_column"] = ratio
    print(f"  strip in 4 bricks on {record['bricks4']['cards']} card(s) / "
          f"column kernel on one device: {ratio:.3f}")
    return launches, by_card, record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=50,
                    help="steps per timed window")
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpusph_torch.bench import build_bench_sim, card_info
    from tpusph_torch.ops import cuda_build

    nphases = 24
    count = iter(range(1, nphases + 1))

    def phase(title, fn, *a):
        print(f"[{next(count)}/{nphases}] {title}")
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        return out

    def device():
        name, limit = card_info()
        print(f"{name}, {limit}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"devices {torch.cuda.device_count()}")

    phase("device", device)
    lib = phase("build", cuda_build.load)
    print(lib.ptxas_log.strip())
    n = args.particles
    sim = build_bench_sim(n, mode="dynamic", device="cuda")
    reports = [phase(f"dynamic: sweeps vs plain on the initial layout at {n} "
                     "particles", hold_to_plain, sim, KERNELS[:3])]
    _, dynamic = phase("dynamic main path: run_bench", phase_main, sim,
                       "dynamic", args.steps, args.windows)
    reports.append(phase("dynamic: sweeps vs plain on the layout after the "
                         "main path", hold_to_plain, sim, KERNELS[:3], True))
    compact = {"dynamic": phase(
        "dynamic: the compacted force sweep's path, vs the strip force and "
        "vs plain on the layout after the main path", hold_compact, sim,
        "dynamic")}
    del sim
    sim, compact["uniform"] = phase(
        f"uniform: 5 steps at {n} particles, then the compacted force "
        "sweep's path, vs the strip force and vs plain", uniform_compact, n)
    _, uniform = phase("uniform main path: run_bench", phase_main, sim,
                       "uniform", args.steps, args.windows)
    del sim
    sim = build_bench_sim(n, mode="boiling", device="cuda")
    reports.append(phase(f"boiling: all four kernels vs plain on the initial "
                         f"layout at {n} particles", hold_to_plain, sim,
                         KERNELS))
    launches, boiling = phase("boiling main path: run_bench", phase_main,
                              sim, "boiling", args.steps, args.windows)
    # the kernels' times and bounds in the JSON line: the layout the
    # boiling path's timed windows launch them on
    last = phase("boiling: all four kernels vs plain on the layout after "
                 "the main path", hold_to_plain, sim, KERNELS, True)
    reports.append(last)
    del sim
    phase("slices: GPU kernels vs CPU plain versions", phase_slices)

    sim = build_bench_sim(n, mode="boiling", device="cuda", backend="pallas")
    col_reports = [phase(f"column: the three column kernels vs plain on the "
                         f"initial cell grid at {n} particles",
                         hold_cells_to_plain, sim, "column")]
    col_launches, column = phase(
        "column boiling main path: run_bench(backend=\"pallas\")",
        phase_main, sim, "boiling", args.steps, args.windows, "pallas")
    col_last = phase("column: kernels vs plain on the cell grid after the "
                     "main path", hold_cells_to_plain, sim, "column", True)
    col_reports.append(col_last)
    column["vapor_query_ms"] = col_last["vapor_query_ms"]
    del sim
    phase("column slice: GPU kernels vs CPU plain versions", bubble_slice,
          "pallas")

    sim = build_bench_sim(n, mode="dynamic", device="cuda", backend="band")
    band_reports = [phase(f"band: the three band kernels vs plain on the "
                          f"initial slot layout at {n} particles",
                          hold_cells_to_plain, sim, "band")]
    band_launches, band = phase(
        "band dynamic main path: run_bench(backend=\"band\")", phase_main,
        sim, "dynamic", args.steps, args.windows, "band")
    band_last = phase("band: kernels vs plain on the slot layout after the "
                      "main path", hold_cells_to_plain, sim, "band", True)
    band_reports.append(band_last)
    del sim
    phase("band slice: GPU kernels vs CPU plain versions", dynamic_slice,
          "band")
    phase("ladder: cannot strip -> column kernel; abandon -> column or band "
          "-> strip retry", phase_ladder)
    case_record = phase("cases: the five scripts through tpusph_torch.cli "
                        "(golden rows; heat_slab dx 0.02; bubble_rise dx "
                        "0.01)", phase_cases)
    ncards = torch.cuda.device_count()
    where = "on the one card" if ncards == 1 else f"over {ncards} cards"
    bricks_small = phase(f"bricks: 4 bricks {where} vs one device, strip / "
                         "column / cell-grid inners and a 2 x 2 procgrid "
                         "(dynamic, 48^3, 30 steps)", phase_bricks_small)
    brick_launches, brick_cards, config5 = phase(
        "config 5: boiling at 4M particles on one device (column kernel) "
        f"and in 4 bricks {where}", phase_config5)

    kernels = []
    for s in KERNELS:
        key = f"strip_{s}"
        # the boiling path's launches and config 5's brick path's
        kernels.append(dict(
            name=f"{key}_sweep", route="cuda", source=SOURCES["strip"],
            replaces=REPLACES[key],
            launches=launches[key] + brick_launches[key],
            launches_bricks=brick_launches[key],
            launches_bricks_by_card=brick_cards[key], library_ms=None,
            **{**last[s], "max_abs_err": max(
                r[s]["max_abs_err"] for r in reports if s in r)}))
    for kind, counts, after, reps in (
            ("column", col_launches, col_last, col_reports),
            ("band", band_launches, band_last, band_reports)):
        for s in ("rho", "cgrad", "force"):
            key = f"{kind}_{s}"
            kernels.append(dict(
                name=f"{key}_sweep", route="cuda", source=SOURCES[kind],
                replaces=REPLACES[key], launches=counts[key],
                library_ms=None, **{**after[s], "max_abs_err": max(
                    r[s]["max_abs_err"] for r in reps)}))
    # on no path of Simulation: its path is the prototype's (phases 6-7);
    # top-level numbers from the `dynamic` layout (W 384), the case the
    # design is for, and both layouts beside them
    kernels.append(dict(
        name="compact_force_sweep", route="cuda", source=SOURCES["compact"],
        replaces=REPLACES["compact_force"], library_ms=None,
        **{**compact["dynamic"],
           "launches": sum(r["launches"] for r in compact.values()),
           "max_abs_err": max(r["max_abs_err"] for r in compact.values())},
        layouts=compact))
    print(json.dumps(dynamic))
    print(json.dumps(uniform))
    print(json.dumps(boiling))
    print(json.dumps(column))
    print(json.dumps(band))
    print(json.dumps({"cases": case_record}))
    print(json.dumps({"bricks_small": bricks_small}))
    print(json.dumps({"config5": config5}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
