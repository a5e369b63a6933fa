#!/usr/bin/env python3
"""Smoke test of the torch port (tpusph_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the 1M-particle bench, as checked in CI

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device  — a CUDA device must exist; prints nvidia-smi's name and
               power limit.
  2. build   — compiles csrc/strip_sweeps.cu with nvcc (sm_90a) and loads it.
  3. kernels — on the bench `dynamic` state after the initial strip build,
               runs each of the rho / colour-gradient / force sweeps through
               its CUDA kernel and its plain PyTorch version, checks the
               largest difference of each output row against a stated
               tolerance, and times both with CUDA events.
  4. main    — resets the kernels' launch counts, runs the bench
               (tpusph_torch.bench.run_bench: Simulation.run with warmup and
               timed windows), reads the counts, and checks every kernel
               was launched, no overflow, all fields finite, owned mass
               conserved and the momentum drift bounded.
  5. slice   — the 16^3 bench slice for 20 steps on the GPU (kernels) and
               on the CPU (plain versions): the results must agree.
Prints one JSON line of the kernels, the bench JSON line, and as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# tolerance of a kernel output row against its plain version: largest
# absolute difference over the largest magnitude of the plain row (sums in
# another order, float32; the physics is held to 2e-4 elsewhere, rho to
# 2e-5)
KERNEL_RTOL = {"rho": 2e-5, "cgrad": 2e-4, "force": 2e-4}
SOURCE = "tpusph_torch/csrc/strip_sweeps.cu"
REPLACES = "tpusph/ops/strip_pair.py:1106"


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


def phase_kernels(sim, reps=10):
    """Kernel vs plain version of each sweep on the state after init_aux,
    fed as the force stage feeds them (rho patched before cgrad, cg before
    force)."""
    import torch
    from tpusph_torch.ops import strip_pair
    from tpusph_torch.ops.band_pair import pack_fields
    from tpusph_torch.ops.pallas_pair import (
        OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RCGZ, RRHO)

    backend = sim._ensure_runner().backend
    geom, spec = backend.geom, sim.spec
    sim._build_state()
    state, aux = backend.init_aux(sim.state, sim.box)
    tabs = sim.tables.stacked(sim.device)
    fld = pack_fields(state, aux.mix)
    rows = {"rho": (ORHO,), "cgrad": (OCGX, OCGY, ODE),
            "force": (OFX, OFY, OFZ, ODRHO, ODE)}
    alive = state.alive
    report = {}
    for sweep in ("rho", "cgrad", "force"):
        kern = strip_pair.SWEEPS[sweep]

        def run_kernel():
            return kern(fld, tabs, backend.win, aux.delta, geom, spec)

        def run_plain():
            return strip_pair.plain_sweep(sweep, fld, tabs, backend.win,
                                          aux.delta, geom, spec)

        out_k = run_kernel()
        out_p = run_plain()
        torch.cuda.synchronize()
        errs = []
        for r in rows[sweep]:
            a, b = out_k[r][alive], out_p[r][alive]
            assert torch.isfinite(a).all(), f"{sweep} row {r}: non-finite"
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            errs.append(err)
            print(f"  {sweep} row {r}: max_abs_err {err:.3e} max|plain| "
                  f"{scale:.3e} rel {err / max(scale, 1e-30):.3e} "
                  f"(tolerance {KERNEL_RTOL[sweep]:.0e})")
            assert err <= KERNEL_RTOL[sweep] * scale, (sweep, r, err, scale)
        ms = cuda_ms(run_kernel, reps)
        plain_ms = cuda_ms(run_plain, 1)
        print(f"  {sweep}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        report[sweep] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
        if sweep == "rho":
            total = out_p[ORHO] * state.rmass if spec.rhosum_nd \
                else out_p[ORHO]
            fld[RRHO] = torch.where(alive, total, fld[RRHO])
        elif sweep == "cgrad":
            cg = torch.stack([out_p[OCGX], out_p[OCGY], out_p[ODE]])
            fld[RCGX:RCGZ + 1] = torch.where(alive, cg, 0.0)
    return report


def owned_totals(sim):
    """(total owned mass, momentum vector, sum of m|v|) in float64."""
    import torch
    st = sim.state
    own = st.alive & st.owned
    m = torch.where(own, st.rmass, 0.0).double()
    p = (m[:, None] * st.v.double()).sum(0)
    return (float(m.sum()), p.cpu().numpy(),
            float((m * st.v.double().norm(dim=1)).sum()))


def phase_main(sim, steps, windows):
    import numpy as np
    import torch
    from tpusph_torch.bench import run_bench
    from tpusph_torch.ops import strip_pair

    sim._build_state()
    mass0, p0, mv0 = owned_totals(sim)
    for k in strip_pair.SWEEPS.values():
        k.launches = 0
    bench = run_bench(sim=sim, n_steps=steps, n_windows=windows)
    launches = {s: k.launches for s, k in strip_pair.SWEEPS.items()}
    print(f"  launches on the main path: {launches}")
    for s, n in launches.items():
        assert n > 0, f"{s} kernel never launched on the main path"
    assert int(sim.aux.overflow.sum()) == 0, "overflow at the end"
    st = sim.state
    for name in ("x", "v", "vest", "f", "rho", "drho", "e", "de"):
        assert torch.isfinite(getattr(st, name)).all(), f"{name} not finite"
    assert sim.natoms == bench["particles"]
    mass1, p1, _ = owned_totals(sim)
    dmass = abs(mass1 - mass0) / mass0
    dp = float(np.abs(p1 - p0).max()) / mv0
    print(f"  owned mass drift {dmass:.3e} (bound 1e-6); momentum drift "
          f"{dp:.3e} of sum m|v0| (bound 1e-4)")
    assert dmass <= 1e-6, dmass
    assert dp <= 1e-4, dp
    return launches, bench


def phase_slice():
    """The CPU test's slice (tests/test_torch_slice.py) on the GPU against
    the plain versions on the CPU."""
    import numpy as np
    from tpusph_torch.bench import build_bench_sim

    sims = {}
    for dev in ("cuda", "cpu"):
        sim = build_bench_sim(4096, mode="dynamic", device=dev)
        sim._staged["x"] += 0.5
        sim.reneigh_every = 5
        sim.run(20)
        sims[dev] = sim
    for field in ("rho", "e", "v", "x"):
        a, b = sims["cpu"].get(field), sims["cuda"].get(field)
        d = b - a
        if field == "x":
            d -= 16.0 * np.round(d / 16.0)
        err = float(np.abs(d).max())
        print(f"  slice {field}: max |gpu - cpu| {err:.3e} (bound 5e-5)")
        assert err <= 5e-5, (field, err)


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

    print("[1/5] device")
    name, limit = card_info()
    print(f"{name}, {limit}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    print("[2/5] build")
    t0 = time.perf_counter()
    lib = cuda_build.load()
    print(f"  built and loaded in {time.perf_counter() - t0:.1f} s")
    print(lib.ptxas_log.strip())

    print(f"[3/5] kernels vs plain at {args.particles} particles")
    t0 = time.perf_counter()
    sim = build_bench_sim(args.particles, mode="dynamic", device="cuda")
    report = phase_kernels(sim)
    print(f"  ({time.perf_counter() - t0:.1f} s)")

    print("[4/5] main path: tpusph_torch.bench.run_bench")
    t0 = time.perf_counter()
    launches, bench = phase_main(sim, args.steps, args.windows)
    print(f"  ({time.perf_counter() - t0:.1f} s)")

    print("[5/5] 16^3 slice: GPU kernels vs CPU plain versions")
    t0 = time.perf_counter()
    phase_slice()
    print(f"  ({time.perf_counter() - t0:.1f} s)")

    kernels = [dict(name=f"strip_{s}_sweep", route="cuda", source=SOURCE,
                    replaces=REPLACES, launches=launches[s], **report[s])
               for s in ("rho", "cgrad", "force")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(bench))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
