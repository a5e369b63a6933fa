"""Where the time goes in one timed bench window on the card.

    python -m tpusph_torch.profile_step --mode boiling [--backend pallas]
                                        [--particles N]
    python -m tpusph_torch.profile_step --mode dynamic --backend band
    python -m tpusph_torch.profile_step --mode boiling --particles 2000000 \
                                        --steps 20 --mesh 4

Builds the bench (``tpusph_torch.bench``), warms it up as ``run_bench``
does, then runs one window of ``--steps`` steps under ``torch.profiler``
and prints, as one JSON line: the window's wall time, the device time of
each hand-written kernel (launches, total and mean ms), the device time of
all other device work (both summed over the cards), the device idle
share, and the window's rebuilds and phase-change insertions.
``--backend`` is the simulation's ``backend_name`` (``auto``: the strip;
``band``: the band backend, for a run without phase change; ``pallas``:
the column kernel on the cell grid); ``--mesh N`` runs the bench in N
bricks over every visible card (``Simulation.set_mesh``; one card: all N
on it). ``cards`` gives each card's busy time, idle share (wall time
not covered by its device work) and device launches (kernels, copies
excluded); ``device_idle_share`` is the largest idle share of the cards.
The line also carries the host ops that took the most host time
in the window (``host_top``: self time by op, host waits on the device
included). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch
from torch.autograd import DeviceType

from tpusph_torch.bench import (build_bench_sim, card_info, run_bench,
                                run_devices, sync)

# the hand-written kernels by their names in tpusph_torch.ops.all_kernels;
# a sweep kernel's template argument is the Sweep enum (rho 0, cgrad 1,
# force 2); the three strip sweeps are strip_filter_kernel, whose second
# template argument is its blocks per SM; the three column and the three
# band sweeps are cell_sweep_kernel<sweep, layout (column 0, band 1),
# blocks per SM>; every one-pass strip_sweep_kernel, column_sweep_kernel
# and band_sweep_kernel is a check kernel {strip,column,band}_{sweep}_scan;
# the vapor sweep is strip_vapor_filter_kernel, its one-pass check kernel
# strip_vapor_scan_kernel; the compacted force sweep (on no path of
# Simulation) is compact_filter_kernel, its check kernel compact_scan_kernel
SWEEPS = ("rho", "cgrad", "force")
LAYOUTS = ("column", "band")
KERNEL_NAMES = tuple(f"{b}_{s}" for b in ("strip", "column", "band")
                     for s in SWEEPS) + ("strip_vapor",) + tuple(
    f"{b}_{s}_scan" for b in LAYOUTS for s in SWEEPS) + (
    "strip_cgrad_scan", "strip_vapor_scan", "compact_force",
    "compact_force_scan")
_SWEEP = re.compile(
    r"(strip|column|band)_(sweep|filter)_kernel<(?:\(int\))?(\d)[,>]")
_CELL_SWEEP = re.compile(
    r"cell_sweep_kernel<(?:\(int\))?(\d),\s*(?:\(int\))?(\d)[,>]")
_VAPOR = re.compile(r"strip_vapor_(filter|scan)_kernel")
_COMPACT = re.compile(r"compact_(filter|scan)_kernel")


def _kernel_of(name: str) -> str | None:
    m = _VAPOR.search(name)
    if m:
        return "strip_vapor" if m.group(1) == "filter" else "strip_vapor_scan"
    m = _COMPACT.search(name)
    if m:
        return "compact_force" if m.group(1) == "filter" \
            else "compact_force_scan"
    m = _CELL_SWEEP.search(name)
    if m:
        return f"{LAYOUTS[int(m.group(2))]}_{SWEEPS[int(m.group(1))]}"
    m = _SWEEP.search(name)
    if not m:
        return None
    kind, sweep = m.group(1), SWEEPS[int(m.group(3))]
    return f"{kind}_{sweep}" if m.group(2) == "filter" \
        else f"{kind}_{sweep}_scan"


def per_card(prof, indices, wall_s: float) -> dict:
    """{card index: busy ms, idle share, launches} over the profiled
    window's device events: busy is every device event's time on the card
    (kernels and copies), launches its kernels (copies and memsets
    excluded)."""
    cards = {i: dict(busy_ms=0.0, launches=0) for i in indices}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        c = cards.setdefault(evt.device_index,
                             dict(busy_ms=0.0, launches=0))
        c["busy_ms"] += evt.time_range.elapsed_us() / 1e3
        if not evt.name.startswith(("Memcpy", "Memset")):
            c["launches"] += 1
    for c in cards.values():
        c["idle_share"] = max(0.0, 1.0 - c["busy_ms"] / (1e3 * wall_s))
    return cards


def profile_window(mode: str, n_particles: int, steps: int,
                   backend: str = "auto", mesh: int = 0) -> dict:
    sim = build_bench_sim(n_particles, mode=mode, backend=backend)
    if mesh:
        sim.set_mesh(mesh)
    warm = run_bench(sim=sim, n_steps=steps, n_windows=1, mode=mode,
                     backend=backend)
    nb0 = sim.rebuilds
    n0 = sim.natoms
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run(steps)
        sync(sim)
        wall = time.perf_counter() - t0
    kernels = {short: dict(launches=0, ms=0.0) for short in KERNEL_NAMES}
    other_ms = 0.0
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are device events of their own
        dev_us = evt.device_time_total
        short = _kernel_of(evt.key)
        if short is None:
            other_ms += dev_us / 1e3
        else:
            kernels[short]["launches"] += evt.count
            kernels[short]["ms"] += dev_us / 1e3
    for k in kernels.values():
        k["mean_ms"] = k["ms"] / k["launches"] if k["launches"] else None
    busy_ms = sum(k["ms"] for k in kernels.values()) + other_ms
    cards = per_card(prof, [d.index or 0 for d in run_devices(sim)
                            if d.type == "cuda"], wall)
    name, limit = card_info()
    return dict(mode=mode, particles=n0, steps=steps, wall_ms=1e3 * wall,
                kernels=kernels, other_device_ms=other_ms,
                device_busy_ms=busy_ms,
                device_idle_share=max(c["idle_share"] for c in cards.values()),
                cards=cards,
                rebuilds=sim.rebuilds - nb0,
                insertions=sim.natoms - n0,
                backend=warm["backend"], strip_w=warm["strip_w"],
                cell_cap=warm["cell_cap"],
                band_geometry=warm["band_geometry"],
                warmup_psps=warm["value"], mesh=mesh,
                host_top=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                          for e in host],
                device_name=name, power_limit=limit)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="dynamic",
                    choices=("uniform", "dynamic", "boiling"))
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "band", "pallas"))
    ap.add_argument("--mesh", type=int, default=0,
                    help="run in this many bricks over every visible card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    print(json.dumps(profile_window(args.mode, args.particles, args.steps,
                                    args.backend, args.mesh)))


if __name__ == "__main__":
    main()
