"""One run of one cell: set-up, the timed window, the traced extras and
the check, by the names in ``BENCHMARK.json``.

Everything that belongs to one cell, configuration or metric is found by
name: ``workloads/<cell>.json`` (the traffic: the backend, the bricks,
the steps per call and the limits of the check), ``configs/<config>.json``
(the scene and its physics) and ``metrics/<metric>.py`` (a reader per
per-layer metric).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from sphbench import check, pairs, scene, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# warm-up calls at most: until one passes with no geometry re-choice
WARMUP_MAX = 8
# the traced extra window after the timed one, at least this long
PROFILE_SECONDS = 3.0
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusph")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(benchmark, cell entry, workload file, configuration file)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    work = load_json(HERE / "workloads" / f"{name}.json")
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    return bench, cell, work, cfg


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "sphbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` (end_to_end or per_layer) that
    ``cell`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(__import__("sys").modules)}
                  & set(FORBIDDEN))


def run_devices(sim) -> list:
    return list(dict.fromkeys(sim.mesh)) if sim.mesh else [sim.device]


def sync(sim):
    for dev in run_devices(sim):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def rechoices(sim) -> int:
    """Geometry re-choices so far: escalations after a violation and
    de-escalations by margin decay (the counters ``run_bench`` reads)."""
    return sim._strip_violations + sim._strip_decays


def memory_peak(sim) -> int:
    return max((torch.cuda.max_memory_allocated(d)
                for d in run_devices(sim) if d.type == "cuda"), default=0)


def pair_counts(sim, cfg) -> dict:
    """``pairs.count`` on the owned particles, on the run's first device."""
    dev = run_devices(sim)[0]
    x = torch.as_tensor(sim.get("x"), device=dev)
    typ = torch.as_tensor(sim.get("type"), device=dev)
    length = cfg["per_side"] * cfg["dx"]
    x = torch.remainder(x, length)
    out = pairs.count(x, typ, [length] * 3, cfg["h"])
    del x, typ
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def timed_window(sim, k: int, seconds: float, timer: bool) -> dict:
    """Calls of ``sim.run(k)``, each ended by a synchronize of every device
    the run uses, until ``seconds`` have passed: all the work (alive
    particles at each call's start times k) over all the time from the
    window's start to the last call's end."""
    rec = dict(calls=0, steps=0, work=0, timer={} if timer else None,
               timer_steps=0, call_s=[], call_rechoices=[],
               call_rebuilds=[], call_particles=[])
    rc0, nb0 = rechoices(sim), sim.rebuilds
    nb = nb0
    n = sim.natoms
    t0 = time.perf_counter()
    t = t0
    while True:
        rc = rechoices(sim)
        sim.run(k)
        sync(sim)
        t_prev, t = t, time.perf_counter()
        rec["call_s"].append(t - t_prev)
        rec["call_rechoices"].append(rechoices(sim) - rc)
        nb_prev, nb = nb, sim.rebuilds
        rec["call_rebuilds"].append(nb - nb_prev)
        rec["call_particles"].append(n)
        rec["calls"] += 1
        rec["steps"] += k
        rec["work"] += n * k
        if timer:
            pt = sim._runner.phase_times or {}
            for name, s in pt.items():
                rec["timer"][name] = rec["timer"].get(name, 0.0) + s
            rec["timer_steps"] += sim._runner.ok_steps if pt else 0
        n = sim.natoms
        if t - t0 >= seconds:
            break
    rec["wall_s"] = t - t0
    rec["rate"] = rec["work"] / rec["wall_s"]
    rec["rechoices"] = rechoices(sim) - rc0
    rec["rebuilds"] = sim.rebuilds - nb0
    return rec


def profiled_window(sim, k: int, cards) -> dict:
    """Calls of ``sim.run(k)`` under ``torch.profiler`` for at least
    PROFILE_SECONDS, reduced by ``trace.reduce``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in run_devices(sim)):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    steps = 0
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                sim.run(k)
                sync(sim)
                steps += k
                if time.perf_counter() - t0 >= PROFILE_SECONDS:
                    break
    events, a, b = trace.events_of(prof)
    out = trace.reduce(events, a, b, cards)
    out["steps"] = steps
    return out


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc}"}
    return {"nvidia_smi": text.splitlines()}


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             t_process0: float, device: str = "cuda", control: bool = False,
             spec=None, log=print) -> dict:
    """One run; returns the result line's object. ``control`` puts the
    bfloat16 reference in the program's place in the check. For the tests:
    ``device`` may be the CPU, and ``spec`` gives (benchmark, cell,
    workload, configuration) in place of the files."""
    bench, cell, work, cfg = spec or load_cell(cell_name)
    inputs = scene.make_inputs(cfg, seed)
    sim = scene.build_sim(cfg, inputs, seed, device, work["backend"])
    t_c = time.perf_counter()
    numbers = check.start_numbers(sim, inputs)
    t_start_check = time.perf_counter() - t_c
    if work.get("bricks"):
        # the bricks go round-robin over the cards the cell asks for
        devices = ([torch.device("cuda", b % cell["chips"])
                    for b in range(work["bricks"])]
                   if device == "cuda" else None)
        sim.set_mesh(work["bricks"], devices=devices)
    log_path = None
    if traced:
        # the Timer table is on where a loop summary is written
        log_path = os.path.join(tempfile.gettempdir(),
                                f"sphbench-{cell_name}.log")
        sim.log_path = log_path
    k = int(work["steps_per_call"])
    sim.run(k)
    sync(sim)
    warm = 1
    prev = -1
    while warm < WARMUP_MAX and rechoices(sim) != prev:
        prev = rechoices(sim)
        sim.run(k)
        sync(sim)
        warm += 1
    cards = [d.index or 0 for d in run_devices(sim)]
    counts = {}
    peak0 = 0
    t_count = 0.0
    if traced:
        peak0 = memory_peak(sim)
        t_c = time.perf_counter()
        counts["start"] = pair_counts(sim, cfg)
        t_count = time.perf_counter() - t_c
        for d in run_devices(sim):
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
    t_window = time.perf_counter()
    setup_s = t_window - t_process0 - t_start_check - t_count
    rec = timed_window(sim, k, seconds, timer=traced)
    prof = profiled_window(sim, k, cards) if traced else None
    peak = max(peak0, memory_peak(sim))
    peak_by_card = [torch.cuda.max_memory_allocated(d)
                    for d in run_devices(sim) if d.type == "cuda"]
    if traced:
        counts["end"] = pair_counts(sim, cfg)
    info = dict(cell=cell_name, seed=seed, backend=type(
        sim._runner.backend).__name__, bricks=len(sim.mesh or [1]),
        cards=len(cards), warmup_calls=warm, chooser_s=sim.chooser_s,
        particles_end=sim.natoms, memory_peak_bytes=peak,
        memory_peak_by_card=peak_by_card,
        window={k2: v for k2, v in rec.items()}, pairs=counts,
        setup_s=setup_s, start_check_s=t_start_check, pair_count_s=t_count)
    if prof is not None:
        info["profile"] = {k2: v for k2, v in prof.items()}
    # the check: one more step of the window's entry, from the state the
    # window left
    pc = cfg.get("phase_change")
    if pc and sim.step_count % pc["every"]:
        sim.run(pc["every"] - sim.step_count % pc["every"])
    istep = sim.step_count
    firing = bool(pc) and istep % pc["every"] == 0
    snap_s = check.snapshot(sim)
    sim.run(1)
    sync(sim)
    snap_p = check.snapshot(sim)
    chooser_s = sim.chooser_s
    del sim
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers.update(check.ledger_numbers(snap_p, inputs))
    ref_dev = torch.device(device)
    t_c = time.perf_counter()
    ref = check.Reference(cfg, snap_s, torch.float64, ref_dev)
    if control:
        cand = check.control_candidate(cfg, snap_s, snap_p, seed, istep,
                                       ref_dev)
    else:
        cand = check.program_candidate(snap_s, snap_p, ref)
    numbers.update(check.step_numbers(ref, cand, snap_p, seed, istep,
                                      firing))
    info["check_s"] = time.perf_counter() - t_c
    info["check_firing"] = firing
    del ref, cand
    correct, table = check.judge(numbers, work["correct"])
    if log_path and os.path.exists(log_path):
        os.remove(log_path)

    # what the metrics' readers read (metrics/<name>.py)
    ctx = dict(cell=cell_name, chips=cell["chips"], cards=len(cards),
               bricks=info["bricks"], setup_s=setup_s, window=rec,
               chooser_s=chooser_s,
               profile=prof, pairs=counts or None)
    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in cell_metrics(bench, cell_name, kind):
        val = metric_reader(m["name"]).read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    log(json.dumps({"info": info}, default=str))
    # a call that fails raises: every call counted here completed
    result = {"correct": bool(correct), "attempted": rec["calls"],
              "failed": 0, "metrics": metrics,
              "device": dict(
                  platform="gpu" if device == "cuda" else device,
                  kind=(torch.cuda.get_device_name(0)
                        if device == "cuda" else device),
                  count=len(cards), memory_peak_bytes=int(peak))}
    if traced and prof is not None:
        busy = [c["busy_s"] for c in prof["cards"].values()]
        result["device"]["busy_s"] = sum(busy) / len(busy)
        result["device"]["window_s"] = prof["wall_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = table
    return result
