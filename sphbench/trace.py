"""Reduction of a ``torch.profiler`` trace of a window to what the
per-layer metrics and the result line read: each card's busy time (the
union of its device operations' intervals), the device time of the
program's hand-written kernels by name, the device operations that took
the most time, and the idle gaps of the busiest-idle card by what the
host was doing.

The kernel names are mapped as ``tpusph_torch/profile_step.py`` maps them
(a copy of its ``_kernel_of``): a sweep kernel's template argument is the
sweep (rho 0, colour gradient 1, force 2); the strip sweeps are
``strip_filter_kernel``; the column and band sweeps
``cell_sweep_kernel<sweep, layout (column 0, band 1), ...>``; the vapor
query ``strip_vapor_filter_kernel``; one-pass ``*_sweep_kernel`` and
``*_scan_kernel`` are check kernels.
"""

from __future__ import annotations

import bisect
import re

SWEEPS = ("rho", "cgrad", "force")
LAYOUTS = ("column", "band")
FORCE_KERNELS = ("strip_force", "column_force", "band_force")
_SWEEP = re.compile(
    r"(strip|column|band)_(sweep|filter)_kernel<(?:\(int\))?(\d)[,>]")
_CELL_SWEEP = re.compile(
    r"cell_sweep_kernel<(?:\(int\))?(\d),\s*(?:\(int\))?(\d)[,>]")
_VAPOR = re.compile(r"strip_vapor_(filter|scan)_kernel")
_COMPACT = re.compile(r"compact_(filter|scan)_kernel")
# idle gaps shorter than this are launch spacing, not host work
GAP_MIN_US = 20.0


def kernel_of(name: str) -> str | None:
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


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events, t0_us: float, t1_us: float, cards) -> dict:
    """``events``: (is_device, card, name, start_us, end_us, top_level) of
    every profiled event; [t0_us, t1_us] the traced window on the same
    clock; ``cards`` the device indices the run used. Returns busy_s and
    idle_share per card, the hand kernels' device seconds and launches,
    the top device operations and the idle gaps by host operation."""
    wall = (t1_us - t0_us) / 1e6
    dev_iv = {c: [] for c in cards}
    by_name, kernels = {}, {}
    host = []
    for is_dev, card, name, a, b, top in events:
        if is_dev:
            a, b = max(a, t0_us), min(b, t1_us)
            if b <= a:
                continue
            dev_iv.setdefault(card, []).append((a, b))
            short = kernel_of(name)
            key = short or name[:80]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
            if short:
                k = kernels.setdefault(short, dict(s=0.0, launches=0))
                k["s"] += (b - a) / 1e6
                k["launches"] += 1
        elif top:
            host.append((a, b, name))
    merged = {c: _union(iv) for c, iv in dev_iv.items()}
    per_card = {}
    for c, iv in merged.items():
        busy = sum(b - a for a, b in iv) / 1e6
        per_card[c] = dict(busy_s=busy,
                           idle_share=max(0.0, 1.0 - busy / wall))
    worst = max(per_card, key=lambda c: per_card[c]["idle_share"])
    gaps = []
    prev = t0_us
    for a, b in merged[worst] + [[t1_us, t1_us]]:
        if a - prev >= GAP_MIN_US:
            gaps.append((prev, a))
        prev = max(prev, b)
    host.sort()
    starts = [h[0] for h in host]
    by_host = {}
    for ga, gb in gaps:
        covered = 0.0
        k = max(bisect.bisect_right(starts, ga) - 1, 0)
        # top-level host operations never overlap one another
        while k < len(host) and host[k][0] < gb:
            a, b, name = host[k]
            ov = min(b, gb) - max(a, ga)
            if ov > 0:
                by_host[name] = by_host.get(name, 0.0) + ov / 1e6
                covered += ov
            k += 1
        rest = (gb - ga) - covered
        if rest > 0:
            by_host["(host outside any op)"] = \
                by_host.get("(host outside any op)", 0.0) + rest / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, cards=per_card, kernels=kernels,
                device_ops=top(by_name), idle_gaps=top(by_host),
                idle_card=worst)


WINDOW_SPAN = "sphbench.traced_window"


def events_of(prof):
    """(events, t0_us, t1_us) of a finished ``torch.profiler.profile``
    whose window ran inside a ``record_function(WINDOW_SPAN)``: the
    (is_device, card, name, start_us, end_us, top_level) tuples, top level
    meaning a host operation directly under the window's span."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    span = [e for e in evs if e.name == WINDOW_SPAN]
    if not span:
        raise RuntimeError("the profile holds no window span")
    t0, t1 = float(span[0].time_range.start), float(span[0].time_range.end)
    out = []
    for e in evs:
        if e.name == WINDOW_SPAN:
            continue
        tr = e.time_range
        is_dev = e.device_type == DeviceType.CUDA
        parent = e.cpu_parent
        top = (not is_dev) and (parent is None or parent.name == WINDOW_SPAN)
        out.append((is_dev, e.device_index if is_dev else -1, e.name,
                    float(tr.start), float(tr.end), top))
    return out, t0, t1
