"""Time shapes of the compacted force kernel against the committed one, on
the card.

    python -m tpusph_torch.compact_shapes [--particles N]

``csrc/compact_force.cu``'s filtered kernel has three shape constants:
``kRowsPerThread`` (window rows a thread tests a compaction step),
``kStage`` (staged rows a chunk) and ``kFilterBlocks`` (its
``__launch_bounds__`` blocks an SM, which caps its registers). This builds
the source once per shape of ``SHAPES`` with those constants replaced (one
``nvcc`` each, in parallel, into ``tpusph_torch/_build/``), takes the
layouts ``chip_smoke.py`` holds the kernel on — the 1M ``dynamic`` bench
after its path (3 timed windows of 50 steps) and ``uniform`` after 5
steps — and times each shape against the committed one by CUDA events in
turns (committed, shape, shape, committed), each output held bit for bit to
the one-pass check kernel on rows 0-4 of every alive row. It also builds
the committed shape with ``clock64()`` counters around the chunk sums
(barriers included) and reports their share of a thread's cycles. Prints
one JSON line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from tpusph_torch import proto_mxu_compact as proto
from tpusph_torch.bench import build_bench_sim, card_info, run_bench
from tpusph_torch.ops import cuda_build, mxu_compact
from tpusph_torch.ops.rows import OCGX, ODE, ODRHO, OFX, OFY, OFZ, ORHO

CONSTS = ("kRowsPerThread", "kStage", "kFilterBlocks")
# (kRowsPerThread, kStage, kFilterBlocks) of each shape timed
SHAPES = ((2, 256, 8), (1, 256, 8), (4, 256, 8), (2, 256, 6), (2, 160, 10),
          (1, 160, 10), (1, 192, 9), (2, 128, 12), (1, 128, 12),
          (2, 128, 11), (2, 144, 11), (1, 96, 13))
# lines of the committed kernel's text and what replaces each: cycle
# counters around the chunk sums, written to output rows ORHO (cycles
# outside them) and OCGX (inside)
_PAR = "  int par = 0;     // which s_cnt row this step writes\n"
_FULL = ("        // (b) the chunk, staged before this step's barrier, is "
         "full\n")
_EMPTY = "        staged = 0;\n"
_LAST = "  __syncthreads();  // the last chunk is staged\n"
_WRITE = "  if (has_i) write_rows(out, n, i, acc, max(found - P, 0));\n"
SPLIT = ((_PAR, _PAR + "  long long tsum = 0, t0 = clock64(), ts0 = 0;\n"),
         (_FULL, _FULL + "        ts0 = clock64();\n"),
         (_EMPTY, "        tsum += clock64() - ts0;\n" + _EMPTY),
         (_LAST, "  ts0 = clock64();\n" + _LAST),
         (_WRITE, "  tsum += clock64() - ts0;\n" + _WRITE
          + "  if (has_i) {\n"
          + "    out[ORHO * n + i] = (float)(clock64() - t0 - tsum);\n"
          + "    out[OCGX * n + i] = (float)tsum;\n  }\n"))


def committed_shape() -> tuple:
    text = cuda_build.SOURCES["compact"].read_text()
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", text)
                     .group(1)) for c in CONSTS)


def _source(shape=None, split=False) -> str:
    """The kernel's source with the shape's constants, or (``split``) the
    committed one with the cycle counters."""
    text = cuda_build.SOURCES["compact"].read_text()
    for const, v in zip(CONSTS, shape or ()):
        pat = re.compile(rf"constexpr int {const} = \d+;")
        assert pat.search(text), const
        text = pat.sub(f"constexpr int {const} = {v};", text)
    if split:
        head, body = text.split("compact_filter_kernel(const float", 1)
        for line, new in SPLIT:
            assert line in body, line
            body = body.replace(line, new, 1)
        text = head + "compact_filter_kernel(const float" + body
    return text


def build(variants: dict) -> dict:
    """{name: (library handle, registers, spill stores)} of each variant
    source, built in parallel."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = cuda_build.SOURCES["compact"].parent
    procs = {}
    for name, text in variants.items():
        src = cuda_build.BUILD_DIR / f"compact_shape_{name}.cu"
        src.write_text(text)
        so = src.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
             "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on shape {name}:\n{err}")
        handle = ctypes.CDLL(str(so))
        cuda_build._bind("compact", handle)
        out[name] = (handle, *cuda_build.kernel_resources(
            log + err, "compact_filter_kernel"))
    return out


def layouts(n: int) -> dict:
    sim = build_bench_sim(n, mode="dynamic", device="cuda")
    run_bench(sim=sim, n_steps=50, n_windows=3, mode="dynamic")
    out = {"dynamic": proto.compact_inputs(sim)}
    del sim
    sim = build_bench_sim(n, mode="uniform", device="cuda")
    sim.run(5)
    out["uniform"] = proto.compact_inputs(sim)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compact_shapes: no CUDA device")
    lib = cuda_build.load()
    committed = lib.handles["compact"]
    built = build({**{"x".join(map(str, s)): _source(s) for s in SHAPES},
                   "split": _source(split=True)})
    rows = [OFX, OFY, OFZ, ODRHO, ODE]
    report = {}
    for lname, inp in layouts(args.particles).items():
        alive = inp.state.alive

        def run():
            return proto.run_compact(inp)

        def bits(out):
            return out[rows][:, alive].view(torch.int32)

        ref = bits(mxu_compact.compact_force_scan(
            inp.fld, inp.tabs, inp.backend.win, inp.aux.delta,
            inp.backend.geom, inp.spec, inp.P, inp.cut))
        lib.handles["compact"] = built["split"][0]
        out = run()
        lib.handles["compact"] = committed
        rest, sums = out[ORHO][alive].double(), out[OCGX][alive].double()
        rep = {"sums_share_of_cycles": float(sums.sum() / (sums + rest).sum())}
        for name, (handle, regs, spill) in built.items():
            if name == "split":
                continue
            t = {}
            for turn in ("committed", name, name, "committed"):
                lib.handles["compact"] = committed if turn == "committed" \
                    else handle
                assert torch.equal(bits(run()), ref), (lname, turn)
                t.setdefault(turn, []).append(proto.cuda_ms(run, 10))
            lib.handles["compact"] = committed
            rep[name] = dict(ms=sum(t[name]) / 2,
                             committed_ms=sum(t["committed"]) / 2,
                             registers=regs, spill_stores=spill)
            rep[name]["ratio"] = rep[name]["ms"] / rep[name]["committed_ms"]
            print(f"{lname} {name}: {rep[name]}", flush=True)
        print(f"{lname}: chunk sums {rep['sums_share_of_cycles']:.3f} of a "
              "thread's cycles (committed shape)", flush=True)
        report[lname] = rep
    name, limit = card_info()
    print(json.dumps(dict(report, shape=dict(zip(CONSTS, committed_shape())),
                          particles=args.particles, device_name=name,
                          power_limit=limit)))


if __name__ == "__main__":
    main()
