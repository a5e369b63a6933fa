"""Build and bind the hand-written CUDA sweeps: the strip sweeps (rho,
colour gradient, force and the phase-change vapor query,
``csrc/strip_sweeps.cu``), the column sweeps (rho, colour gradient,
force, ``csrc/column_sweeps.cu``), the band sweeps (rho, colour
gradient, force, ``csrc/band_sweeps.cu``) and the compacted force sweep
(``csrc/compact_force.cu``), which share their pair physics through
``csrc/sph_pair.cuh``; the strip, column and band sweeps share the warp
box filter and pair queue (``csrc/warp_filter.cuh``), and the column and
band sweeps one filtered kernel (``csrc/cell_sweep.cuh``). The strip
library also exports its one-pass colour-gradient and vapor scans as
``strip_{cgrad,vapor}_scan_launch``, the column and band libraries their
one-pass scans as ``{column,band}_{rho,cgrad,force}_scan_launch``, the
compacted library its one-pass kernel as ``compact_force_scan_launch``:
check kernels no path launches.

Each source has a plain C interface: it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``tpusph_torch/_build/`` at first
use and loaded with ``ctypes``. A library is keyed by the hash of its
source, the shared header and the flags, so an edit to any of them
rebuilds it; the sources build in parallel, one ``nvcc`` each. No PyTorch
headers are compiled, which keeps a build to seconds. Nothing here runs at
import time: the CPU tests import the package on machines without a CUDA
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {"strip": _PKG / "csrc" / "strip_sweeps.cu",
           "column": _PKG / "csrc" / "column_sweeps.cu",
           "band": _PKG / "csrc" / "band_sweeps.cu",
           "compact": _PKG / "csrc" / "compact_force.cu"}
HEADERS = tuple(_PKG / "csrc" / h for h in ("sph_pair.cuh",
                                             "warp_filter.cuh",
                                             "cell_sweep.cuh"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_GEOM_ARGS = ("n_slots", "ncols", "col_cap", "ts", "ch", "t_blk",
              "nblocks", "mlo", "mhi", "nnbr")
_INT_ARGS = _GEOM_ARGS + ("dim", "kernel", "flags", "T1")
_VAPOR_INT_ARGS = _GEOM_ARGS + ("vtype",)
_COLUMN_INT_ARGS = ("n_slots", "ncx", "ncy", "ncz", "cap", "dim", "per_x",
                    "per_y", "per_col", "kernel", "flags", "T1")
_COLUMN_FLOAT_ARGS = ("lx", "ly", "lcol", "cutmax2")
_BAND_INT_ARGS = ("n_slots", "ncx", "ncy", "nsub_pad", "G", "c", "k", "dim",
                  "per_x", "per_y", "per_col", "kernel", "flags", "T1")
_COMPACT_INT_ARGS = _INT_ARGS + ("P",)
# the launchers of each library: each sweep and its one-pass check
# kernels
LAUNCHERS = {"strip": ("rho", "cgrad", "force", "cgrad_scan", "vapor",
                       "vapor_scan"),
             "column": ("rho", "cgrad", "force", "rho_scan", "cgrad_scan",
                        "force_scan"),
             "band": ("rho", "cgrad", "force", "rho_scan", "cgrad_scan",
                      "force_scan"),
             "compact": ("force", "force_scan")}


class _Lib:
    """The loaded libraries by source name, and the compiler's resource
    report of each build."""

    def __init__(self, handles: dict, ptxas_log: str):
        self.handles = handles
        self.ptxas_log = ptxas_log


_lib: _Lib | None = None


def kernel_resources(log: str, kernel: str) -> tuple[int, int]:
    """(registers, spill store bytes) of the kernel whose mangled name holds
    ``kernel``, from a ``-Xptxas -v`` log (``_Lib.ptxas_log``)."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[k + 1])
            regs = re.search(r"Used (\d+) registers", lines[k + 2])
            return int(regs.group(1)), int(spill.group(1))
    raise ValueError(f"{kernel}: not in the ptxas log")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _bind(name: str, handle: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "strip":
        for sweep in LAUNCHERS["strip"]:
            fn = getattr(handle, f"strip_{sweep}_launch")
            fn.argtypes = ([ptr] * 5 + [i32] * len(_VAPOR_INT_ARGS)
                           + [f32, ptr] if sweep.startswith("vapor") else
                           [ptr] * 7 + [i32] * len(_INT_ARGS) + [f32, ptr])
            fn.restype = i32
    elif name == "compact":
        for sweep in LAUNCHERS["compact"]:
            fn = getattr(handle, f"compact_{sweep}_launch")
            fn.argtypes = ([ptr] * 7 + [i32] * len(_COMPACT_INT_ARGS)
                           + [f32, f32, ptr])
            fn.restype = i32
    else:
        ints = _COLUMN_INT_ARGS if name == "column" else _BAND_INT_ARGS
        for sweep in LAUNCHERS[name]:
            fn = getattr(handle, f"{name}_{sweep}_launch")
            fn.argtypes = ([ptr] * 4 + [i32] * len(ints)
                           + [f32] * len(_COLUMN_FLOAT_ARGS) + [ptr])
            fn.restype = i32
    err = getattr(handle, f"{name}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p


def load() -> _Lib:
    """Compile (once per source version, all sources at once) and load the
    sweep libraries."""
    global _lib
    if _lib is not None:
        return _lib
    header = b"".join(h.read_bytes() for h in HEADERS)
    flags = " ".join(NVCC_FLAGS).encode()
    builds, jobs = {}, {}
    for name, src in SOURCES.items():
        tag = hashlib.sha256(src.read_bytes() + header + flags).hexdigest()
        so = BUILD_DIR / f"lib{src.stem}_{tag[:16]}.so"
        log = so.with_suffix(".ptxas.txt")
        builds[name] = (so, log)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out, err = proc.communicate()
        so, log = builds[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{out}\n{err}")
            continue
        log.write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    handles, logs = {}, []
    for name, (so, log) in builds.items():
        handles[name] = ctypes.CDLL(str(so))
        _bind(name, handles[name])
        if log.exists():
            logs.append(log.read_text())
    _lib = _Lib(handles, "\n".join(logs))
    return _lib


class LaunchCount:
    """The launch counts of one kernel wrapper, added to where the wrapper
    launches its kernel and nowhere else: ``launches`` in all, ``by_card``
    by CUDA device index (the bricks' cards)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.by_card = {}

    def count(self, device: torch.device) -> None:
        self.launches += 1
        self.by_card[device.index] = self.by_card.get(device.index, 0) + 1


def _call(lib_name: str, fn_name: str, tensors, ints, int_names,
          floats) -> None:
    """One launch on the card the tensors lie on: under that card's device
    guard (the launcher's ``cudaFuncSetAttribute`` and the launch act on
    the current device, and the stream is that card's current stream).
    Tensors on more than one device, or off the card, raise: nothing is
    copied."""
    device = tensors[0].device
    others = sorted({str(t.device) for t in tensors} - {str(device)})
    if device.type != "cuda" or others:
        raise ValueError(f"{fn_name}: every tensor must lie on one CUDA "
                         f"device; got {device} and {others}")
    lib = load().handles[lib_name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *[t.data_ptr() for t in tensors],
            *[int(ints[k]) for k in int_names], *[float(v) for v in floats],
            stream)
    if rc != 0:
        msg = getattr(lib, f"{lib_name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn_name} failed on {device}: CUDA error {rc} "
                           f"({msg})")


def launch(sweep: str, fld, perm, shift, delta, tab2, tab1, out, *,
           cutmax2: float, **ints) -> None:
    """Launch one strip sweep (``sweep`` rho, cgrad, force or the check
    kernel cgrad_scan) on the current stream of its tensors' card; raises
    on a refused launch. Tensors are checked by the caller
    (strip_pair.SweepKernel)."""
    _call("strip", f"strip_{sweep}_launch",
          (fld, perm, shift, delta, tab2, tab1, out), ints, _INT_ARGS,
          (cutmax2,))


def launch_vapor(name: str, fld, perm, shift, delta, out, *, cut2: float,
                 **ints) -> None:
    """Launch the strip vapor sweep (``name`` vapor) or its check kernel
    (vapor_scan) on the current stream of its tensors' card; raises on a
    refused launch. Tensors are checked by the caller
    (strip_pair.VaporKernel)."""
    _call("strip", f"strip_{name}_launch", (fld, perm, shift, delta, out),
          ints, _VAPOR_INT_ARGS, (cut2,))


def launch_column(sweep: str, fld, tab2, tab1, out, *, lx: float,
                  ly: float, lcol: float, cutmax2: float, **ints) -> None:
    """Launch one column sweep (``sweep`` rho, cgrad, force or the check
    kernel force_scan) on the current stream of its tensors' card; raises
    on a refused launch. Tensors are checked by the caller
    (pallas_pair.ColumnSweepKernel)."""
    _call("column", f"column_{sweep}_launch", (fld, tab2, tab1, out), ints,
          _COLUMN_INT_ARGS, (lx, ly, lcol, cutmax2))


def launch_band(sweep: str, fld, tab2, tab1, out, *, lx: float, ly: float,
                lcol: float, cutmax2: float, **ints) -> None:
    """Launch one band sweep (``sweep`` rho, cgrad, force or a check
    kernel rho_scan, cgrad_scan, force_scan) on the current stream of its
    tensors' card; raises on a refused launch. Tensors are checked by the
    caller (band_pair.BandSweepKernel)."""
    _call("band", f"band_{sweep}_launch", (fld, tab2, tab1, out), ints,
          _BAND_INT_ARGS, (lx, ly, lcol, cutmax2))


def launch_compact(name: str, fld, perm, shift, delta, tab2, tab1, out, *,
                   cutmax2: float, cut2: float, **ints) -> None:
    """Launch the compacted force sweep (``name`` force) or its one-pass
    check kernel (force_scan) on the current stream of its tensors' card;
    raises on a refused launch. Tensors are checked by the caller
    (mxu_compact.CompactForceKernel)."""
    _call("compact", f"compact_{name}_launch",
          (fld, perm, shift, delta, tab2, tab1, out), ints,
          _COMPACT_INT_ARGS, (cutmax2, cut2))
