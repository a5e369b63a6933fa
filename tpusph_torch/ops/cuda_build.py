"""Build and bind the hand-written CUDA strip sweeps — rho, colour
gradient, force and the phase-change vapor query
(``tpusph_torch/csrc/strip_sweeps.cu``).

The source has a plain C interface: it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``tpusph_torch/_build/`` at first
use (keyed by the source's hash, so an edited source rebuilds) and loaded
with ``ctypes``. No PyTorch headers are compiled, which keeps the build to
seconds. Nothing here runs at import time: the CPU tests import the
package on machines without a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "strip_sweeps.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_GEOM_ARGS = ("n_slots", "ncols", "col_cap", "ts", "ch", "t_blk",
              "nblocks", "mlo", "mhi", "nnbr")
_INT_ARGS = _GEOM_ARGS + ("dim", "kernel", "flags", "T1")
_VAPOR_INT_ARGS = _GEOM_ARGS + ("vtype",)


class _Lib:
    """The loaded library and the compiler's resource report."""

    def __init__(self, handle: ctypes.CDLL, ptxas_log: str):
        self.handle = handle
        self.ptxas_log = ptxas_log


_lib: _Lib | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def load() -> _Lib:
    """Compile (once per source version) and load the sweep library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libstrip_sweeps_{tag[:16]}.so"
    log = BUILD_DIR / f"libstrip_sweeps_{tag[:16]}.ptxas.txt"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    handle = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    for sweep in ("rho", "cgrad", "force"):
        fn = getattr(handle, f"strip_{sweep}_launch")
        fn.argtypes = ([ptr] * 7 + [ctypes.c_int] * len(_INT_ARGS)
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    fn = handle.strip_vapor_launch
    fn.argtypes = ([ptr] * 5 + [ctypes.c_int] * len(_VAPOR_INT_ARGS)
                   + [ctypes.c_float, ptr])
    fn.restype = ctypes.c_int
    handle.strip_error_string.argtypes = [ctypes.c_int]
    handle.strip_error_string.restype = ctypes.c_char_p
    _lib = _Lib(handle, log.read_text() if log.exists() else "")
    return _lib


def _call(name: str, tensors, ints, names, scalar: float, device) -> None:
    lib = load().handle
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, f"strip_{name}_launch")(
        *[t.data_ptr() for t in tensors], *[int(ints[k]) for k in names],
        float(scalar), stream)
    if rc != 0:
        raise RuntimeError(f"strip {name} sweep launch failed: CUDA error "
                           f"{rc} ({lib.strip_error_string(rc).decode()})")


def launch(sweep: str, fld, perm, shift, delta, tab2, tab1, out, *,
           cutmax2: float, **ints) -> None:
    """Launch one sweep on the current stream; raises on a refused launch.
    Tensors are checked by the caller (strip_pair.SweepKernel)."""
    _call(sweep, (fld, perm, shift, delta, tab2, tab1, out), ints,
          _INT_ARGS, cutmax2, fld.device)


def launch_vapor(fld, perm, shift, delta, out, *, cut2: float,
                 **ints) -> None:
    """Launch the vapor sweep on the current stream; raises on a refused
    launch. Tensors are checked by the caller (strip_pair.VaporKernel)."""
    _call("vapor", (fld, perm, shift, delta, out), ints, _VAPOR_INT_ARGS,
          cut2, fld.device)
