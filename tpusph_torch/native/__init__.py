"""Native (C++) host runtime components bound via ctypes: the data-file
table parser (``datafile.cpp``) and the dump row formatter
(``dumpwriter.cpp``), copies of ``tpusph/native/``'s sources.

The library is built with ``g++`` at first use into the package's
``_build/`` directory (gitignored), not next to the sources; the build
writes a temporary file and renames it, so concurrent first uses cannot
load a half-written library. Every consumer has a pure-Python fallback: a
missing toolchain degrades, it does not break."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = (os.path.join(_HERE, "datafile.cpp"),
         os.path.join(_HERE, "dumpwriter.cpp"))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD, "libtpusph_torch_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    tmp = None
    try:
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, *_SRCS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """The ctypes library handle, building it if needed; None where it
    cannot be built or loaded (callers fall back)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.tpusph_parse_table.restype = ctypes.c_long
            lib.tpusph_parse_table.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            lib.tpusph_count_rows.restype = ctypes.c_long
            lib.tpusph_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_long]
            lib.tpusph_format_rows.restype = ctypes.c_long
            lib.tpusph_format_rows.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_long]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def parse_table(text: str, nrows: int, ncols: int):
    """Parse a numeric table (nrows x ncols) from text: a float32 array, or
    None where the library is unavailable (the caller falls back to
    numpy). Raises ValueError on malformed input."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    out = np.empty((nrows, ncols), np.float32)
    got = lib.tpusph_parse_table(
        raw, len(raw), nrows, ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise ValueError(
            f"malformed data-file row {-(got + 1)} (expected {ncols} columns)")
    if got != nrows:
        raise ValueError(f"expected {nrows} data rows, found {got}")
    return out


def format_dump_rows(mat, int_cols) -> "str | None":
    """Format a (nrows, ncols) float32 matrix as LAMMPS dump rows ("%.8g"
    floats, "%d" ids); None where the library is unavailable (the caller
    falls back to a Python loop with the same format)."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.float32)
    nrows, ncols = mat.shape
    if nrows == 0:
        return ""
    mask = np.zeros(ncols, np.int32)
    for c in int_cols:
        mask[c] = 1
    cap = nrows * (ncols * 18 + 2) + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.tpusph_format_rows(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrows, ncols, mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")
