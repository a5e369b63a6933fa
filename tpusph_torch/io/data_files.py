"""LAMMPS data-file reader/writer for ``atom_style meso``.

Reference parity: src/read_data.cpp + AtomVecMeso::data_atom (SURVEY.md
§3.3) — BASELINE.json binds "LAMMPS-compatible data files". Column order of
the Atoms section for atom_style meso:

    id type rho e cv x y z

plus optional image flags (3 ints) which we accept and fold into x via the
box length. ``Velocities`` section: ``id vx vy vz``. ``Masses`` gives
per-type mass, applied as per-particle rmass (meso carries per-particle
mass; the data file's Masses section seeds it, like create_atoms does).

A copy of ``tpusph/io/data_files.py`` on the port's native parser.
Host-side numpy — runs once at setup. For multi-million-particle files the
body is parsed with np.loadtxt on pre-split section chunks (vectorized, no
Python-per-line loop).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_HEADER_KEYS = (
    "atoms", "atom types", "xlo xhi", "ylo yhi", "zlo zhi",
    # accepted-and-ignored (bonded topology never appears in SPH cases):
    "bonds", "angles", "dihedrals", "impropers",
    "bond types", "angle types", "dihedral types", "improper types",
)

_SECTIONS = ("Masses", "Atoms", "Velocities", "Pair Coeffs", "PairIJ Coeffs")


@dataclass
class DataFile:
    natoms: int = 0
    ntypes: int = 0
    xlo: float = 0.0
    xhi: float = 0.0
    ylo: float = 0.0
    yhi: float = 0.0
    zlo: float = 0.0
    zhi: float = 0.0
    masses: Dict[int, float] = field(default_factory=dict)
    tag: Optional[np.ndarray] = None
    type: Optional[np.ndarray] = None
    rho: Optional[np.ndarray] = None
    e: Optional[np.ndarray] = None
    cv: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None


def _host(v) -> np.ndarray:
    """A host numpy copy of a torch tensor (on any device) or an array."""
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def _strip_comment(line: str) -> str:
    i = line.find("#")
    return line[:i] if i >= 0 else line


def read_data(path: str) -> DataFile:
    with open(path) as f:
        lines = f.read().splitlines()

    df = DataFile()
    # line 0 is a free comment; header runs until the first section keyword
    i = 1
    section_starts: Dict[str, int] = {}
    cur = None
    header_done = False
    while i < len(lines):
        raw = _strip_comment(lines[i]).strip()
        if not raw:
            i += 1
            continue
        # section headers are bare keywords
        matched = next((s for s in _SECTIONS
                        if raw == s or raw.startswith(s + " ")), None)
        if matched:
            section_starts[matched] = i + 1
            header_done = True
            i += 1
            continue
        if not header_done:
            toks = raw.split()
            for key in _HEADER_KEYS:
                nk = len(key.split())
                if toks[-nk:] == key.split() if nk > 1 else toks[-1:] == [key]:
                    vals = toks[:-nk] if nk > 1 else toks[:-1]
                    if key == "atoms":
                        df.natoms = int(vals[0])
                    elif key == "atom types":
                        df.ntypes = int(vals[0])
                    elif key == "xlo xhi":
                        df.xlo, df.xhi = float(vals[0]), float(vals[1])
                    elif key == "ylo yhi":
                        df.ylo, df.yhi = float(vals[0]), float(vals[1])
                    elif key == "zlo zhi":
                        df.zlo, df.zhi = float(vals[0]), float(vals[1])
                    break
            else:
                raise ValueError(f"unrecognized data-file header line: '{raw}'")
        i += 1

    def section_block(name: str, nrows: int, ncols: int = 0) -> Optional[np.ndarray]:
        if name not in section_starts:
            return None
        start = section_starts[name]
        nxt = min((s for s in section_starts.values() if s > start),
                  default=len(lines) + 1)
        text = "\n".join(lines[start: nxt - 1])
        if ncols:
            # native C++ parser (tpusph_torch.native) — ~30x numpy.loadtxt on
            # multi-million-particle files; falls back when unavailable
            from tpusph_torch import native
            try:
                arr = native.parse_table(text, nrows, ncols)
            except ValueError:
                arr = None  # e.g. optional image-flag columns: retry numpy
            if arr is not None:
                return np.asarray(arr, np.float64)
        return np.loadtxt(_io.StringIO(text), ndmin=2, comments="#",
                          max_rows=None)[:nrows]

    m = section_block("Masses", df.ntypes, ncols=2)
    if m is not None:
        df.masses = {int(r[0]): float(r[1]) for r in m}

    a = section_block("Atoms", df.natoms, ncols=8)
    if a is None:
        raise ValueError("data file has no Atoms section")
    if a.shape[1] not in (8, 11):
        raise ValueError(
            f"atom_style meso expects 8 columns (id type rho e cv x y z) "
            f"or 11 with image flags; got {a.shape[1]}")
    order = np.argsort(a[:, 0].astype(np.int64), kind="stable")
    a = a[order]
    df.tag = a[:, 0].astype(np.int32)
    df.type = a[:, 1].astype(np.int32)
    df.rho = a[:, 2].astype(np.float32)
    df.e = a[:, 3].astype(np.float32)
    df.cv = a[:, 4].astype(np.float32)
    df.x = a[:, 5:8].astype(np.float32)
    if a.shape[1] == 11:  # image flags
        img = a[:, 8:11].astype(np.float32)
        L = np.array([df.xhi - df.xlo, df.yhi - df.ylo, df.zhi - df.zlo],
                     np.float32)
        df.x = df.x + img * L

    vsec = section_block("Velocities", df.natoms, ncols=4)
    if vsec is not None:
        vorder = np.argsort(vsec[:, 0].astype(np.int64), kind="stable")
        vsec = vsec[vorder]
        if not np.array_equal(vsec[:, 0].astype(np.int32), df.tag):
            raise ValueError("Velocities ids do not match Atoms ids")
        df.v = vsec[:, 1:4].astype(np.float32)
    return df


def write_data(path: str, *, box, tag, type, rho, e, cv, x, v=None,
               masses: Optional[Dict[int, float]] = None,
               comment: str = "tpusph data file"):
    """write_data equivalent: emits a file read_data (ours or LAMMPS's)
    accepts back."""
    tag = np.asarray(tag)
    order = np.argsort(tag, kind="stable")
    ntypes = int(np.max(np.asarray(type))) if len(np.asarray(type)) else 0
    lo = _host(box.lo).astype(float)
    hi = _host(box.hi).astype(float)
    with open(path, "w") as f:
        f.write(f"{comment}\n\n")
        f.write(f"{len(tag)} atoms\n")
        f.write(f"{ntypes} atom types\n\n")
        f.write(f"{lo[0]:.9g} {hi[0]:.9g} xlo xhi\n")
        f.write(f"{lo[1]:.9g} {hi[1]:.9g} ylo yhi\n")
        f.write(f"{lo[2]:.9g} {hi[2]:.9g} zlo zhi\n")
        if masses:
            f.write("\nMasses\n\n")
            for t in sorted(masses):
                f.write(f"{t} {masses[t]:.9g}\n")
        f.write("\nAtoms\n\n")
        ty = np.asarray(type)
        rr = np.asarray(rho)
        ee = np.asarray(e)
        cc = np.asarray(cv)
        xx = np.asarray(x)
        for i in order:
            f.write(f"{int(tag[i])} {int(ty[i])} {rr[i]:.9g} {ee[i]:.9g} "
                    f"{cc[i]:.9g} {xx[i, 0]:.9g} {xx[i, 1]:.9g} {xx[i, 2]:.9g}\n")
        if v is not None:
            vv = np.asarray(v)
            f.write("\nVelocities\n\n")
            for i in order:
                f.write(f"{int(tag[i])} {vv[i, 0]:.9g} {vv[i, 1]:.9g} "
                        f"{vv[i, 2]:.9g}\n")
