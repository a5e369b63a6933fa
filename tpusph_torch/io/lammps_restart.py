"""LAMMPS-native BINARY restart files (read_restart.cpp /
write_restart.cpp — SURVEY §3.4; the one §2 inventory row that stayed
"partial" through r3: the .npz/orbax checkpoints resume tpusph runs but
could not exchange state with the reference's own binary format).

Layout follows the published LAMMPS restart framing (write_restart.cpp
``magic_string/endian/version_numeric`` preamble, then int-flag-framed
header values, then per-processor atom payloads packed as doubles by
``AtomVec::pack_restart``):

  - magic: NUL-terminated ASCII tag string
  - endian sentinel: int 0x0001 (a byte-swapped file reads 0x01000000;
    the reader transparently byte-swaps, where the reference aborts)
  - numeric format version: int
  - header: a sequence of (int flag, typed value) pairs — ints, bigints,
    doubles, double-triples and length-prefixed char strings, one flag
    enum entry per quantity (units, timestep, dimension, periodicity,
    box bounds, atom style, natoms, ntypes, pair style, ...)
  - per-atom payload: per processor file section, ``int n`` then ``n``
    doubles; each atom contributes ``AtomVecMeso::pack_restart`` order:
      length, x(3), tag, type, mask, image, v(3), rho, e, cv, vest(3)
    (17 doubles — the meso style's 7 extra words over the base 10;
    reference: src/USER-SPH/atom_vec_meso.cpp pack_restart/unpack_restart)
  - tpusph extension section (flag SPEC_JSON): the PhysicsSpec/PairTables
    snapshot the .npz format stores, so a binary restart is a COMPLETE
    tpusph checkpoint too. A file without it (e.g. written by the
    reference) still reads: pair tables must then already be configured
    by the input script, exactly as LAMMPS requires pair_style/pair_coeff
    to be re-issued when reading data files.

The flag numbering below is this module's documented contract (kept in
one enum); the framing and payload order follow the published source. A
copy of ``tpusph/io/lammps_restart.py`` on the port's state: both packages
write the same bytes from the same state, and each reads the other's files
(tests/test_torch_script.py).
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"LammpS RestartT tpusph\x00"
ENDIAN_SENTINEL = 0x0001
FORMAT_NUMERIC = 1

# header flag enum (one integer id per framed quantity; write_restart.h)
(VERSION, SMALLINT, TAGINT, BIGINT, UNITS, NTIMESTEP, DIMENSION,
 XPERIODIC, YPERIODIC, ZPERIODIC, BOXLO, BOXHI, ATOM_STYLE, NATOMS,
 NTYPES, PAIR_STYLE, TIMESTEP_SIZE, TIME_ACC, SPEC_JSON, PERPROC,
 END_OF_HEADER) = range(21)

_I = struct.Struct("<i")
_Q = struct.Struct("<q")
_D = struct.Struct("<d")

# pack_restart word count per atom (see module docstring)
_ATOM_WORDS = 17


def _write_int(fp, flag, v):
    fp.write(_I.pack(flag))
    fp.write(_I.pack(int(v)))


def _write_bigint(fp, flag, v):
    fp.write(_I.pack(flag))
    fp.write(_Q.pack(int(v)))


def _write_double(fp, flag, v):
    fp.write(_I.pack(flag))
    fp.write(_D.pack(float(v)))


def _write_double3(fp, flag, v):
    fp.write(_I.pack(flag))
    fp.write(struct.pack("<3d", *[float(x) for x in v]))


def _write_char(fp, flag, s):
    b = s.encode() + b"\x00"
    fp.write(_I.pack(flag))
    fp.write(_I.pack(len(b)))
    fp.write(b)


def write_restart_lammps(path: str, sim) -> None:
    """Binary checkpoint in the LAMMPS restart framing (module docstring).
    Mirrors WriteRestart::command: header -> force-field names ->
    per-proc atom payload; tpusph writes ONE logical proc section (the
    compact global particle set — checkpoints stay mesh-independent)."""
    import dataclasses

    from tpusph_torch.params import PairTables

    sim._pull_state()
    st = sim._staged
    n = len(st["x"])

    spec_blob = dict(spec=dataclasses.asdict(sim.spec),
                     thermo_every=sim.thermo_every,
                     thermo_columns=sim.thermo_columns,
                     capacity_pad=sim.capacity_pad)
    tab = sim.tables
    spec_blob["tables"] = {
        f.name: np.asarray(getattr(tab, f.name)).tolist()
        for f in dataclasses.fields(PairTables)}

    with open(path, "wb") as fp:
        fp.write(MAGIC)
        fp.write(_I.pack(ENDIAN_SENTINEL))
        fp.write(_I.pack(FORMAT_NUMERIC))
        _write_char(fp, VERSION, "tpusph")
        _write_int(fp, SMALLINT, 4)
        _write_int(fp, TAGINT, 4)
        _write_int(fp, BIGINT, 8)
        _write_char(fp, UNITS, "lj")
        _write_bigint(fp, NTIMESTEP, sim.step_count)
        _write_int(fp, DIMENSION, sim.spec.dim)
        per = sim.box.periodic
        _write_int(fp, XPERIODIC, per[0])
        _write_int(fp, YPERIODIC, per[1])
        _write_int(fp, ZPERIODIC, per[2])
        _write_double3(fp, BOXLO, sim.box.lo.cpu().numpy())
        _write_double3(fp, BOXHI, sim.box.hi.cpu().numpy())
        _write_char(fp, ATOM_STYLE, "meso")
        _write_bigint(fp, NATOMS, n)
        _write_int(fp, NTYPES, sim.tables.ntypes)
        _write_char(fp, PAIR_STYLE, "hybrid/overlay sph")
        _write_double(fp, TIMESTEP_SIZE, sim.dt)
        _write_double(fp, TIME_ACC, sim.time_acc)
        _write_char(fp, SPEC_JSON, json.dumps(spec_blob))
        fp.write(_I.pack(END_OF_HEADER))

        # ---- per-proc atom payload (AtomVecMeso::pack_restart order) ----
        buf = np.empty((n, _ATOM_WORDS), dtype="<f8")
        buf[:, 0] = _ATOM_WORDS
        buf[:, 1:4] = st["x"]
        buf[:, 4] = st["tag"]
        buf[:, 5] = st["type"]
        # mask: bit 0 = "all" group; tpusph folds the mobile flag into
        # bit 1 (fix meso/stationary membership survives the roundtrip)
        buf[:, 6] = 1.0 + 2.0 * (~np.asarray(st["mobile"], bool))
        buf[:, 7] = 0.0                      # image flags (positions wrapped)
        buf[:, 8:11] = st["v"]
        buf[:, 11] = st["rho"]
        buf[:, 12] = st["e"]
        buf[:, 13] = st["cv"]
        buf[:, 14:17] = st["v"]              # vest ~ v (recomputed by setup)
        # meso rmass rides in the (otherwise zero) image word — the meso
        # atom vec stores per-atom mass, which base pack_restart has no
        # slot for; documented deviation, needed for mass-varying phases
        buf[:, 7] = st["rmass"]
        fp.write(_I.pack(1))                 # nprocs sections
        fp.write(_I.pack(buf.size))
        fp.write(buf.tobytes())


def _read_exact(fp, nbytes):
    b = fp.read(nbytes)
    if len(b) != nbytes:
        raise ValueError("truncated LAMMPS restart file")
    return b


class _Reader:
    def __init__(self, fp, swap):
        self.fp = fp
        self.sfx = ">" if swap else "<"

    def i(self):
        return struct.unpack(self.sfx + "i", _read_exact(self.fp, 4))[0]

    def q(self):
        return struct.unpack(self.sfx + "q", _read_exact(self.fp, 8))[0]

    def d(self):
        return struct.unpack(self.sfx + "d", _read_exact(self.fp, 8))[0]

    def d3(self):
        return struct.unpack(self.sfx + "3d", _read_exact(self.fp, 24))

    def s(self):
        n = self.i()
        return _read_exact(self.fp, n)[:-1].decode()


# flag -> reader method (framing is type-driven, so header order and
# unknown-but-typed future flags never break the parse)
_FLAG_TYPE = {VERSION: "s", SMALLINT: "i", TAGINT: "i", BIGINT: "i",
              UNITS: "s", NTIMESTEP: "q", DIMENSION: "i", XPERIODIC: "i",
              YPERIODIC: "i", ZPERIODIC: "i", BOXLO: "d3", BOXHI: "d3",
              ATOM_STYLE: "s", NATOMS: "q", NTYPES: "i", PAIR_STYLE: "s",
              TIMESTEP_SIZE: "d", TIME_ACC: "d", SPEC_JSON: "s"}


def read_restart_lammps(path: str, sim) -> None:
    """Parse a binary restart into ``sim`` (staged arrays + box + spec).
    Files without the SPEC_JSON extension section (reference-written)
    restore box/atoms/step only — pair_style/pair_coeff must already be
    configured, the same contract LAMMPS data files have."""
    import dataclasses

    from tpusph_torch.params import PairTables, PhysicsSpec
    from tpusph_torch.state import Box

    with open(path, "rb") as fp:
        magic = _read_exact(fp, len(MAGIC))
        if not magic.startswith(b"LammpS Restart"):
            raise ValueError(f"{path}: not a LAMMPS binary restart file")
        endian = struct.unpack("<i", _read_exact(fp, 4))[0]
        if endian == ENDIAN_SENTINEL:
            swap = False
        elif struct.unpack(">i", struct.pack("<i", endian))[0] \
                == ENDIAN_SENTINEL:
            swap = True          # byte-swapped writer: transparently swap
        else:
            raise ValueError(f"{path}: bad endian sentinel {endian:#x}")
        r = _Reader(fp, swap)
        fmt = r.i()
        if fmt > FORMAT_NUMERIC:
            raise ValueError(f"{path}: restart format {fmt} newer than "
                             f"supported {FORMAT_NUMERIC}")

        hdr = {}
        while True:
            flag = r.i()
            if flag == END_OF_HEADER:
                break
            if flag == PERPROC:
                raise ValueError(f"{path}: atom payload before end of header")
            if flag not in _FLAG_TYPE:
                raise ValueError(f"{path}: unknown header flag {flag} "
                                 "(newer writer?) — cannot size its payload")
            hdr[flag] = getattr(r, _FLAG_TYPE[flag])()

        nprocs = r.i()
        chunks = []
        for _ in range(nprocs):
            nwords = r.i()
            raw = np.frombuffer(_read_exact(fp, 8 * nwords),
                                dtype=(">f8" if swap else "<f8"))
            chunks.append(raw.reshape(-1, _ATOM_WORDS))
        buf = np.concatenate(chunks) if chunks else \
            np.empty((0, _ATOM_WORDS), np.float64)

    natoms = int(hdr.get(NATOMS, len(buf)))
    if len(buf) != natoms:
        raise ValueError(f"{path}: header natoms {natoms} != payload "
                         f"{len(buf)}")
    if (buf[:, 0] != _ATOM_WORDS).any():
        raise ValueError(f"{path}: unexpected per-atom word count "
                         f"{buf[0, 0]:.0f} (not atom_style meso?)")

    staged = dict(
        x=buf[:, 1:4].astype(np.float32),
        tag=buf[:, 4].astype(np.int32),
        type=buf[:, 5].astype(np.int32),
        mobile=(buf[:, 6].astype(np.int64) & 2) == 0,
        rmass=buf[:, 7].astype(np.float32),
        v=buf[:, 8:11].astype(np.float32),
        rho=buf[:, 11].astype(np.float32),
        e=buf[:, 12].astype(np.float32),
        cv=buf[:, 13].astype(np.float32),
    )

    if DIMENSION in hdr:
        sim.spec = dataclasses.replace(sim.spec, dim=int(hdr[DIMENSION]))
    if BOXLO in hdr and BOXHI in hdr:
        per = tuple(bool(hdr.get(f, 1))
                    for f in (XPERIODIC, YPERIODIC, ZPERIODIC))
        sim.box = Box.create(list(hdr[BOXLO]), list(hdr[BOXHI]),
                             periodic=per, device=sim.device)
    sim.step_count = int(hdr.get(NTIMESTEP, 0))
    if TIMESTEP_SIZE in hdr:
        sim.dt = float(hdr[TIMESTEP_SIZE])
    sim.time_acc = float(hdr.get(TIME_ACC, sim.step_count * sim.dt))

    if SPEC_JSON in hdr:
        blob = json.loads(hdr[SPEC_JSON])
        spec_kw = dict(blob["spec"])
        spec_kw["scalar_tables"] = tuple(spec_kw.get("scalar_tables", ()))
        sim.spec = PhysicsSpec(**spec_kw)
        tab_kwargs = {f.name: np.asarray(blob["tables"][f.name], np.float32)
                      for f in dataclasses.fields(PairTables)}
        sim.tables = PairTables(**tab_kwargs)
        sim.thermo_every = int(blob["thermo_every"])
        sim.thermo_columns = list(blob["thermo_columns"])
        sim.capacity_pad = int(blob.get("capacity_pad", 0))

    sim._restored(staged)
