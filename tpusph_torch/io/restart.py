"""Checkpoint / resume — the write_restart / read_restart equivalent
(src/write_restart.cpp, read_restart.cpp — SURVEY.md §3.4, §5.4), the
counterpart of ``tpusph/io/restart.py``: the same ``.npz`` payload, so a
file written by either package reads in the other.

Format: one .npz with the COMPACT particle set (alive owned particles),
box, step counter, dt, and the physics spec and tables. Continuation is
exact modulo reneighbouring, as in the reference: every derived field (f,
drho, de, vest) is recomputed by Verlet::setup from (x, v, rho, e) before
its first use. Paths without the ``.npz`` suffix take the LAMMPS binary
restart layout (``io/lammps_restart.py``); ``io/restart_torch.py`` keeps the
same payload with ``torch.save``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import numpy as np

from tpusph_torch.params import PairTables, PhysicsSpec
from tpusph_torch.state import Box

FORMAT_VERSION = 2

_STAGED_FIELDS = ("x", "v", "type", "rho", "e", "cv", "rmass", "tag",
                  "mobile")


class RestartSchedule(NamedTuple):
    every: int
    path_template: str  # may contain '*' replaced by the step number


def restart_meta(sim) -> dict:
    """The run's scalars and configuration as the payload stores them."""
    return dict(
        version=FORMAT_VERSION,
        spec=dataclasses.asdict(sim.spec),
        step_count=sim.step_count,
        time_acc=sim.time_acc,
        dt=sim.dt,
        box_lo=[float(v) for v in sim.box.lo.cpu().numpy()],
        box_hi=[float(v) for v in sim.box.hi.cpu().numpy()],
        periodic=list(sim.box.periodic),
        thermo_every=sim.thermo_every,
        thermo_columns=sim.thermo_columns,
        capacity_pad=sim.capacity_pad,
    )


def apply_restart(sim, meta: dict, staged: dict, tables: dict):
    """Install a read payload into ``sim`` (state rebuilt at the next
    run)."""
    spec_kw = dict(meta["spec"])
    # json turns tuples into lists; the spec must stay hashable
    spec_kw["scalar_tables"] = tuple(spec_kw.get("scalar_tables", ()))
    sim.spec = PhysicsSpec(**spec_kw)
    sim.tables = PairTables(**{k: np.array(v, np.float32)
                               for k, v in tables.items()})
    sim.box = Box.create(meta["box_lo"], meta["box_hi"],
                         periodic=tuple(meta["periodic"]),
                         device=sim.device)
    sim.step_count = int(meta["step_count"])
    sim.time_acc = float(meta["time_acc"])
    sim.dt = float(meta["dt"])
    if "thermo_every" in meta:
        sim.thermo_every = int(meta["thermo_every"])
        sim.thermo_columns = list(meta["thermo_columns"])
    sim.capacity_pad = int(meta.get("capacity_pad", 0))
    staged = dict(staged)
    staged["type"] = np.asarray(staged["type"]).astype(np.int32)
    staged["tag"] = np.asarray(staged["tag"]).astype(np.int32)
    staged["mobile"] = np.asarray(staged["mobile"]).astype(bool)
    sim._restored(staged)


def write_restart(path: str, sim):
    """Dispatch by extension: ``.npz`` -> the compressed payload below;
    anything else -> the LAMMPS binary restart layout, as in the
    reference, where restart paths carry no fixed suffix."""
    if not path.endswith(".npz"):
        from tpusph_torch.io.lammps_restart import write_restart_lammps
        return write_restart_lammps(path, sim)
    sim._pull_state()  # compact host copy of the current state
    payload = {f"staged_{k}": np.asarray(sim._staged[k])
               for k in _STAGED_FIELDS}
    for f in dataclasses.fields(PairTables):
        payload[f"tables_{f.name}"] = np.asarray(getattr(sim.tables, f.name))
    payload["meta_json"] = np.frombuffer(
        json.dumps(restart_meta(sim)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def read_restart(path: str, sim):
    """Content-sniffing dispatch: LAMMPS binary restarts open with the
    magic tag string, .npz archives with the zip signature, so either
    format reads through this one entry point whatever its suffix."""
    with open(path, "rb") as fp:
        magic = fp.read(14)
    if magic.startswith(b"LammpS Restart"):
        from tpusph_torch.io.lammps_restart import read_restart_lammps
        return read_restart_lammps(path, sim)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"restart version {meta['version']} != "
                             f"{FORMAT_VERSION}")
        staged = {k: np.asarray(z[f"staged_{k}"]) for k in _STAGED_FIELDS}
        tables = {f.name: np.asarray(z[f"tables_{f.name}"])
                  for f in dataclasses.fields(PairTables)}
    apply_restart(sim, meta, staged, tables)
