"""``torch.save`` checkpoints — the port's counterpart of
``tpusph/io/restart_orbax.py``: the same compact payload as the ``.npz``
format (alive owned particles, box, step counter, dt, spec and tables), in
one file written with ``torch.save`` and read with ``torch.load``
(``weights_only``: tensors, numbers, strings, lists and dicts only)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusph_torch.io.restart import (
    _STAGED_FIELDS, apply_restart, restart_meta,
)
from tpusph_torch.params import PairTables


def save(path: str, sim) -> None:
    sim._pull_state()
    payload = {
        "meta": restart_meta(sim),
        "staged": {k: torch.from_numpy(np.array(sim._staged[k]))
                   for k in _STAGED_FIELDS},
        "tables": {f.name: torch.from_numpy(
            np.array(getattr(sim.tables, f.name), np.float32))
            for f in dataclasses.fields(PairTables)},
    }
    torch.save(payload, path)


def load(path: str, sim) -> None:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    apply_restart(sim, payload["meta"],
                  {k: v.numpy() for k, v in payload["staged"].items()},
                  {k: v.numpy() for k, v in payload["tables"].items()})
