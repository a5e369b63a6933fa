"""Trajectory dumps — LAMMPS ``dump atom`` / ``dump custom`` / ``dump xyz``
format (src/dump_atom.cpp, dump_custom.cpp — SURVEY.md §2.8), the
counterpart of ``tpusph/io/dump.py``: the same columns and formatting, the
state fetched to the host with ``state_to_numpy``.

Output order is by particle tag (stable across the backends' re-sorts,
matching LAMMPS's id-ordered dumps with ``dump_modify sort id``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tpusph_torch.state import state_to_numpy


class Dump:
    def __init__(self, id: str, style: str, every: int, path: str,
                 columns: Optional[List[str]] = None,
                 computes: Optional[Dict[str, tuple]] = None,
                 var_context=None):
        self.id = id
        self.style = style
        self.every = every
        self.path = path
        self.columns = columns or ["id", "type", "xs", "ys", "zs"]
        self.computes = computes or {}
        self.var_context = var_context  # Interpreter, for v_ atom variables
        self._file = None
        self._last_step = None

    def _ensure_file(self):
        if self._file is None:
            self._file = open(self.path, "w")
        return self._file

    def maybe_write(self, sim, state, istep: int):
        if self.every <= 0 or istep % self.every != 0 \
                or istep == self._last_step:
            return
        self._last_step = istep
        self.write(sim, state, istep)

    def _column_data(self, sim, dev, order, box):
        lo = box.lo.cpu().numpy()
        length = box.hi.cpu().numpy() - lo
        x = sim._host_x(dev)[order]
        cols = {}
        for c in self.columns:
            if c == "id":
                cols[c] = dev["tag"][order]
            elif c == "type":
                cols[c] = dev["type"][order]
            elif c in ("x", "y", "z"):
                cols[c] = x[:, "xyz".index(c)]
            elif c in ("xs", "ys", "zs"):
                d = "xyz".index(c[0])
                cols[c] = (x[:, d] - lo[d]) / max(length[d], 1e-30)
            elif c in ("vx", "vy", "vz"):
                cols[c] = dev["v"][order][:, "xyz".index(c[1])]
            elif c in ("fx", "fy", "fz"):
                cols[c] = dev["f"][order][:, "xyz".index(c[1])]
            elif c == "mass":
                cols[c] = dev["rmass"][order]
            elif c.startswith("c_") and c[2:] in self.computes:
                _, field = self.computes[c[2:]]
                if field == "t":
                    cv = dev["cv"][order]
                    cols[c] = dev["e"][order] / np.where(cv > 0, cv, 1)
                else:
                    cols[c] = dev[field][order]
            elif c in ("rho", "e", "cv"):
                cols[c] = dev[c][order]
            elif c.startswith("v_") and self.var_context is not None:
                from tpusph_torch.script import AtomVariable
                var = self.var_context.vars.get(c[2:])
                if isinstance(var, AtomVariable):
                    cols[c] = var.evaluate_atom(
                        self.var_context, self._atom_fields(dev, order, x))
                else:
                    cols[c] = np.full(len(order),
                                      self.var_context.var_value(c[2:]))
            else:
                raise ValueError(f"dump column '{c}' unsupported")
        return cols

    @staticmethod
    def _atom_fields(dev, order, x) -> Dict[str, np.ndarray]:
        """Per-atom env for atom-style variable expressions."""
        v = dev["v"][order]
        f = dev["f"][order]
        cv = dev["cv"][order]
        e = dev["e"][order]
        return dict(
            x=x[:, 0], y=x[:, 1], z=x[:, 2],
            vx=v[:, 0], vy=v[:, 1], vz=v[:, 2],
            fx=f[:, 0], fy=f[:, 1], fz=f[:, 2],
            rho=dev["rho"][order], e=e, cv=cv,
            temp=e / np.where(cv > 0, cv, 1.0),
            mass=dev["rmass"][order],
            type=dev["type"][order],
            id=dev["tag"][order],
        )

    def write(self, sim, state, istep: int):
        f = self._ensure_file()
        dev = state_to_numpy(state)
        alive = (dev["type"] > 0) & dev["owned"]
        idx = np.nonzero(alive)[0]
        order = idx[np.argsort(dev["tag"][idx], kind="stable")]
        box = sim.box
        if self.style == "xyz":
            # dump_xyz.cpp format: natoms, comment, then "type x y z" rows
            x = sim._host_x(dev)[order]
            t = dev["type"][order]
            f.write(f"{len(order)}\n")
            f.write(f"Atoms. Timestep: {istep}\n")
            for i in range(len(order)):
                f.write(f"{t[i]} {x[i, 0]:.8g} {x[i, 1]:.8g} {x[i, 2]:.8g}\n")
            f.flush()
            return
        bchar = ["pp" if p else "ff" for p in box.periodic]
        f.write("ITEM: TIMESTEP\n%d\n" % istep)
        f.write("ITEM: NUMBER OF ATOMS\n%d\n" % len(order))
        f.write("ITEM: BOX BOUNDS %s %s %s\n" % tuple(bchar))
        lo = box.lo.cpu().numpy()
        hi = box.hi.cpu().numpy()
        for d in range(3):
            f.write("%.9g %.9g\n" % (lo[d], hi[d]))
        cols = self.columns if self.style == "custom" \
            else ["id", "type", "xs", "ys", "zs"]
        self.columns = cols
        f.write("ITEM: ATOMS %s\n" % " ".join(cols))
        data = self._column_data(sim, dev, order, box)
        mat = np.column_stack([data[c] for c in cols]).astype(np.float32)
        ints = [i for i, c in enumerate(cols) if c in ("id", "type")]
        from tpusph_torch import native
        txt = native.format_dump_rows(mat, ints)
        if txt is not None:
            f.write(txt)
        else:  # no toolchain: Python fallback, same format
            for row in mat:
                parts = [("%d" % row[i]) if i in ints else ("%.8g" % row[i])
                         for i in range(len(cols))]
                f.write(" ".join(parts) + "\n")
        f.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
