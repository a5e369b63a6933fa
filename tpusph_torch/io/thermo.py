"""LAMMPS-format thermo output (src/thermo.cpp — SURVEY.md §2.8, §5.5),
the counterpart of ``tpusph/io/thermo.py`` (host code, framework-free).

BASELINE.json binds "LAMMPS-compatible thermo output": same column headers,
same ``%12.8g`` numeric formatting, the ``Step ...`` header line, and the
run-end ``Loop time of X on N procs for N steps with M atoms`` summary
with the per-category time breakdown (src/timer.cpp). NaN in any column
aborts with a clear message (the Error::all analog — SURVEY §5.3).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, TextIO

# LAMMPS header spellings for thermo_style custom keywords.
HEADER_NAMES = {
    "step": "Step", "time": "Time", "dt": "Dt", "atoms": "Atoms",
    "ke": "KinEng", "pe": "PotEng", "etotal": "TotEng", "temp": "Temp",
    "press": "Press", "vol": "Volume", "density": "Density",
}


class ThermoError(RuntimeError):
    pass


class ThermoWriter:
    """Prints thermo lines to screen and mirrors them into a log file,
    like lammps.cpp's screen/log pair."""

    def __init__(self, columns: List[str], screen: bool = True,
                 log_path: Optional[str] = None):
        self.columns = list(columns)
        self.screen: Optional[TextIO] = sys.stdout if screen else None
        self.log: Optional[TextIO] = open(log_path, "w") if log_path else None
        self._header_written = False

    def _emit(self, line: str):
        for f in (self.screen, self.log):
            if f is not None:
                f.write(line + "\n")
                f.flush()

    def header_name(self, col: str) -> str:
        if col in HEADER_NAMES:
            return HEADER_NAMES[col]
        # v_x -> v_x, c_id -> c_id (LAMMPS prints these verbatim)
        return col

    def write_header(self):
        parts = [f"{self.header_name(c):>12s}" for c in self.columns]
        self._emit(" ".join(parts).rstrip())
        self._header_written = True

    def write_line(self, values: Dict[str, float]):
        if not self._header_written:
            self.write_header()
        parts = []
        for c in self.columns:
            v = values[c]
            if isinstance(v, (int,)) or c in ("step", "atoms"):
                parts.append(f"{int(v):>12d}")
            else:
                fv = float(v)
                if math.isnan(fv):
                    raise ThermoError(
                        f"thermo column '{self.header_name(c)}' is NaN — "
                        "simulation diverged (Error::all equivalent)")
                parts.append(f"{fv:>12.8g}")
        self._emit(" ".join(parts).rstrip())

    def write_loop_summary(self, loop_time: float, nprocs: int, nsteps: int,
                           natoms: int,
                           breakdown: Optional[Dict[str, float]] = None):
        self._emit(f"Loop time of {loop_time:.6g} on {nprocs} procs "
                   f"for {nsteps} steps with {natoms} atoms")
        if breakdown:
            self._emit("")
            total = max(loop_time, 1e-30)
            for cat in ("Pair", "Neigh", "Comm", "Output", "Modify", "Other"):
                t = breakdown.get(cat, 0.0)
                self._emit(f"{cat:<7s} time (%) = {t:.6g} "
                           f"({100.0 * t / total:.4g})")

    def close(self):
        if self.log is not None:
            self.log.close()
            self.log = None
