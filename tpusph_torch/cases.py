"""The five ``cases/`` scripts at their golden-log settings, and the
golden-log comparison, for the tests and ``chip_smoke.py``.

``GOLDEN`` holds, per case, the variables, the ``pre`` commands and the
run length with which ``tools/generate_golden.py`` wrote
``tests/golden/log.<case>`` (a copy: the port imports nothing of the JAX
package's tooling; a test holds the two equal). ``golden_script`` builds
the script the golden run executes: the case's commands without its
``run``, ``dump`` and ``thermo`` lines, then the ``pre`` commands and the
run. ``rows_within_bar`` holds thermo rows to the golden bar of
``tests/test_golden.py``: every column to rtol 2e-3 with an absolute floor
of 1e-5 of the column's largest magnitude, the ``Atoms`` column exact.
"""

from __future__ import annotations

import os

import numpy as np

GOLDEN = {
    "heat_slab": dict(
        path="cases/heat_slab/in.heat_slab",
        var={"dx": "0.04"},
        pre=["thermo 20", "thermo_style custom step time pe"],
        run=100,
    ),
    "water_collapse": dict(
        path="cases/water_collapse/in.water_collapse",
        var={},
        pre=["variable dx2 equal 1", "thermo 40",
             "thermo_style custom step time ke pe"],
        run=200,
    ),
    "droplet": dict(
        path="cases/droplet/in.droplet",
        var={},
        pre=["thermo 40", "thermo_style custom step time ke density"],
        run=200,
    ),
    "bubble_rise": dict(
        path="cases/bubble_rise/in.bubble_rise",
        var={"dx": "0.08"},
        pre=["thermo 30", "thermo_style custom step time ke atoms"],
        run=150,
    ),
    "boiling": dict(
        path="cases/boiling/in.boiling",
        var={"dx": "0.08"},
        pre=["thermo 30", "thermo_style custom step time ke atoms"],
        run=150,
    ),
}

RTOL = 2e-3
FLOOR = 1e-5


def build_lines(path: str, root: str = ".") -> list:
    """The case's commands before its run: every line but ``run``,
    ``dump`` and ``thermo`` ones."""
    text = open(os.path.join(root, path)).read()
    return [line for line in text.splitlines()
            if not line.strip().startswith(("run", "dump", "thermo"))]


def golden_script(name: str, nsteps: int | None = None,
                  root: str = ".") -> str:
    """The script of the golden run of ``name``, for ``nsteps`` steps (the
    golden run's length by default)."""
    spec = GOLDEN[name]
    run = spec["run"] if nsteps is None else nsteps
    return "\n".join(build_lines(spec["path"], root) + list(spec["pre"])
                     + [f"run {run}"]) + "\n"


def parse_log(path: str) -> tuple:
    """(header, rows) of the thermo tables of a LAMMPS-format log, in step
    order. A run that re-chose its geometry mid-way continues in a new
    table that repeats the step it resumed from; the first row of each
    step is kept."""
    rows, header, table = {}, None, None
    for line in open(path):
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "Step":
            if toks != header:
                rows = {}
            header = table = toks
            continue
        if table and len(toks) == len(table):
            try:
                vals = [float(v) for v in toks]
            except ValueError:
                table = None
                continue
            rows.setdefault(vals[0], vals)
        elif line.startswith("Loop time"):
            table = None
    return header, np.asarray([rows[k] for k in sorted(rows)])


def rows_within_bar(header, new, gold) -> dict:
    """The largest error of each column of ``new`` against ``gold`` at the
    golden steps up to ``new``'s last (a row at a step the golden log does
    not have, where a run resumed after a re-choice, is not compared), as
    (abs error, allowed); raises AssertionError naming the first column
    that misses the bar, or a golden step with no row."""
    gold = gold[gold[:, 0] <= new[:, 0].max()]
    new = new[np.isin(new[:, 0], gold[:, 0])]
    assert new.shape == gold.shape, (new[:, 0], gold[:, 0])
    out = {}
    for c, name in enumerate(header):
        floor = FLOOR * max(float(np.abs(gold[:, c]).max()), 1e-8)
        allowed = floor + RTOL * np.abs(gold[:, c])
        err = np.abs(new[:, c] - gold[:, c])
        if name == "Atoms":
            allowed = np.zeros_like(err)
        out[name] = (float(err.max()), float(allowed[err.argmax()]))
        assert (err <= allowed).all(), (name, new[:, c], gold[:, c])
    return out
