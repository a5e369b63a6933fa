"""LAMMPS input-script interpreter over a command registry — the
counterpart of ``tpusph/script.py``, command for command.

Reference parity: src/input.cpp (tokenize, ${var} substitution, command
dispatch) + src/variable.cpp (equal-style variables) — SURVEY.md §1 L9,
§2.9. The supported command set is the one SPH multiphase scripts exercise;
each handler drives the same ``tpusph_torch.api.Simulation`` the Python API
exposes.

Unknown commands raise; commands that exist in LAMMPS but have no meaning
here (e.g. ``processors``: the bricks come from ``Simulation.set_mesh``)
warn once and continue. ``balance`` rebalances the bricks
(``Simulation.balance``).
"""

from __future__ import annotations

import ast
import dataclasses
import math
import operator
import re
import warnings
from typing import Dict, List, Optional

import numpy as np

from tpusph_torch import lattice as latmod
from tpusph_torch.api import Simulation

_IGNORED = {
    # parallel/runtime knobs with no meaning on one device
    "processors", "comm_modify", "comm_style", "suffix", "package",
    "atom_modify", "echo", "info",
}


class ScriptError(ValueError):
    pass


def _num(tok: str) -> float:
    return float(tok)


# ---------------------------------------------------------------------------
# Expression evaluation (src/variable.cpp subset) — a whitelisted-AST walker,
# NOT eval(): only literals, names bound in the env, arithmetic/comparison/
# boolean operators, and the math-function whitelist can appear. Works on
# scalars (equal-style) and numpy arrays (atom-style) alike.
# ---------------------------------------------------------------------------

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.Mod: operator.mod, ast.Pow: operator.pow,
           ast.FloorDiv: operator.floordiv}
_CMPOPS = {ast.Eq: operator.eq, ast.NotEq: operator.ne,
           ast.Lt: operator.lt, ast.LtE: operator.le,
           ast.Gt: operator.gt, ast.GtE: operator.ge}
_FUNCS = {
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log10,
    "abs": np.abs, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2, "floor": np.floor, "ceil": np.ceil,
    "round": np.round, "pow": np.power,
}


def safe_eval(expr: str, env: Dict[str, object]):
    """Evaluate a LAMMPS variable expression against ``env``. LAMMPS
    spellings are normalized first: ``^`` is power, ``&&``/``||``/``!``
    are boolean ops; comparisons/booleans yield 1.0/0.0."""
    expr = expr.replace("^", "**").replace("&&", " and ") \
               .replace("||", " or ").replace("!=", "<>")
    # LAMMPS unary '!' -> '~' (same precedence slot; walker treats
    # ast.Invert as logical not)
    expr = expr.replace("!", "~").replace("<>", "!=")

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant):
            if isinstance(n.value, (int, float)):
                return n.value
            raise ScriptError(f"literal {n.value!r} not allowed")
        if isinstance(n, ast.Name):
            if n.id in env:
                return env[n.id]
            raise ScriptError(f"unknown name '{n.id}'")
        if isinstance(n, ast.BinOp) and type(n.op) in _BINOPS:
            return _BINOPS[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp):
            if isinstance(n.op, ast.USub):
                return -ev(n.operand)
            if isinstance(n.op, ast.UAdd):
                return ev(n.operand)
            if isinstance(n.op, (ast.Not, ast.Invert)):
                return np.where(np.asarray(ev(n.operand)) != 0, 0.0, 1.0)
        if isinstance(n, ast.Compare):
            cur, out = ev(n.left), None
            for op, comp in zip(n.ops, n.comparators):
                nxt = ev(comp)
                r = _CMPOPS[type(op)](cur, nxt)
                out = r if out is None else np.logical_and(out, r)
                cur = nxt
            return np.multiply(out, 1.0)
        if isinstance(n, ast.BoolOp):
            vals = [np.asarray(ev(v)) != 0 for v in n.values]
            out = vals[0]
            for v in vals[1:]:
                out = (np.logical_and(out, v) if isinstance(n.op, ast.And)
                       else np.logical_or(out, v))
            return np.multiply(out, 1.0)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in _FUNCS and not n.keywords:
            return _FUNCS[n.func.id](*[ev(a) for a in n.args])
        raise ScriptError(f"expression element {ast.dump(n)} not allowed")

    try:
        tree = ast.parse(expr, mode="eval")
        return ev(tree)
    except ScriptError:
        raise
    except Exception as err:
        raise ScriptError(f"cannot evaluate expression '{expr}': {err}") \
            from err


class EqualVariable:
    """equal-style variable: an expression re-evaluated on read
    (src/variable.cpp subset: arithmetic, math funcs, other variables,
    thermo keywords step/time/dt/atoms)."""

    style = "equal"

    def __init__(self, expr: str):
        self.expr = expr

    def evaluate(self, interp: "Interpreter") -> float:
        expr = interp.substitute(self.expr)
        sim = interp.sim
        env = {
            "step": sim.step_count, "time": sim.time_acc, "dt": sim.dt,
            "atoms": sim.natoms, "PI": math.pi,
        }
        # v_name references resolve through the interpreter (may recurse)
        for name in set(re.findall(r"\bv_(\w+)\b", expr)):
            env["v_" + name] = interp.var_value(name)
        try:
            return float(safe_eval(expr, env))
        except (TypeError, ValueError) as err:
            raise ScriptError(f"cannot evaluate variable expression "
                              f"'{self.expr}': {err}") from err


class AtomVariable:
    """atom-style variable: a per-atom vector expression over the particle
    fields (x, y, z, vx..., rho, e, cv, mass, type, id) — usable as a
    ``v_name`` dump column (src/variable.cpp atom style)."""

    style = "atom"

    def __init__(self, expr: str):
        self.expr = expr

    def evaluate_atom(self, interp: "Interpreter",
                      fields: Dict[str, np.ndarray]) -> np.ndarray:
        expr = interp.substitute(self.expr)
        sim = interp.sim
        env = dict(fields)
        env.update(step=sim.step_count, time=sim.time_acc, dt=sim.dt,
                   atoms=sim.natoms, PI=math.pi)
        for name in set(re.findall(r"\bv_(\w+)\b", expr)):
            v = interp.vars.get(name)
            if isinstance(v, AtomVariable):
                env["v_" + name] = v.evaluate_atom(interp, fields)
            else:
                env["v_" + name] = interp.var_value(name)
        out = safe_eval(expr, env)
        n = len(next(iter(fields.values()))) if fields else 0
        return np.broadcast_to(np.asarray(out, np.float64), (n,))


class Interpreter:
    """Runs input scripts on ``sim``, or on a ``Simulation`` of its own on
    ``device`` (the card by default: it raises where there is none)."""

    def __init__(self, sim: Optional[Simulation] = None,
                 variables: Optional[Dict[str, str]] = None, device=None):
        self.sim = sim if sim is not None else Simulation(device=device)
        self.vars: Dict[str, object] = dict(variables or {})
        self.regions: Dict[str, latmod.Region] = {}
        self.lattice_style = "sq"
        self.lattice_spacing = 1.0
        self.units = "lj"
        self.masses: Dict[int, float] = {}
        self._boundary = ("p", "p", "p")
        self._dim = 3
        self._pair_styles: List[List[str]] = []
        self.computes: Dict[str, tuple] = {}
        self.fixes: Dict[str, tuple] = {}
        self._warned: set = set()

    # ---------------------------------------------------------------- driver

    def run_file(self, path: str):
        with open(path) as f:
            self.run_string(f.read())

    def run_string(self, text: str):
        # join continuation lines (trailing &, like LAMMPS)
        text = re.sub(r"&\s*\n", " ", text)
        for line in text.splitlines():
            self.command(line)

    def command(self, line: str):
        i = line.find("#")
        if i >= 0:
            line = line[:i]
        line = line.strip()
        if not line:
            return
        line = self.substitute(line)
        toks = line.split()
        name = toks[0]
        handler = getattr(self, "cmd_" + name.replace("/", "_"), None)
        if handler is None:
            if name in _IGNORED:
                if name not in self._warned:
                    warnings.warn(f"tpusph_torch: ignoring command '{name}' "
                                  "(no meaning on one device)")
                    self._warned.add(name)
                return
            raise ScriptError(f"unknown command '{name}'")
        handler(toks[1:])

    def substitute(self, line: str) -> str:
        """${name} and $x substitution (Input::parse)."""
        def repl(m):
            name = m.group(1) or m.group(2)
            return str(self.var_value(name))
        return re.sub(r"\$\{(\w+)\}|\$(\w)", repl, line)

    def var_value(self, name: str):
        if name not in self.vars:
            raise ScriptError(f"undefined variable '{name}'")
        v = self.vars[name]
        if isinstance(v, AtomVariable):
            raise ScriptError(f"atom-style variable '{name}' is per-atom — "
                              "use it as a dump column, not a scalar")
        if isinstance(v, EqualVariable):
            return v.evaluate(self)
        return v

    # ------------------------------------------------------------- commands

    def cmd_units(self, a):
        self.units = a[0]

    def cmd_dimension(self, a):
        self._dim = int(a[0])
        self.sim.set_dimension(self._dim)

    def cmd_boundary(self, a):
        self._boundary = tuple(a[:3])

    def cmd_atom_style(self, a):
        if a[0] not in ("meso", "sph", "meso/multiphase"):
            raise ScriptError(f"unsupported atom_style '{a[0]}' "
                              "(this engine is SPH-only)")

    def cmd_lattice(self, a):
        self.lattice_style = a[0]
        val = _num(a[1])
        if self.units == "lj":
            # lj units: the argument is reduced density; constant = (n/rho)^(1/d)
            nbasis = {"sq": 1, "sq2": 2, "hex": 2, "sc": 1, "bcc": 2,
                      "fcc": 4, "hcp": 4}[a[0]]
            self.lattice_spacing = (nbasis / val) ** (1.0 / self._dim)
        else:
            self.lattice_spacing = val

    def cmd_region(self, a):
        rid, style = a[0], a[1]
        rest = a[2:]
        side = "in"
        if "side" in rest:
            k = rest.index("side")
            side = rest[k + 1]
        scale = self.lattice_spacing if "units" not in rest or \
            rest[rest.index("units") + 1] == "lattice" else 1.0
        if "units" in rest and rest[rest.index("units") + 1] == "box":
            scale = 1.0

        def c(tok):
            if tok in ("INF", "EDGE"):
                return math.inf
            if tok in ("-INF",):
                return -math.inf
            return _num(tok) * scale

        if style == "block":
            lo = [c(rest[0]), c(rest[2]), c(rest[4])]
            hi = [c(rest[1]), c(rest[3]), c(rest[5])]
            lo = [v if math.isfinite(v) else -1e30 for v in lo]
            hi = [v if math.isfinite(v) else 1e30 for v in hi]
            self.regions[rid] = latmod.Block(side=side, lo=lo, hi=hi)
        elif style == "sphere":
            self.regions[rid] = latmod.Sphere(
                side=side, center=[c(rest[0]), c(rest[1]), c(rest[2])],
                radius=c(rest[3]))
        elif style == "cylinder":
            self.regions[rid] = latmod.Cylinder(
                side=side, axis=rest[0],
                center=[c(rest[1]), c(rest[2])], radius=c(rest[3]),
                lo=c(rest[4]), hi=c(rest[5]))
        elif style == "prism":
            self.regions[rid] = latmod.Prism(
                side=side,
                lo=[c(rest[0]), c(rest[2]), c(rest[4])],
                hi=[c(rest[1]), c(rest[3]), c(rest[5])],
                xy=c(rest[6]), xz=c(rest[7]), yz=c(rest[8]))
        elif style == "union":
            n = int(rest[0])
            self.regions[rid] = latmod.Union(
                side=side, regions=[self.regions[r] for r in rest[1:1 + n]])
        elif style == "intersect":
            n = int(rest[0])
            self.regions[rid] = latmod.Intersect(
                side=side, regions=[self.regions[r] for r in rest[1:1 + n]])
        else:
            raise ScriptError(f"unsupported region style '{style}'")

    def cmd_create_box(self, a):
        ntypes = int(a[0])
        region = self.regions[a[1]]
        lo, hi = region.bbox()
        if self._dim == 2:
            lo[2], hi[2] = -0.5, 0.5
        periodic = tuple(b == "p" for b in self._boundary)
        self.sim.create_box(lo, hi, periodic=periodic, ntypes=ntypes)

    def cmd_create_atoms(self, a):
        type_ = int(a[0])
        mass = self.masses.get(type_, 1.0)
        if a[1] == "region":
            region = self.regions[a[2]]
            self.sim.create_atoms_lattice(type_, self.lattice_style,
                                          self.lattice_spacing, region,
                                          rmass=mass)
        elif a[1] == "box":
            region = latmod.Block(lo=self.sim.box.lo.cpu().numpy(),
                                  hi=self.sim.box.hi.cpu().numpy())
            self.sim.create_atoms_lattice(type_, self.lattice_style,
                                          self.lattice_spacing, region,
                                          rmass=mass)
        elif a[1] == "single":
            self.sim.add_particles(
                np.array([[float(a[2]), float(a[3]), float(a[4])]]),
                type_, rmass=mass)
        else:
            raise ScriptError(f"create_atoms mode '{a[1]}' unsupported")

    def cmd_mass(self, a):
        t = int(a[0])
        self.masses[t] = _num(a[1])
        # retroactively apply to already-created atoms of this type
        if self.sim._staged:
            mask = self.sim._staged["type"] == t
            if mask.any():
                self.sim.set_values(mask, rmass=_num(a[1]))

    def cmd_read_data(self, a):
        from tpusph_torch.io.data_files import read_data
        df = read_data(a[0])
        periodic = tuple(b == "p" for b in self._boundary)
        self.sim.create_box([df.xlo, df.ylo, df.zlo], [df.xhi, df.yhi, df.zhi],
                            periodic=periodic, ntypes=df.ntypes)
        rmass = np.array([df.masses.get(int(t), 1.0) for t in df.type],
                         np.float32)
        self.sim.add_particles(df.x, df.type, v=df.v, rho=df.rho, e=df.e,
                               cv=df.cv, rmass=rmass)
        self.masses.update(df.masses)

    def cmd_write_data(self, a):
        from tpusph_torch.io.data_files import write_data
        s = self.sim
        s._pull_state()
        st = s._staged
        write_data(a[0], box=s.box, tag=st["tag"], type=st["type"],
                   rho=st["rho"], e=st["e"], cv=st["cv"], x=st["x"],
                   v=st["v"], masses=self.masses)

    # -- groups / set -------------------------------------------------------

    def _mask_for(self, kind: str, arg: str) -> np.ndarray:
        st = self.sim._staged
        if kind == "region":
            return self.regions[arg].contains(st["x"])
        if kind == "type":
            types = set()
            for part in arg.split():
                if ":" in part:
                    lo, hi = part.split(":")
                    types.update(range(int(lo), int(hi) + 1))
                else:
                    types.add(int(part))
            return np.isin(st["type"], list(types))
        if kind == "id":
            return np.isin(st["tag"], [int(v) for v in arg.split()])
        raise ScriptError(f"unsupported group selector '{kind}'")

    def cmd_group(self, a):
        gid, kind = a[0], a[1]
        mask = self._mask_for(kind, " ".join(a[2:]))
        self.sim.define_group(gid, mask)

    def cmd_set(self, a):
        kind, arg = a[0], a[1]
        if kind == "group":
            mask = self.sim.group_mask(arg)
        else:
            mask = self._mask_for(kind, arg)
        kv = a[2:]
        fields = {}
        i = 0
        while i < len(kv):
            key, val = kv[i], kv[i + 1]
            m = {"meso/rho": "rho", "meso_rho": "rho", "meso/e": "e",
                 "meso/cv": "cv", "sph/rho": "rho", "sph/e": "e",
                 "sph/cv": "cv", "type": "type", "mass": "rmass"}.get(key)
            if m is None:
                raise ScriptError(f"set keyword '{key}' unsupported")
            fields[m] = int(val) if m == "type" else _num(val)
            i += 2
        self.sim.set_values(mask, **fields)

    def cmd_velocity(self, a):
        gid = a[0]
        mode = a[1]
        mask = self.sim.group_mask(gid)
        self.sim._pull_state()
        n = int(mask.sum())
        if mode == "set":
            # NULL means "leave this component unchanged" (velocity.cpp)
            v = self.sim._staged["v"][mask].astype(np.float32).copy()
            for d in range(3):
                tok = a[2 + d]
                if tok != "NULL":
                    v[:, d] = _num(tok)
        elif mode == "create":
            # velocity.cpp create, loop-all semantics: ONE RanMars stream
            # (random_mars.cpp — seed-level parity, tpusph/rng.py) walked
            # in tag order over ALL atoms; group members take the draws,
            # non-members burn them. Default dist uniform (vd = U-0.5),
            # `dist gaussian` supported; per-atom vscale = sqrt(T/m)
            # (kB = 1 raw units), then `mom yes` zeroing and an exact
            # rescale of the group temperature to the request.
            temp = _num(a[2])
            seed = int(a[3]) if len(a) > 3 else 12345
            dist = "uniform"
            i = 4
            while i < len(a):
                if a[i] == "dist" and i + 1 < len(a):
                    dist = a[i + 1]
                i += 2
            if dist not in ("uniform", "gaussian"):
                raise ScriptError(
                    f"velocity create dist '{dist}' not supported "
                    "(uniform, gaussian)")
            from tpusph_torch.rng import RanMars
            rng = RanMars(seed)
            dim = self.sim.spec.dim
            nall = self.sim.natoms
            # draws in tag order over all atoms (2 per atom in 2D)
            if dist == "gaussian":
                draws = rng.gaussian_batch(nall * dim).reshape(nall, dim)
            else:
                draws = rng.uniform_batch(nall * dim).reshape(nall, dim) - 0.5
            tags = self.sim._staged["tag"]
            order = np.argsort(tags, kind="stable")  # tag walk order
            vall = np.zeros((nall, 3), np.float32)
            vall[order, :dim] = draws
            m_all = self.sim._staged["rmass"]
            vall *= np.sqrt(temp / np.maximum(m_all, 1e-30))[:, None]
            v = vall[mask]
            m = m_all[mask]
            # momentum zeroing (default mom yes) on the group
            v -= (v * m[:, None]).sum(0) / max(m.sum(), 1e-30)
            # exact-T rescale: reference computes the generated group
            # temperature (dof = dim*(N-1) after momentum removal) and
            # scales so the realized temperature equals the request
            ke2 = float((m[:, None] * v * v).sum())
            dof = max(dim * (n - 1), 1)
            t_now = ke2 / dof
            if t_now > 0.0:
                v *= np.sqrt(temp / t_now)
            if dim == 2:
                v[:, 2] = 0.0
        else:
            raise ScriptError("velocity modes supported: set, create")
        arr = self.sim._staged["v"]
        arr[mask] = v
        self.sim._staged["v"] = arr
        self.sim.state = None

    # -- pair styles ---------------------------------------------------------

    def cmd_pair_style(self, a):
        if a[0] == "hybrid/overlay" or a[0] == "hybrid":
            styles, i = [], 1
            while i < len(a):
                s = [a[i]]
                i += 1
                while i < len(a) and not a[i].startswith("sph/"):
                    s.append(a[i])
                    i += 1
                styles.append(s)
        else:
            styles = [a]
        self._pair_styles = styles
        for s in styles:
            name = s[0]
            if name == "sph/rhosum":
                self.sim.pair_rhosum(int(s[1]) if len(s) > 1 else 1)
            elif name in ("sph/rhosum/multiphase", "sph/rhosum/nd"):
                self.sim.pair_rhosum(int(s[1]) if len(s) > 1 else 1,
                                     number_density=True)
            elif name == "sph/taitwater":
                self.sim.pair_taitwater(morris=False)
            elif name in ("sph/taitwater/morris", "sph/taitwater_morris"):
                self.sim.pair_taitwater(morris=True)
            elif name == "sph/idealgas":
                self.sim.pair_idealgas()
            elif name == "sph/lj":
                self.sim.pair_lj()
            elif name == "sph/heatconduction":
                self.sim.pair_heatconduction()
            elif name == "sph/heatconduction/phasechange":
                self.sim.pair_heatconduction(phasechange=True)
            elif name in ("sph/colorgradient",):
                pass  # activated together with surfacetension
            elif name in ("sph/surfacetension",):
                self.sim.pair_surfacetension()
            else:
                raise ScriptError(f"unsupported pair style '{name}'")

    def _type_range(self, tok: str):
        ntypes = self.sim.tables.ntypes
        if tok == "*":
            return range(1, ntypes + 1)
        if "*" in tok:
            lo, hi = tok.split("*")
            return range(int(lo) if lo else 1, (int(hi) if hi else ntypes) + 1)
        return [int(tok)]

    def cmd_pair_coeff(self, a):
        ii, jj = a[0], a[1]
        rest = a[2:]
        if rest and not _is_number(rest[0]):
            style, args = rest[0], [_num(v) for v in rest[1:]]
        elif len(self._pair_styles) == 1:
            style, args = self._pair_styles[0][0], [_num(v) for v in rest]
        else:
            raise ScriptError("hybrid pair_coeff needs the style name")
        t = self.sim.tables
        for i in self._type_range(ii):
            for j in self._type_range(jj):
                if j < i:
                    continue
                if style in ("sph/rhosum", "sph/rhosum/multiphase",
                             "sph/rhosum/nd"):
                    t.set_rhosum(i, j, h=args[0])
                elif style in ("sph/taitwater", "sph/taitwater/morris",
                               "sph/taitwater_morris"):
                    t.set_taitwater(i, j, rho0=args[0], c0=args[1],
                                    viscosity=args[2], h=args[3])
                elif style == "sph/idealgas":
                    t.set_idealgas(i, j, viscosity=args[0], h=args[1])
                elif style == "sph/lj":
                    t.set_lj(i, j, viscosity=args[0], h=args[1])
                elif style == "sph/heatconduction":
                    t.set_heatconduction(i, j, d=args[0], h=args[1])
                elif style == "sph/heatconduction/phasechange":
                    # pair_coeff I J D h [Tsat] — Tsat on the liquid/vapor
                    # cross pair pins that interface to the saturation point
                    t.set_heatconduction(
                        i, j, d=args[0], h=args[1],
                        tsat=args[2] if len(args) > 2 else 0.0)
                elif style in ("sph/surfacetension", "sph/colorgradient"):
                    # colorgradient h [alpha]; surfacetension sigma h
                    if style == "sph/colorgradient":
                        t._set2("cut_tension", i, j, args[0])
                    else:
                        t.set_surfacetension(i, j, sigma=args[0], h=args[1])
                else:
                    raise ScriptError(f"pair_coeff for unknown style '{style}'")

    # -- fixes ----------------------------------------------------------------

    def cmd_fix(self, a):
        fid, gid, style = a[0], a[1], a[2]
        rest = a[3:]
        self.fixes[fid] = (gid, style, rest)
        if style in ("meso", "sph"):
            pass  # default: all particles integrate
        elif style in ("meso/stationary", "sph/stationary"):
            self.sim.set_stationary(self.sim.group_mask(gid))
        elif style == "gravity":
            mag = _num(rest[0])
            if rest[1] != "vector":
                raise ScriptError("only 'fix gravity <mag> vector x y z'")
            vec = np.array([_num(rest[2]), _num(rest[3]), _num(rest[4])])
            nrm = np.linalg.norm(vec)
            g = mag * vec / nrm if nrm > 0 else vec * 0
            self.sim.tables.set_gravity(g)
            self.sim.spec = dataclasses.replace(self.sim.spec, gravity=True)
        elif style == "phase_change":
            from tpusph_torch.ops.phase_change import PhaseChangeConfig
            self.sim.configure_phase_change(
                PhaseChangeConfig.from_script_args(rest))
        else:
            raise ScriptError(f"unsupported fix style '{style}'")

    def cmd_unfix(self, a):
        fid = a[0]
        if fid in self.fixes:
            gid, style, rest = self.fixes.pop(fid)
            if style == "gravity":
                self.sim.spec = dataclasses.replace(self.sim.spec,
                                                    gravity=False)
            elif style == "phase_change":
                self.sim.remove_end_of_step_hook("phase_change")
                self.sim.phase_change_config = None
                self.sim.spec = dataclasses.replace(self.sim.spec,
                                                    phase_change=False)

    def cmd_compute(self, a):
        cid, gid, style = a[0], a[1], a[2]
        field = {"meso/rho/atom": "rho", "meso/e/atom": "e",
                 "meso/t/atom": "t", "sph/rho/atom": "rho",
                 "sph/e/atom": "e", "sph/t/atom": "t"}.get(style)
        if field is None:
            raise ScriptError(f"unsupported compute style '{style}'")
        self.computes[cid] = (gid, field)

    # -- time / output ---------------------------------------------------------

    def cmd_balance(self, a):
        """balance <thresh> shift <dims> <niter> <stopthresh>: the cut
        planes move to the particle-count quantiles whatever the iteration
        knobs (one exact shift pass; balance.cpp converges to the same
        planes). ``Simulation.balance``; no-op without bricks."""
        self.sim.balance()

    def cmd_timestep(self, a):
        self.sim.dt = _num(a[0])

    def cmd_neighbor(self, a):
        self.sim.neighbor_skin = _num(a[0])

    def cmd_neigh_modify(self, a):
        i = 0
        while i < len(a):
            if a[i] == "every":
                self.sim.reneigh_every = int(a[i + 1])
                i += 2
            elif a[i] in ("delay", "check", "once", "page"):
                i += 2
            else:
                i += 1

    def cmd_thermo(self, a):
        self.sim.thermo(int(a[0]))

    def cmd_thermo_style(self, a):
        if a[0] != "custom":
            raise ScriptError("only 'thermo_style custom ...' supported")
        cols = list(a[1:])
        for c in cols:
            if c.startswith("v_"):
                name = c[2:]
                self.sim.add_thermo_column(
                    c, lambda sim, sc, istep, _n=name: self.var_value(_n))
        self.sim.thermo_style(cols)

    def cmd_thermo_modify(self, a):
        # src/thermo.cpp modify_params: `norm yes|no` changes extensive-
        # column normalization (ke/pe/etotal printed per atom). Other knobs
        # (flush, lost, format) are accepted and have no effect.
        i = 0
        while i < len(a):
            if a[i] == "norm":
                if i + 1 >= len(a) or a[i + 1] not in ("yes", "no"):
                    raise ScriptError("thermo_modify norm expects yes|no")
                self.sim.thermo_norm = a[i + 1] == "yes"
                i += 2
            elif a[i] in ("flush", "lost"):
                i += 2
            elif a[i] == "format":
                i += 3
            else:
                i += 2  # unknown knob + value: accepted

    def cmd_log(self, a):
        # src/lammps.cpp `log` command: redirect the thermo log mirror.
        # `log none` closes it. Takes effect for subsequent runs (the
        # writer re-opens with the new path).
        path = a[0] if a else "log.lammps"
        self.sim.log_path = None if path == "none" else path
        self.sim._thermo = None  # re-open the writer with the new path

    def cmd_dump_modify(self, a):
        # `dump_modify <id> sort id` — dumps are ALWAYS written in tag
        # order here (io/dump.py), so `sort id` is validated-and-satisfied;
        # any other sort mode cannot be honored and fails loudly.
        if not a:
            raise ScriptError("dump_modify needs a dump id")
        i = 1
        while i < len(a):
            if a[i] == "sort":
                if i + 1 >= len(a) or a[i + 1] != "id":
                    raise ScriptError(
                        "dump_modify sort: only 'id' is supported (dumps "
                        "are always tag-ordered)")
                i += 2
            else:
                i += 2  # first/pad/every/format knobs: accepted

    def cmd_variable(self, a):
        name, kind = a[0], a[1]
        if kind == "equal":
            self.vars[name] = EqualVariable(" ".join(a[2:]))
        elif kind == "atom":
            self.vars[name] = AtomVariable(" ".join(a[2:]))
        elif kind == "index":
            # LAMMPS: index vars do NOT overwrite an existing definition —
            # that's how `-var name value` overrides a script default
            if name not in self.vars:
                self.vars[name] = a[2]
        elif kind == "string":
            self.vars[name] = a[2]
        elif kind == "delete":
            self.vars.pop(name, None)
        else:
            raise ScriptError(f"variable style '{kind}' unsupported")

    def cmd_print(self, a):
        print(" ".join(a).strip('"'))

    def cmd_dump(self, a):
        from tpusph_torch.io.dump import Dump
        did, gid, style, every, path = a[0], a[1], a[2], int(a[3]), a[4]
        cols = list(a[5:]) if style == "custom" else None
        self.sim.dumps.append(Dump(did, style, every, path, cols,
                                   computes=self.computes,
                                   var_context=self))

    def cmd_undump(self, a):
        self.sim.dumps = [d for d in self.sim.dumps if d.id != a[0]]

    def cmd_run(self, a):
        n = int(a[0])
        if len(a) >= 2 and a[1] == "upto":
            n = max(n - self.sim.step_count, 0)
        self.sim.run(n)

    def cmd_reset_timestep(self, a):
        self.sim.step_count = int(a[0])

    def cmd_write_restart(self, a):
        from tpusph_torch.io.restart import write_restart
        write_restart(a[0], self.sim)

    def cmd_read_restart(self, a):
        from tpusph_torch.io.restart import read_restart
        read_restart(a[0], self.sim)

    def cmd_restart(self, a):
        from tpusph_torch.io.restart import RestartSchedule
        self.sim.restart_schedule = RestartSchedule(int(a[0]), a[1])

    def cmd_pair_modify(self, a):
        pass

    def cmd_clear(self, a):
        self.sim = Simulation(device=self.sim.device)
        self.regions.clear()
        self.computes.clear()
        self.fixes.clear()


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False
