"""The port's pair physics of record (``tpusph_torch.ops.pair_terms``) and
its dense backend (``tpusph_torch.ops.dense``) against the JAX package's
``tpusph.ops.dense`` on the same numpy inputs, for every physics branch;
``pair_terms`` against the sweeps' body (``ops/tile_physics``) on the same
pairs; the dense vapor query against ``_vapor_neighbor_dense``; the ``auto``
rung; and the port of tests/test_dense_ops.py.

Bars: rho to 2e-5 and the other outputs to 2e-4 of the output row's
largest magnitude (float32 sums in another order); the vapor query exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.ops import dense as jdense
from tpusph.ops.phase_change import _vapor_neighbor_dense as j_vapor
from tpusph.params import PairTables as JTables
from tpusph.params import PhysicsSpec as JSpec
from tpusph.state import Box as JBox
from tpusph.state import ParticleState as JState

from tpusph_torch import kernels
from tpusph_torch.api import Simulation
from tpusph_torch.ops import dense, pair_terms, tile_physics
from tpusph_torch.ops.dense import DenseBackend
from tpusph_torch.ops.phase_change import _vapor_neighbor_dense
from tpusph_torch.ops.rows import (
    RCGX, RCGY, RCGZ, RCV, RE, RM, RRHO, RTYPE, RVX, RVY, RVZ, RX, RY, RZ,
    TABLES_2D,
)
from tpusph_torch.ops.strip_pair import StripBackend
from tpusph_torch.params import PairTables, PhysicsSpec
from tpusph_torch.state import Box, state_from_arrays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def system(n=60, ntypes=2, seed=0, box_l=3.0, dim=3, periodic=True, cap=80):
    """Random particles (types, velocities, densities, energies, masses)
    as numpy arrays, with ``cap - n`` dead slots."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box_l, (n, 3)).astype(np.float32)
    v = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    if dim == 2:
        x[:, 2] = 0.0
        v[:, 2] = 0.0
    per = (periodic, periodic, periodic if dim == 3 else False)
    return dict(
        x=x, v=v, type=rng.integers(1, ntypes + 1, n).astype(np.int32),
        rho=rng.uniform(0.9, 1.1, n).astype(np.float32),
        e=rng.uniform(0.5, 1.5, n).astype(np.float32),
        cv=rng.uniform(0.8, 1.2, n).astype(np.float32),
        rmass=rng.uniform(0.2, 0.4, n).astype(np.float32),
        lo=[0.0] * 3, hi=[box_l, box_l, box_l if dim == 3 else 1.0],
        periodic=per, cap=cap)


def both_states(s):
    kw = dict(v=s["v"], rho=s["rho"], e=s["e"], cv=s["cv"],
              capacity=s["cap"])
    js = JState.from_arrays(s["x"], s["type"], rmass=s["rmass"], **kw)
    ps = state_from_arrays(s["x"], s["type"], s["rmass"], device="cpu",
                           **kw)
    jb = JBox.create(s["lo"], s["hi"], periodic=s["periodic"])
    pb = Box.create(s["lo"], s["hi"], periodic=s["periodic"])
    return js, jb, ps, pb


def both_tables(ntypes, setup):
    jt, pt = JTables.zeros(ntypes), PairTables.zeros(ntypes)
    for t in (jt, pt):
        setup(t)
    return jt, pt


def close(a, b, bar, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max()) / scale
    assert err <= bar, (what, err)


H = 1.2


def _tait(t):
    for i, j in ((1, 2), (1, 1), (2, 2)):
        t.set_taitwater(i, j, rho0=1.0 if i == 1 else 0.8, c0=5.0,
                        viscosity=0.3, h=H)


def _gas(setter):
    def setup(t):
        for i, j in ((1, 1), (1, 2), (2, 2)):
            getattr(t, setter)(i, j, viscosity=0.3, h=H)
    return setup


def _heat(tsat):
    def setup(t):
        for i, j in ((1, 1), (1, 2), (2, 2)):
            t.set_heatconduction(i, j, d=0.2, h=H * 1.1,
                                 tsat=tsat if i != j else 0.0)
    return setup


def _csf(t):
    _tait(t)
    t.set_surfacetension(1, 2, sigma=0.5, h=H * 0.9)


def _all(t):
    _csf(t)
    _heat(1.5)(t)
    for i, j in ((1, 1), (1, 2), (2, 2)):
        t.set_rhosum(i, j, h=H)


# (id, spec fields, table setup, system options)
BRANCHES = [
    ("tait", dict(tait=True), _tait, {}),
    ("morris-virial", dict(morris=True, virial=True), _tait, {}),
    ("idealgas", dict(ideal_gas=True), _gas("set_idealgas"), {}),
    ("lj", dict(lj=True), _gas("set_lj"), {}),
    ("heat", dict(heatconduction=True), _heat(0.0), {}),
    ("heat-phasechange", dict(heat_phasechange=True), _heat(1.5), {}),
    ("csf-2d-open", dict(tait=True, surface_tension=True, dim=2), _csf,
     dict(dim=2, periodic=False)),
    ("rhosum-all-cubic", dict(tait=True, surface_tension=True,
                              heat_phasechange=True, rhosum_every=1,
                              virial=True,
                              kernel=kernels.CUBIC_SPLINE), _all, {}),
    ("rhosum-nd-quintic-open", dict(tait=True, rhosum_every=1,
                                    rhosum_nd=True,
                                    kernel=kernels.QUINTIC_SPLINE), _all,
     dict(periodic=False)),
    ("wendland-2d", dict(morris=True, heatconduction=True, rhosum_every=1,
                         dim=2, kernel=kernels.WENDLAND_C2), _all,
     dict(dim=2)),
]


@pytest.mark.parametrize("name,fields,setup,opts", BRANCHES,
                         ids=[b[0] for b in BRANCHES])
def test_dense_matches_reference(name, fields, setup, opts):
    """rho (when rhosum is on), the colour gradient (when surface tension
    is on) and f, drho, de (and vir) against ``tpusph.ops.dense``."""
    s = system(**opts)
    js, jb, ps, pb = both_states(s)
    jt, pt = both_tables(2, setup)
    jspec, pspec = JSpec(**fields), PhysicsSpec(**fields)
    tabs = pt.stacked("cpu")
    if pspec.rhosum_every:
        a = np.array(jdense.rho_summation(js, jt, jspec, jb))
        b = dense.rho_summation(ps, tabs, pspec, pb).numpy()
        close(b, a, 2e-5, "rho")
        js = dataclasses.replace(js, rho=jnp.asarray(a))
        ps = dataclasses.replace(ps, rho=torch.as_tensor(a))
    jcg = pcg = None
    if pspec.surface_tension:
        jcg = jdense.color_gradient(js, jt, jspec, jb)
        pcg = dense.color_gradient(ps, tabs, pspec, pb)
        assert float(np.abs(np.asarray(jcg)).max()) > 0
        close(pcg.numpy(), np.asarray(jcg), 2e-4, "cg")
        pcg = torch.as_tensor(np.array(jcg))
    ja = jdense.force(js, jt, jspec, jb, cg=jcg)
    pa = dense.force(ps, tabs, pspec, pb, cg=pcg)
    assert len(ja) == len(pa) == (4 if pspec.virial else 3)
    names = ("f", "drho", "de", "vir")
    for k, (a, b) in enumerate(zip(ja, pa)):
        a = np.asarray(a)
        if np.abs(a).max() == 0:
            assert np.abs(b.numpy()).max() == 0, names[k]
            continue
        if a.ndim == 2:
            for d in range(3 if fields.get("dim", 3) == 3 else 2):
                close(b.numpy()[:, d], a[:, d], 2e-4, f"f{d}")
        else:
            close(b.numpy(), a, 2e-4, names[k])
    # dead slots stay zero
    assert np.abs(pa[0].numpy()[60:]).max() == 0


def _pair_fields(ps, cg):
    """The strip-sweep field rows of the state (dict keyed by row id)."""
    return {RX: ps.x[:, 0], RY: ps.x[:, 1], RZ: ps.x[:, 2], RM: ps.rmass,
            RTYPE: ps.type.float(), RRHO: ps.rho, RVX: ps.vest[:, 0],
            RVY: ps.vest[:, 1], RVZ: ps.vest[:, 2], RE: ps.e, RCV: ps.cv,
            RCGX: cg[:, 0], RCGY: cg[:, 1], RCGZ: cg[:, 2]}


@pytest.mark.parametrize("name,fields,setup,opts", BRANCHES,
                         ids=[b[0] for b in BRANCHES])
def test_pair_terms_match_tile_physics(name, fields, setup, opts):
    """The statement of record and the sweeps' body on the same pairs
    (every alive i != j pair within the force cutoff): per pair, f, drho,
    de (and vir), the colour gradient and the rho term."""
    s = system(**opts)
    _, _, ps, pb = both_states(s)
    pt = PairTables.zeros(2)
    setup(pt)
    pspec = PhysicsSpec(**fields)
    tabs = pt.stacked("cpu")
    cg = dense.color_gradient(ps, tabs, pspec, pb) \
        if pspec.surface_tension else torch.zeros_like(ps.x)
    fld = _pair_fields(ps, cg)
    for sweep, key in (("force", "force"), ("cgrad", "cgrad"),
                       ("rho", "rho")):
        if tabs.cutmax2[key] == 0.0:
            continue
        ib, jb, dx, rsq = dense.pair_list(ps, pb, tabs.cutmax2[key])
        fi = {k: v[ib] for k, v in fld.items()}
        fj = {k: v[jb] for k, v in fld.items()}
        h = tile_physics.hoist_i(fld, tabs.tab1, pspec, sweep)
        h = {k: v[ib] for k, v in h.items()}
        lk = tile_physics.Lookups(tabs.tab2, tabs.tab1, pspec,
                                  ps.type[ib].long(), ps.type[jb].long())
        tile = tile_physics.tile_part_sums(
            fi, fj, h, (dx[:, 0], dx[:, 1], dx[:, 2]), rsq, lk, pspec,
            sweep)
        f = dense._fields(ps)
        pi = {k: v[ib] for k, v in f.items()}
        pj = {k: v[jb] for k, v in f.items()}
        coefs = pair_terms.make_pair_coefs(tabs, pi["type"], pj["type"])
        mask = torch.ones_like(rsq, dtype=torch.bool)
        if sweep == "force":
            out = pair_terms.force_pair(pi, pj, dx, rsq, mask, coefs, pspec,
                                        cg_i=cg[ib], cg_j=cg[jb])
            rec = [out["f"][:, 0], out["f"][:, 1], out["f"][:, 2],
                   out["drho"], out["de"]]
            if pspec.virial:
                rec.append(out["vir"])
        elif sweep == "cgrad":
            r = torch.sqrt(torch.clamp(rsq, min=1e-30))
            out = pair_terms.color_gradient_pair(pi, pj, dx, r, coefs, mask,
                                                 pspec)
            rec = [out[:, 0], out[:, 1], out[:, 2]]
        else:
            cut = tabs.tab2[TABLES_2D.index("cut_rho")][pi["type"],
                                                         pj["type"]]
            r = torch.sqrt(torch.clamp(rsq, min=0.0))
            rec = [pair_terms.rho_summation_pair(pj, r, cut, rsq < cut * cut,
                                                 pspec)]
        assert len(rec) == len(tile)
        for k, (a, b) in enumerate(zip(rec, tile)):
            if float(a.abs().max()) == 0.0:
                assert float(b.abs().max()) == 0.0, (sweep, k)
                continue
            close(b.numpy(), a.numpy(), 2e-5 if sweep == "rho" else 2e-4,
                  f"{sweep}[{k}]")


@pytest.mark.parametrize("lattice,dim", [(True, 3), (False, 3), (True, 2)])
def test_dense_vapor_query_exact(lattice, dim):
    """``_vapor_neighbor_dense`` against the JAX package's (jitted, as its
    step runs it), element for element: count, nearest (its tie rule on an
    exact lattice), rsq, and the owned-only pair with some rows marked
    seam copies."""
    rng = np.random.default_rng(4)
    side, dx = 8, 0.5
    ax = np.arange(side, dtype=np.float32) * dx
    axes = [ax, ax, ax if dim == 3 else np.zeros(1, np.float32)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    if not lattice:
        g = (g + rng.uniform(-0.1, 0.1, g.shape)).astype(np.float32)
        if dim == 2:
            g[:, 2] = 0
    n = len(g)
    t = np.where(rng.uniform(size=n) < 0.4, 2, 1).astype(np.int32)
    per = (True, True, dim == 3)
    hi = [side * dx, side * dx, side * dx if dim == 3 else 1.0]
    js = JState.from_arrays(g, t, rmass=np.ones(n), capacity=n + 32)
    ps = state_from_arrays(g, t, np.ones(n, np.float32), capacity=n + 32,
                           device="cpu")
    owned = np.ones(n + 32, bool)
    owned[rng.integers(0, n, 20)] = False
    js = dataclasses.replace(js, owned=jnp.asarray(owned))
    ps = dataclasses.replace(ps, owned=torch.as_tensor(owned))
    cut = 1.0
    jbox = JBox.create([0, 0, 0], hi, periodic=per)
    # jitted, as the reference's step runs it (eager JAX forms rsq without
    # the fused multiply-adds)
    a = jax.jit(lambda st: j_vapor(st, jbox, 2, cut))(js)
    b = _vapor_neighbor_dense(ps, Box.create([0, 0, 0], hi, periodic=per),
                              2, cut)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                      err_msg=str(k))
    assert int(b[0].sum()) > 0


def lattice_sim(n_keep):
    """A 13^3 lattice (spacing 1, Tait at h 2.4) cut to its first
    ``n_keep`` particles."""
    sim = Simulation(screen=False, device="cpu")
    sim.create_box([0, 0, 0], [13.0] * 3, ntypes=1)
    ax = np.arange(13, dtype=np.float32) + 0.5
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    sim.add_particles(g[:n_keep], 1, rho=1.0, rmass=1.0)
    sim.pair_taitwater()
    sim.tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=0.1, h=2.4)
    return sim


def test_auto_takes_dense_up_to_2048():
    """``auto`` takes the dense rung at 2,048 particles and the strip at
    2,049, as ``tpusph``'s ``_select_backend`` does; "dense" asks for it
    at any size."""
    assert isinstance(lattice_sim(2048)._select_backend(), DenseBackend)
    assert isinstance(lattice_sim(2049)._select_backend(), StripBackend)
    big = lattice_sim(2197)
    big.backend_name = "dense"
    assert isinstance(big._select_backend(), DenseBackend)


# ------------------------------------------------ tests/test_dense_ops.py

def make_random_state(n=64, ntypes=1, seed=0, box_l=4.0, dim=3, vel=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box_l, size=(n, 3)).astype(np.float32)
    if dim == 2:
        x[:, 2] = 0.0
    types = rng.integers(1, ntypes + 1, size=n)
    v = rng.normal(0, 0.1, size=(n, 3)).astype(np.float32) if vel else None
    if v is not None and dim == 2:
        v[:, 2] = 0.0
    st = state_from_arrays(
        x, types, np.full(n, 0.3), v=v, rho=np.full(n, 1.1),
        e=rng.uniform(0.5, 1.5, n), cv=np.full(n, 1.0), capacity=n,
        device="cpu")
    per = (True, True, True) if dim == 3 else (True, True, False)
    box = Box.create([0, 0, 0], [box_l, box_l, box_l if dim == 3 else 1.0],
                     periodic=per)
    return st, box


def pstate(x, types, **kw):
    x = np.asarray(x, np.float32)
    n = len(x)
    return state_from_arrays(x, np.asarray(types), np.asarray(
        kw.pop("rmass")), capacity=kw.pop("capacity", n), device="cpu", **kw)


def test_rho_summation_uniform_lattice_approximates_density():
    nside, dx, rho0 = 8, 0.5, 1.0
    m = rho0 * dx**3
    grid = np.stack(np.meshgrid(*[np.arange(nside) * dx] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float32)
    n = grid.shape[0]
    st = pstate(grid, np.ones(n), rmass=np.full(n, m), rho=np.full(n, rho0))
    box = Box.create([0, 0, 0], [nside * dx] * 3)
    tables = PairTables.zeros(1)
    tables.set_rhosum(1, 1, h=3.0 * dx)
    spec = PhysicsSpec(dim=3, kernel=kernels.QUINTIC_SPLINE)
    rho = dense.rho_summation(st, tables.stacked("cpu"), spec, box).numpy()
    np.testing.assert_allclose(rho, rho0, rtol=2e-2)


def test_tait_eos_pressure_values():
    tables = PairTables.zeros(1)
    tables.set_taitwater(1, 1, rho0=1000.0, c0=10.0, viscosity=0.0, h=1.0)
    spec = PhysicsSpec(tait=True)
    rho = torch.tensor([1000.0, 1100.0, 900.0])
    p_over, p = pair_terms.eos_pressure_over_rhosq(
        rho, torch.zeros(3), torch.ones(3), float(tables.rho0[1]),
        float(tables.tait_b[1]), float(tables.gas_gamma[1]), spec)
    b = 10.0**2 * 1000.0 / 7.0
    expect = b * ((np.array([1000.0, 1100, 900]) / 1000.0) ** 7 - 1.0)
    np.testing.assert_allclose(p.numpy(), expect, rtol=1e-5)
    np.testing.assert_allclose(p_over.numpy(), expect / rho.numpy()**2,
                               rtol=1e-5)


@pytest.mark.parametrize("morris", [False, True])
def test_momentum_conservation(morris):
    st, box = make_random_state(n=48, seed=1)
    tables = PairTables.zeros(1)
    tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=0.5, h=1.2)
    spec = PhysicsSpec(tait=not morris, morris=morris, kernel=kernels.LUCY)
    f, drho, de = dense.force(st, tables.stacked("cpu"), spec, box)
    np.testing.assert_allclose(f.sum(0).numpy(), 0.0, atol=5e-4)


def test_heatconduction_conserves_energy_and_directs_heat():
    st, box = make_random_state(n=40, seed=2, vel=False)
    tables = PairTables.zeros(1)
    tables.set_heatconduction(1, 1, d=0.3, h=1.5)
    spec = PhysicsSpec(heatconduction=True, tait=False, continuity=False)
    tabs = tables.stacked("cpu")
    f, drho, de = dense.force(st, tabs, spec, box)
    assert float(de.sum()) == pytest.approx(0.0, abs=1e-4)
    assert np.allclose(f.numpy(), 0.0)
    assert np.allclose(drho.numpy(), 0.0)
    x = np.array([[0.0, 0, 0], [0.5, 0, 0]], np.float32)
    st2 = pstate(x, [1, 1], rmass=[1.0, 1.0], rho=[1.0, 1.0], e=[2.0, 1.0])
    box2 = Box.create([-2, -2, -2], [2, 2, 2], periodic=(False,) * 3)
    _, _, de2 = dense.force(st2, tabs, spec, box2)
    assert float(de2[0]) < 0.0 < float(de2[1])
    assert float(de2[0] + de2[1]) == pytest.approx(0.0, abs=1e-6)


def test_continuity_drho_sign():
    x = np.array([[0.0, 0, 0], [1.0, 0, 0]], np.float32)
    v = np.array([[0.5, 0, 0], [-0.5, 0, 0]], np.float32)
    st = pstate(x, [1, 1], rmass=[1.0, 1.0], v=v, rho=[1.0, 1.0])
    box = Box.create([-3, -3, -3], [3, 3, 3], periodic=(False,) * 3)
    tables = PairTables.zeros(1)
    tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=0.0, h=2.0)
    _, drho, _ = dense.force(st, tables.stacked("cpu"),
                             PhysicsSpec(tait=True), box)
    assert float(drho[0]) > 0.0 and float(drho[1]) > 0.0


def test_artificial_viscosity_only_when_approaching():
    tables = PairTables.zeros(1)
    tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=1.0, h=2.0)
    tabs = tables.stacked("cpu")
    box = Box.create([-5, -5, -5], [5, 5, 5], periodic=(False,) * 3)
    x = np.array([[0.0, 0, 0], [1.0, 0, 0]], np.float32)

    def fx(v0):
        v = np.array([[v0, 0, 0], [-v0, 0, 0]], np.float32)
        st = pstate(x, [1, 1], rmass=[1.0, 1.0], v=v, rho=[1.0, 1.0])
        f, _, _ = dense.force(st, tabs, PhysicsSpec(tait=True), box)
        return float(f[0, 0])

    assert fx(-0.5) == pytest.approx(0.0, abs=1e-7)
    assert fx(0.5) < -1e-5


def test_dead_slots_do_not_contribute():
    st, box = make_random_state(n=32, seed=3)
    tables = PairTables.zeros(1)
    tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=0.2, h=1.2)
    tables.set_heatconduction(1, 1, d=0.1, h=1.2)
    spec = PhysicsSpec(tait=True, heatconduction=True)
    tabs = tables.stacked("cpu")
    f_full, _, de_full = dense.force(st, tabs, spec, box)
    big = state_from_arrays(st.x.numpy(), st.type.numpy(), st.rmass.numpy(),
                            v=st.v.numpy(), rho=st.rho.numpy(),
                            e=st.e.numpy(), cv=st.cv.numpy(), capacity=64,
                            device="cpu")
    f_big, _, de_big = dense.force(big, tabs, spec, box)
    np.testing.assert_allclose(f_big[:32].numpy(), f_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(f_big[32:].numpy(), 0.0)
    assert not np.isnan(f_big.numpy()).any()
    np.testing.assert_allclose(de_big[:32].numpy(), de_full.numpy(),
                               atol=1e-5)


def test_surface_tension_momentum_conservation_and_interface_only():
    rng = np.random.default_rng(5)
    n = 60
    x = rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32)
    types = np.where(x[:, 0] < 1.5, 1, 2)
    st = pstate(x, types, rmass=np.full(n, 0.2), rho=np.full(n, 1.0))
    box = Box.create([0, 0, 0], [3, 3, 3], periodic=(False,) * 3)
    tables = PairTables.zeros(2)
    for i in (1, 2):
        for j in (1, 2):
            if j >= i:
                tables.set_surfacetension(i, j, sigma=1.0, h=1.0)
    spec = PhysicsSpec(surface_tension=True, tait=False, continuity=False)
    tabs = tables.stacked("cpu")
    cg = dense.color_gradient(st, tabs, spec, box)
    assert float(cg.abs().max()) > 0.0
    f, _, _ = dense.force(st, tabs, spec, box, cg=cg)
    np.testing.assert_allclose(f.sum(0).numpy(), 0.0, atol=2e-4)


def test_lj_eos_values_and_momentum():
    spec = PhysicsSpec(dim=3, lj=True, tait=False)
    rho, e, m, gamma = 0.2, 1.5, 1.0, 1.4
    _, p = pair_terms.eos_pressure_over_rhosq(
        torch.tensor(rho), torch.tensor(e), torch.tensor(m),
        torch.tensor(1.0), torch.tensor(0.0), torch.tensor(gamma), spec)
    t = (gamma - 1.0) * e / m
    expect = (rho * t / (1.0 - pair_terms.LJ_VDW_B * rho)
              - pair_terms.LJ_VDW_A * rho * rho)
    assert float(p) == pytest.approx(expect, rel=1e-6)
    st, box = make_random_state(n=48, seed=3)
    tables = PairTables.zeros(1)
    tables.set_lj(1, 1, viscosity=0.5, h=1.0)
    f, drho, de = dense.force(st, tables.stacked("cpu"), spec, box)
    np.testing.assert_allclose(f.sum(0).numpy(), 0.0, atol=1e-4)
    assert np.isfinite(f.numpy()).all()


# ------------------------------------------ tests/test_heat_phasechange.py

def make_slab(pin_tsat):
    """A liquid slab (x < 4) against a vapour slab (x >= 4), both at T = 3,
    conduction across the interface only, 1,500 steps on the dense rung
    (tests/test_heat_phasechange.py's system; the reference runs it on its
    cell grid)."""
    sim = Simulation(dim=2, screen=False, device="cpu")
    sim.backend_name = "dense"
    dx = 0.5
    nx, ny = 16, 8
    ax = np.arange(nx) * dx
    ay = np.arange(ny) * dx
    g = np.stack(np.meshgrid(ax, ay, indexing="ij"), -1).reshape(-1, 2)
    types = np.where(g[:, 0] < 4.0, 1, 2).astype(np.int32)
    sim.create_box([0, 0, 0], [nx * dx, ny * dx, 1.0],
                   periodic=(False, True, False), ntypes=2)
    sim.add_particles(g.astype(np.float32), types, rho=1.0, e=3.0, cv=1.0,
                      rmass=0.25)
    sim.pair_heatconduction(phasechange=True)
    sim.tables.set_heatconduction(1, 2, d=0.4, h=2.2 * dx,
                                  tsat=2.0 if pin_tsat else 0.0)
    sim.dt = 2e-3
    sim.thermo(0)
    sim.run(1500)
    return sim


def test_interface_pins_to_tsat_bulk_stays_hot():
    sim = make_slab(pin_tsat=True)
    x, T, types = sim.get("x"), sim.get("t"), sim.get("type")
    liquid = types == 1
    interface = liquid & (x[:, 0] > 3.3)
    bulk = liquid & (x[:, 0] < 2.0)
    assert 1.8 < float(T[interface].mean()) < 2.2
    np.testing.assert_allclose(T[bulk], 3.0, rtol=1e-5)


def test_without_tsat_uniform_t_is_inert():
    np.testing.assert_allclose(make_slab(pin_tsat=False).get("t"), 3.0,
                               rtol=1e-5)
