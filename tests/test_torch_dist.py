"""Bricks in the torch port (``tpusph_torch.dist``, ``Simulation.set_mesh``
/ ``balance``) on the CPU, against the JAX package.

The port's bricks are a list of per-brick states in one process, all on
``cpu`` here (the counterpart of the JAX package's eight virtual devices).
The JAX package's own bricks are never run (their ``shard_map`` compile is
too slow for this suite): every N-brick trajectory is held to the JAX
package's ONE-device cell-grid run of the same script, at the bars of
tests/test_dist.py: minimum-image x to 5e-4 (1e-3 for the dam break); v to
5e-4; rho rtol 1e-4 (2e-4 for the strip and column inners, the 8-brick
cube and the balanced run, 5e-4 for the dam break); e rtol 1e-4 / atol
1e-5 (2e-4 for the strip inner); the same tags and natoms.

The host half of ``dist.py`` equals the reference's field for field
(``make_brick_spec``, ``choose_brick_shape``, ``compute_balance_cuts``,
``choose_strip_geometry_dist``, ``brick_local_positions`` /
``partition_state`` / ``globalize_positions``), and one rebuild's ghosts
are held to a brute-force numpy construction.

Phase change and the recovery loop in bricks mirror
tests/test_dist_phase_change.py and tests/test_dist_recovery.py under
``-m slow``, as those are marked; one insert-mode case at prob = 1 stays
in tier 1."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph import dist as jdist
from tpusph.api import Simulation as JSimulation
from tpusph.ops.phase_change import PhaseChangeConfig as JConfig
from tpusph.script import Interpreter as JInterpreter
from tpusph.state import Box as JBox

from tpusph_torch import dist
from tpusph_torch.api import Simulation
from tpusph_torch.bench import build_bench_sim, build_bubble_sim
from tpusph_torch.ops.cellgrid import CellGridBackend
from tpusph_torch.ops.pallas_pair import PallasBackend
from tpusph_torch.ops.strip_pair import StripBackend
from tpusph_torch.script import Interpreter
from tpusph_torch.state import Box, state_from_arrays, state_to_numpy

from test_dist import DAM_DIST_SCRIPT, PERIODIC_SCRIPT


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _min_image(d, L):
    L = np.asarray(L, np.float64)
    return d - L * np.round(d / L)


# ------------------------------------------------------------ the host half

BOXES = {
    "slab": ([0, 0, 0], [3.2, 1.6, 1.0], (True, True, True)),
    "narrow": ([0, 0, 0], [3.2, 1.6, 1.0], (True, True, True)),
    "cube": ([0, 0, 0], [1.2, 1.2, 1.2], (True, True, True)),
    "dam": ([0, 0, -0.05], [4.0, 1.5, 0.05], (False, False, True)),
}
SPEC_CASES = [
    # (box, ndev, cutoff, skin, shape, axes, cuts)
    ("slab", 4, 0.3, 0.1, None, None, None),
    ("narrow", 8, 0.3, 0.1, None, None, None),        # 1D too thin: 2D
    ("slab", 8, 0.3, 0.1, (4, 2), (0, 1), None),
    ("slab", 4, 0.3, 0.1, (2, 2), (0, 1), None),
    ("cube", 8, 0.25, 0.1, (2, 2, 2), (0, 1, 2), None),
    ("slab", 4, 0.3, 0.1, (4,), (0,), ((0.0, 0.6, 1.3, 2.2, 3.2),)),
    ("slab", 8, 0.3, 0.1, (4, 2), (0, 1),
     ((0.0, 0.5, 1.4, 2.3, 3.2), (0.0, 0.7, 1.6))),
    ("dam", 4, 0.3, 0.1, None, None, None),
]


def _boxes(name):
    lo, hi, per = BOXES[name]
    return Box.create(lo, hi, per), JBox.create(lo, hi, per)


@pytest.mark.parametrize("case", SPEC_CASES)
def test_brick_spec_matches_jax(case):
    """make_brick_spec (and its procgrid chooser) field for field, and the
    spec's per-brick accessors."""
    name, ndev, cut, skin, shape, axes, cuts = case
    tbox, jbox = _boxes(name)
    kw = dict(shape=shape, axes=axes, cuts=cuts)
    got = dist.make_brick_spec(tbox, ndev, cut, skin, 512, **kw)
    want = jdist.make_brick_spec(jbox, ndev, cut, skin, 512, **kw)
    assert tuple(got) == tuple(want)
    for k in range(got.naxes):
        np.testing.assert_array_equal(got.widths_of(k), want.widths_of(k))
        np.testing.assert_array_equal(got.offsets_of(k), want.offsets_of(k))
        assert got.stride(k) == want.stride(k)
        assert got.width[k] > got.margin
    for b in range(ndev):
        assert got.coords_of(b) == want.coords_of(b)
    assert dist.choose_brick_shape(tbox, ndev, cut + skin, 3) == \
        jdist.choose_brick_shape(jbox, ndev, cut + skin, 3)
    for n, k in ((8, 2), (12, 3), (4, 1)):
        assert dist._factorizations(n, k) == jdist._factorizations(n, k)
    assert dist._axis_subsets([0, 1, 2], 1) == jdist._axis_subsets([0, 1, 2],
                                                                  1)
    assert dist.choose_local_cap(got, 300) == jdist.choose_local_cap(want,
                                                                    300)


def test_auto_shape_lifts_margin_ceiling():
    """A box too narrow for 8 one-axis bricks (3.2 / 8 <= margin 0.4)
    takes a multi-axis decomposition instead of raising; too many bricks
    for any factorization raise in both packages."""
    tbox, jbox = _boxes("slab")
    spec = dist.make_brick_spec(tbox, 8, cutoff=0.3, skin=0.1, n_particles=512)
    assert len(spec.axes) >= 2 and int(np.prod(spec.shape)) == 8
    for k in range(spec.naxes):
        assert spec.width[k] > spec.margin
    for mod, box in ((dist, tbox), (jdist, jbox)):
        with pytest.raises(ValueError, match="no brick decomposition"):
            mod.make_brick_spec(box, 128, cutoff=0.3, skin=0.1,
                                n_particles=512)


@pytest.mark.parametrize("axes,shape", [((0,), (4,)), ((0, 1), (4, 2)),
                                        ((1,), (3,))])
def test_balance_cuts_match_jax(axes, shape):
    """compute_balance_cuts on a density-skewed cloud equals the
    reference's; an axis too short for its bricks raises in both."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 1.6, (600, 3)),
                        rng.uniform(1.6, 3.2, (150, 3))]) * [1, 0.5, 0.3]
    x = x.astype(np.float32)
    tbox, jbox = _boxes("slab")
    got = dist.compute_balance_cuts(x, tbox, axes, shape, 0.4)
    assert got == jdist.compute_balance_cuts(x, jbox, axes, shape, 0.4)
    assert np.diff(got[0]).min() > 0.4
    for mod, box in ((dist, tbox), (jdist, jbox)):
        with pytest.raises(ValueError, match="cannot balance"):
            mod.compute_balance_cuts(x, box, (1,), (4,), 0.4)


@pytest.mark.parametrize("case", [SPEC_CASES[0], SPEC_CASES[2],
                                  SPEC_CASES[4], SPEC_CASES[6],
                                  SPEC_CASES[7]])
def test_positions_match_jax(case):
    """brick_local_positions (each brick's view with its margin ghosts),
    partition_state's brick-local positions and placement, and
    globalize_positions, against the reference's (its partition on a mesh
    of 4 or 8 virtual devices: no shard_map is compiled)."""
    from jax.sharding import Mesh
    name, ndev, cut, skin, shape, axes, cuts = case
    tbox, jbox = _boxes(name)
    lo, hi, _ = BOXES[name]
    rng = np.random.default_rng(ndev)
    x = rng.uniform(lo, hi, (700, 3)).astype(np.float32)
    spec = dist.make_brick_spec(tbox, ndev, cut, skin, 700, shape=shape,
                                axes=axes, cuts=cuts)
    jspec = jdist.make_brick_spec(jbox, ndev, cut, skin, 700, shape=shape,
                                  axes=axes, cuts=cuts)
    for a, b in zip(dist.brick_local_positions(x, spec, tbox),
                    jdist.brick_local_positions(x, jspec, jbox)):
        np.testing.assert_array_equal(a, b)
    staged = dict(x=x, v=rng.normal(0, 1, (700, 3)).astype(np.float32),
                  rho=np.ones(700, np.float32), e=np.ones(700, np.float32),
                  cv=np.ones(700, np.float32),
                  rmass=np.full(700, 0.5, np.float32),
                  type=np.ones(700, np.int32),
                  tag=np.arange(1, 701, dtype=np.int32),
                  mobile=np.ones(700, bool))
    bricks, cap = dist.partition_state(staged, spec, ["cpu"] * ndev)
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), (jdist.AXIS,))
    jst, jcap = jdist.partition_state(staged, jspec, mesh)
    assert cap == jcap and len(bricks) == ndev
    got = state_to_numpy(dist.DistBackend.concat(
        type("B", (), {"devices": [torch.device("cpu")]})(), bricks))
    for f in ("x", "v", "tag", "type", "owned", "vest"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jst, f)),
                                      f)
    glob = dist.globalize_positions(got["x"], spec, cap)
    np.testing.assert_array_equal(
        glob, jdist.globalize_positions(np.asarray(jst.x), jspec, cap))
    alive = got["type"] > 0
    order = np.argsort(got["tag"][alive])
    np.testing.assert_allclose(glob[alive][order], x, atol=2e-6)


def test_strip_geometry_dist_matches_jax():
    """The strip geometry every brick shares, and the per-brick pool it
    implies, on the 32^3 `dynamic` bench in four bricks along x (and a
    box whose bricks cannot strip: both None)."""
    sim = build_bench_sim(32 ** 3, mode="dynamic", device="cpu")
    x = sim._staged["x"]
    tbox = sim.box
    lo, hi = tbox.lo.numpy(), tbox.hi.numpy()
    jbox = JBox.create(lo, hi, tbox.periodic)
    spec = dist.make_brick_spec(tbox, 4, 3.0, 1.0, len(x))
    jspec = jdist.make_brick_spec(jbox, 4, 3.0, 1.0, len(x))
    assert spec.shape == (4,) and tuple(spec) == tuple(jspec)
    for headroom in (1.15, 1.35):
        geom, cap = dist.choose_strip_geometry_dist(
            tbox, spec, 3, 3.0, 1.0, x, headroom=headroom)
        jgeom, jcap = jdist.choose_strip_geometry_dist(
            jbox, jspec, 3, 3.0, 1.0, x, headroom=headroom)
        assert geom is not None and tuple(geom) == tuple(jgeom)
        assert cap == jcap == geom.n_slots
    # 8 bricks of width 4 along x: the local box is 12 wide, its periodic
    # z seam bands fit, but the 2x2 procgrid with 16-wide bricks is what
    # auto picks; force a spec whose local columns cannot strip
    small = dist.make_brick_spec(tbox, 4, 3.0, 1.0, len(x), shape=(2, 2),
                                 axes=(0, 2))
    jsmall = jdist.make_brick_spec(jbox, 4, 3.0, 1.0, len(x), shape=(2, 2),
                                   axes=(0, 2))
    got = dist.choose_strip_geometry_dist(tbox, small, 3, 3.0, 1.0, x)
    want = jdist.choose_strip_geometry_dist(jbox, jsmall, 3, 3.0, 1.0, x)
    assert (got[0] is None) == (want[0] is None)
    if got[0] is not None:
        assert tuple(got[0]) == tuple(want[0]) and got[1] == want[1]


# ------------------------------------------------- one rebuild vs numpy

def _jittered_periodic(ndev, shape=None, axes=None, backend=None, seed=2):
    sim = _periodic_sim(backend=backend)
    rng = np.random.default_rng(seed)
    x = sim._staged["x"].copy()
    x[:, :2] += rng.uniform(-0.02, 0.02, (len(x), 2)).astype(np.float32)
    sim._staged["x"] = np.mod(x, np.float32([3.2, 1.6, 1.0])
                              ).astype(np.float32)
    sim.set_mesh(ndev, shape=shape, axes=axes)
    return sim


@pytest.mark.parametrize("shape,axes,backend", [
    ((4,), (0,), None), ((2, 2), (0, 1), None), ((2, 2), (0, 1), "strip")])
def test_rebuild_ghosts_match_numpy(shape, axes, backend):
    """After one rebuild (exchange, borders, sort) each brick's ghost tags
    are the set of particles within the margin of its faces, periodic
    images included (computed in numpy from the global positions), and
    every tag is owned by exactly one brick, the brick its position falls
    in. The forward comm then leaves every ghost at its owner's position
    shifted into the receiver's frame."""
    sim = _jittered_periodic(int(np.prod(shape)), shape, axes, backend)
    sim.run(0)
    spec, cap = sim.brick_spec, sim.local_cap
    x = sim._staged["x"].astype(np.float64)
    tags = sim._staged["tag"]
    L = sim.box.length.numpy().astype(np.float64)
    st = state_to_numpy(sim.state)
    owner, _ = dist.brick_owner(x, spec)
    seen = np.zeros(len(tags), int)
    be = sim._runner.backend
    assert be.mode == ("strip" if backend else "cellgrid")
    n_halo = 0
    for b in range(spec.ndev):
        rows = slice(b * cap, (b + 1) * cap)
        alive = st["type"][rows] > 0
        own = st["owned"][rows] & alive
        ghost_tags = st["tag"][rows][alive & ~st["owned"][rows]]
        seam = be.split(sim.state)[b].capacity
        dest = sim.aux.bricks[b].seam_dest.numpy()
        n_copies = int((dest < seam).sum())
        n_halo += len(ghost_tags) - n_copies
        if n_copies:
            # the strip's seam bands copy rows (owned=False) along the
            # column axis, which no brick decomposes here
            ghost_tags = np.unique(ghost_tags)
        owned_tags = st["tag"][rows][own]
        np.testing.assert_array_equal(np.sort(owned_tags),
                                      np.sort(tags[owner == b]))
        seen[np.searchsorted(tags, owned_tags)] += 1
        coords = spec.coords_of(b)
        inside = np.ones(len(x), bool)
        for k, ax in enumerate(spec.axes):
            off = spec.offsets_of(k)[coords[k]] + spec.lo[k]
            w = spec.widths_of(k)[coords[k]]
            rel = np.mod(x[:, ax] - (off - spec.margin), L[ax])
            inside &= rel < w + 2 * spec.margin
        want = np.sort(tags[inside & (owner != b)])
        np.testing.assert_array_equal(np.sort(ghost_tags), want)
    assert (seen == 1).all()
    assert int(sim.aux.overflow.sum()) == 0
    # the brick layer's metric: halo rows refreshed per forward comm
    assert be.halo_rows(sim.aux) == n_halo > 0


# ---------------------------------------- N bricks vs the JAX one-device run

def _periodic_sim(lx=3.2, backend=None, vel=None):
    interp = Interpreter(device="cpu")
    interp.sim.screen = False
    interp.run_string(PERIODIC_SCRIPT.format(lx=lx, lxf=lx - 0.05))
    sim = interp.sim
    if vel is not None:
        sim.set_values(np.ones(sim.natoms, bool), v=np.asarray(vel))
    if backend:
        sim.backend_name = backend
    return sim


def run_case(nbricks, nsteps=60, lx=3.2, backend=None, shape=None,
             axes=None, vel=None, every=0):
    """tests/test_dist.py's run_case on the port, in ``nbricks`` bricks."""
    sim = _periodic_sim(lx, backend, vel)
    sim.reneigh_every = every
    sim.set_mesh(nbricks, shape=shape, axes=axes)
    sim.run(nsteps)
    return sim, {f: sim.get(f) for f in ("x", "v", "rho", "e", "tag")}


@functools.lru_cache(maxsize=None)
def jax_case(nsteps=60, lx=3.2, vel=None, every=0):
    """The JAX package's one-device cell-grid run of the same script."""
    interp = JInterpreter()
    interp.sim.screen = False
    interp.run_string(PERIODIC_SCRIPT.format(lx=lx, lxf=lx - 0.05))
    sim = interp.sim
    if vel is not None:
        sim.set_values(np.ones(sim.natoms, bool), v=np.asarray(vel))
    sim.backend_name = "cellgrid"
    sim.reneigh_every = every
    sim.run(nsteps)
    return sim.natoms, {f: sim.get(f) for f in ("x", "v", "rho", "e",
                                                "tag")}


def _hold(a, b, L, rho=1e-4, e=1e-4, x=5e-4, v=5e-4):
    assert np.array_equal(a["tag"], b["tag"])
    np.testing.assert_allclose(_min_image(a["x"] - b["x"], L), 0.0, atol=x)
    np.testing.assert_allclose(b["v"], a["v"], atol=v)
    np.testing.assert_allclose(b["rho"], a["rho"], rtol=rho)
    np.testing.assert_allclose(b["e"], a["e"], rtol=e, atol=1e-5)


# a drift down x with a rebuild every 5 steps: particles leave their
# bricks through the faces and the periodic seam at every rebuild
DRIFT = (-0.15, -0.05, 0.0)


def test_bricks_match_single_device():
    """4 bricks along x vs the one-device run, 60 steps: migration through
    the faces and the seam at every rebuild (the Kahan ledgers ride
    along)."""
    natoms, a = jax_case(vel=DRIFT, every=5)
    sim, b = run_case(4, vel=DRIFT, every=5)
    assert sim.brick_spec.shape == (4,)
    assert isinstance(sim._runner.backend.inner, CellGridBackend)
    assert sim.natoms == natoms and sim.rebuilds >= 12
    own0, _ = dist.brick_owner(_periodic_sim()._staged["x"], sim.brick_spec)
    own1, _ = dist.brick_owner(np.mod(b["x"], [3.2, 1.6, 1.0]),
                               sim.brick_spec)
    assert (own0 != own1).sum() >= 16
    _hold(a, b, [3.2, 1.6, 1.0])


def test_bricks_8way():
    natoms, a = jax_case(nsteps=30, lx=6.4)
    sim, b = run_case(8, nsteps=30, lx=6.4)
    assert sim.natoms == natoms
    np.testing.assert_allclose(_min_image(a["x"] - b["x"], [6.4, 1.6, 1.0]),
                               0.0, atol=5e-4)
    assert np.array_equal(a["tag"], b["tag"])


@pytest.mark.parametrize("backend,inner", [("strip", StripBackend),
                                           ("pallas", PallasBackend)])
def test_bricks_with_kernel_inner(backend, inner):
    """The strip (seam-band recopy of halo ghosts included) and the column
    kernel inside each brick (their plain versions on the CPU) on the
    one-device trajectory."""
    natoms, a = jax_case(nsteps=30, vel=DRIFT, every=5)
    sim, b = run_case(4, nsteps=30, backend=backend, vel=DRIFT, every=5)
    assert isinstance(sim._runner.backend.inner, inner)
    assert sim.natoms == natoms
    _hold(a, b, [3.2, 1.6, 1.0], rho=2e-4, e=2e-4)
    assert int(sim.aux.overflow.sum()) == 0


def test_bricks_2d_mesh_corner_migration():
    """A (2, 2) procgrid over x and y with a diagonal drift (corners in two
    staged hops, both periodic seams)."""
    diag = (0.15, 0.11, 0.0)
    natoms, a = jax_case(nsteps=40, vel=diag)
    sim, b = run_case(4, nsteps=40, shape=(2, 2), axes=(0, 1), vel=diag)
    assert sim.brick_spec.shape == (2, 2) and sim.brick_spec.axes == (0, 1)
    assert sim.natoms == natoms
    _hold(a, b, [3.2, 1.6, 1.0])


def test_bricks_4x2_mesh():
    diag = (0.15, 0.11, 0.0)
    natoms, a = jax_case(nsteps=40, vel=diag)
    sim, b = run_case(8, nsteps=40, shape=(4, 2), axes=(0, 1), vel=diag)
    assert sim.natoms == natoms
    np.testing.assert_allclose(_min_image(a["x"] - b["x"], [3.2, 1.6, 1.0]),
                               0.0, atol=5e-4)


def _cube_case(sim, nbricks, nsteps=10, shape=None, axes=None):
    """tests/test_dist.py's 3D periodic cube with a diagonal drift."""
    n_side, dx = 12, 0.1
    L = n_side * dx
    h = 0.25
    sim.create_box([0, 0, 0], [L, L, L], periodic=(True,) * 3, ntypes=1)
    rng = np.random.default_rng(5)
    ax = np.arange(n_side, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    g = (g + rng.uniform(-0.01 * dx, 0.01 * dx, g.shape)).astype(np.float32)
    v = np.broadcast_to(np.asarray([0.15, 0.11, 0.13], np.float32),
                        g.shape).copy()
    sim.add_particles(g, 1, v=v, rho=1.0, e=1.0, cv=1.0, rmass=dx**3)
    sim.pair_rhosum(3)
    sim.pair_taitwater()
    sim.tables.set_taitwater(1, 1, rho0=1.0, c0=5.0, viscosity=0.3, h=h)
    sim.tables.set_rhosum(1, 1, h=h)
    sim.neighbor_skin = 0.1
    sim.dt = 2e-4
    sim.thermo(0)
    if nbricks > 1:
        sim.set_mesh(nbricks, shape=shape, axes=axes)
    else:
        sim.backend_name = "cellgrid"
    sim.run(nsteps)
    return sim


def test_bricks_3d_222_corner_migration():
    """A (2, 2, 2) procgrid: three staged hops through a 3D corner."""
    s1 = _cube_case(JSimulation(dim=3, screen=False), 1)
    s8 = _cube_case(Simulation(dim=3, screen=False, device="cpu"), 8,
                    shape=(2, 2, 2), axes=(0, 1, 2))
    assert s8.brick_spec.shape == (2, 2, 2)
    assert s8.brick_spec.axes == (0, 1, 2)
    assert s8.natoms == s1.natoms
    assert np.array_equal(s1.get("tag"), s8.get("tag"))
    np.testing.assert_allclose(
        _min_image(s1.get("x") - s8.get("x"), [1.2] * 3), 0.0, atol=5e-4)
    np.testing.assert_allclose(s8.get("rho"), s1.get("rho"), rtol=2e-4)
    assert int(s8.aux.overflow.sum()) == 0


def test_dist_overflow_counter_visible():
    """The overflow counter over the bricks is on the host, and a ghost
    capacity too small for the slab is counted, raised with the bricks'
    remedy, and recovered from by the re-choice loop only while it
    progresses (here it cannot: the cap is the user's)."""
    sim, _ = run_case(4, nsteps=10)
    assert sim.aux.overflow.shape == (4,)
    assert int(sim.aux.overflow.sum()) == 0
    small = _periodic_sim()
    small.dist_ghost_cap = 8
    small.set_mesh(4)
    with pytest.raises(RuntimeError, match="dist_ghost_cap"):
        small.run(10)


DAM_STEPS = 60


def test_bricks_dam_break_migration():
    """Gravity-driven flow across brick boundaries: stationary walls,
    free surface, a non-periodic box. 4 bricks vs one device."""
    jint = JInterpreter()
    jint.sim.screen = False
    jint.run_string(DAM_DIST_SCRIPT)
    s1 = jint.sim
    s1.backend_name = "cellgrid"
    s1.run(DAM_STEPS)
    interp = Interpreter(device="cpu")
    interp.sim.screen = False
    interp.run_string(DAM_DIST_SCRIPT)
    s4 = interp.sim
    s4.set_mesh(4)
    s4.run(DAM_STEPS)
    assert s4.natoms == s1.natoms
    assert np.array_equal(s1.get("tag"), s4.get("tag"))
    np.testing.assert_allclose(s4.get("x"), s1.get("x"), atol=1e-3)
    np.testing.assert_allclose(s4.get("rho"), s1.get("rho"), rtol=5e-4)
    water = s1.get("type") == 1
    assert s1.get("v")[water][:, 1].mean() < -1e-3


SKEW = """
dimension      2
units          si
atom_style     meso
boundary       p p p
region         box block 0 3.2 0 0.8 -0.05 0.05
create_box     1 box
lattice        sq 0.08
region         left block 0.0 1.59 0.0 0.79 -1 1 units box
create_atoms   1 region left
lattice        sq 0.16
region         right block 1.61 3.19 0.0 0.79 -1 1 units box
create_atoms   1 region right
mass           1 0.01
set            group all meso/rho 1000.0
set            group all meso/cv 1.0
set            group all meso/e 1.0
pair_style     sph/taitwater
pair_coeff     * * 1000.0 10.0 1.0 0.2
timestep       1e-4
thermo         0
"""


def test_balance_nonuniform_cuts():
    """The script's ``balance`` on a density-skewed box: non-uniform cuts
    (narrow bricks on the dense half) equal to the reference's, near-equal
    per-brick counts, and the balanced run on the one-device
    trajectory."""
    def build(interp):
        interp.sim.screen = False
        interp.run_string(SKEW)
        sim = interp.sim
        sim.set_values(np.ones(sim.natoms, bool),
                       v=np.asarray([0.12, 0.0, 0.0]))
        return interp, sim

    jint, s1 = build(JInterpreter())
    s1.backend_name = "cellgrid"
    s1.run(40)
    interp, s2 = build(Interpreter(device="cpu"))
    s2.set_mesh(4, shape=(4,), axes=(0,))
    interp.command("balance 1.1 shift x 10 1.05")
    cuts = np.asarray(s2._balance_cuts[0])
    widths = np.diff(cuts)
    assert widths[0] < widths[-1], widths
    jint2, sj = build(JInterpreter())
    sj.mesh = object()           # the reference's balance needs a mesh
    sj.brick_spec = jdist.make_brick_spec(sj.box, 4, 0.2, 0.06, sj.natoms,
                                          shape=(4,), axes=(0,))
    assert s2._balance_cuts == sj.balance()
    s2.run(40)
    assert s2.brick_spec.cuts is not None
    x = s2.get("x")
    c = np.clip(np.searchsorted(cuts, x[:, 0], side="right") - 1, 0, 3)
    counts = np.bincount(c, minlength=4)
    assert counts.max() < 1.5 * max(counts.min(), 1), counts
    assert s2.natoms == s1.natoms
    assert np.array_equal(s1.get("tag"), s2.get("tag"))
    np.testing.assert_allclose(
        _min_image(s1.get("x") - s2.get("x"), [3.2, 0.8, 1.0]), 0.0,
        atol=5e-4)
    np.testing.assert_allclose(s1.get("rho"), s2.get("rho"), rtol=2e-4)


def test_migration_preserves_kahan_compensation():
    """The Kahan ledgers (rho_c, e_c) ride the migration and border
    payload: a white-box round trip through _pack_rows / _merge_payload,
    against the reference's on the same rows."""
    from tpusph.state import ParticleState as JState
    assert "rho_c" in dist._ALL_FIELDS and "e_c" in dist._ALL_FIELDS
    assert dist._ALL_FIELDS == jdist._ALL_FIELDS
    n = 16
    x = np.arange(3 * n, dtype=np.float32).reshape(n, 3) * 0.1
    rho_c = (np.arange(n, dtype=np.float32) + 1.0) * 1e-6
    e_c = -(np.arange(n, dtype=np.float32) + 1.0) * 1e-7
    src = state_from_arrays(x, np.ones(n, np.int32), np.ones(n, np.float32),
                            capacity=n, device="cpu",
                            rho=np.full(n, 1000.0, np.float32),
                            e=np.ones(n, np.float32), rho_c=rho_c, e_c=e_c)
    rows = torch.tensor([3, 7, 11, n])      # n: past the count
    rws, cnt, ov = dist._select_rows(
        torch.isin(torch.arange(n), rows[:3]), 4)
    assert rws.tolist() == [3, 7, 11, n] and int(cnt) == 3 and int(ov) == 0
    payload = dist._pack_rows(src, rws, cnt)
    dst = state_from_arrays(np.zeros((0, 3), np.float32),
                            np.zeros(0, np.int32), np.zeros(0, np.float32),
                            capacity=8, device="cpu")
    dst, overflow = dist._merge_payload(dst, payload, owned_val=True)
    assert int(overflow[0]) == 0
    got = state_to_numpy(dst)
    alive = got["type"] > 0
    assert alive.sum() == 3 and got["owned"][alive].all()
    order = np.argsort(got["tag"][alive])
    np.testing.assert_array_equal(got["rho_c"][alive][order],
                                  rho_c[[3, 7, 11]])
    np.testing.assert_array_equal(got["e_c"][alive][order], e_c[[3, 7, 11]])
    # the reference's merge fills the same slots
    jsrc = JState.from_arrays(x, np.ones(n, np.int64), rmass=np.ones(n),
                              rho=np.full(n, 1000.0, np.float32),
                              e=np.ones(n, np.float32), capacity=n)
    jsrc = jsrc.__class__(**{**{f: getattr(jsrc, f) for f in
                                jsrc.__dataclass_fields__},
                             "rho_c": jnp.asarray(rho_c),
                             "e_c": jnp.asarray(e_c)})
    jpay = jdist._pack_rows(jsrc, jnp.asarray([3, 7, 11, n], jnp.int32),
                            jnp.asarray(3))
    jdst, _ = jdist._merge_payload(JState.zeros(8), jpay, jnp.asarray(3),
                                   owned_val=True)
    np.testing.assert_array_equal(np.asarray(jdst.tag), got["tag"])
    # a payload larger than the dead slots: counted, not dropped silently
    full = state_from_arrays(x[:7], np.ones(7, np.int32),
                             np.ones(7, np.float32), capacity=8,
                             device="cpu")
    _, overflow = dist._merge_payload(full, payload, owned_val=False)
    assert int(overflow[0]) == 2


# --------------------------------------------- the halo points of the stages

def test_force_stage_halo_points():
    """``force_stage(..., halo=)`` of the strip (band's stage), column and
    cell-grid backends: the callable sees the fresh rho (n,) and colour
    gradient (n, 3), in that order; the identity gives the stage without
    one exactly, and what it returns is what the next sweep reads."""
    for backend in ("strip", "pallas", "cellgrid"):
        sim = build_bench_sim(4096, mode="dynamic", device="cpu",
                              backend=backend)
        sim.run(1)
        be, st, aux = sim._runner.backend, sim.state, sim.aux
        tabs = sim.tables.stacked("cpu")
        plain = be.force_stage(st, tabs, sim.spec, aux, 2)
        seen = []

        def ident(f):
            seen.append(tuple(f.shape))
            return f

        same = be.force_stage(st, tabs, sim.spec, aux, 2, halo=ident)
        n = st.capacity
        assert seen == [(n,), (n, 3)], (backend, seen)
        for f in ("f", "rho", "drho", "de"):
            assert torch.equal(getattr(same, f), getattr(plain, f)), f
        scaled = be.force_stage(st, tabs, sim.spec, aux, 2,
                                halo=lambda f: f * 1.5 if f.dim() == 1
                                else f)
        assert torch.equal(scaled.rho[st.alive], 1.5 * plain.rho[st.alive])
        assert not torch.equal(scaled.f, plain.f)


def test_build_markers_and_ghosts():
    """``grid.build(extra=)`` and ``build_strips(extra=, keep_ghosts=,
    return_seam=)``: the markers follow their rows through the sort, halo
    ghosts (owned=False) sort in as regular rows, and the seam map is the
    aux's."""
    from tpusph_torch import grid as gridlib
    from tpusph_torch.ops.strip_pair import build_strips
    sim = build_bench_sim(4096, mode="dynamic", device="cpu",
                          backend="strip")
    sim.run(1)
    be, st = sim._runner.backend, sim.state
    # the seam copies of the last build go (as the bricks kill their stale
    # ghosts before a rebuild); every tenth owned row becomes a halo ghost
    st = st.__class__(**{**st.__dict__,
                         "type": torch.where(st.owned, st.type, 0)})
    live = st.alive.nonzero()[:, 0]
    ghost = torch.zeros_like(st.owned)
    ghost[live[::10]] = True
    st = st.__class__(**{**st.__dict__, "owned": st.owned & ~ghost})
    extra = dict(t=st.tag.long(), g=torch.stack([ghost.long(), st.tag.long()],
                                                 1))
    st2, aux, ex, seam = build_strips(st, be.geom, sim.box, extra=extra,
                                      keep_ghosts=True, return_seam=True)
    assert torch.equal(seam[0], aux.seam_src)
    assert torch.equal(seam[1], aux.seam_dest)
    real = st2.alive.clone()
    real[aux.seam_dest[aux.seam_dest < st2.capacity]] = False
    assert torch.equal(ex["t"][real], st2.tag[real].long())
    assert torch.equal(ex["g"][real, 1], st2.tag[real].long())
    assert torch.equal(ex["g"][real, 0].bool(), ~st2.owned[real])
    assert int(real.sum()) == int(st.alive.sum())
    dropped, _ = build_strips(st, be.geom, sim.box)
    assert int(dropped.alive.sum() - (~dropped.owned & dropped.alive).sum()
               ) == int((st.alive & st.owned).sum())
    geom = gridlib.make_geometry(sim.box, 3.0, 3, skin=1.0, cap=96)
    st3, data, ex3 = gridlib.build(st, geom, extra=extra)
    assert torch.equal(ex3["t"], st3.tag.long())
    assert torch.equal(ex3["g"][:, 0].bool() & st3.alive,
                       ~st3.owned & st3.alive)


def test_strip_vapor_owned_nearest_with_halo_rows():
    """The strip vapor query inside a brick, with halo ghost rows present
    (owned=False): the nearest OWNED vapour is owned, and its rsq is the
    brute-force least over the owned vapour rows within the cut (one
    brick of a 4-brick run of the 12^3 bubble, the plain version)."""
    sim = build_bubble_sim(device="cpu", backend="strip")
    sim.set_mesh(4, shape=(2, 2), axes=(0, 1))
    sim.run(2)
    be = sim._runner.backend
    assert be.mode == "strip"
    cap = sim.local_cap
    cut = sim.phase_change_config.cutoff
    for b in range(4):
        st = be.split(sim.state)[b]
        aux = sim.aux.bricks[b]
        count, near, rsq, near_o, rsq_o = be.inner_of(b).vapor_neighbor(
            st, be.box_of(b), 2, cut, aux.grid)
        x = st.x.double().numpy()
        alive = st.alive.numpy()
        vap_own = alive & st.owned.numpy() & (st.type.numpy() == 2)
        rows = np.nonzero(alive & (st.type.numpy() == 1)
                          & st.owned.numpy())[0]
        assert (~st.owned.numpy() & alive).sum() > 0
        finite = np.isfinite(rsq_o.numpy())
        assert st.owned.numpy()[near_o.numpy()[finite & alive]].all()
        xv = x[vap_own]
        L = sim.box.length.numpy()
        for i in rows[::7]:
            d = xv - x[i]
            d[:, 2] -= L[2] * np.round(d[:, 2] / L[2])
            r2 = (d * d).sum(1)
            r2 = r2[r2 < np.float32(min(cut, be.strip_geom.margin_dist)) ** 2]
            if len(r2):
                assert rsq_o[i].item() == pytest.approx(r2.min(), rel=1e-5)
            else:
                assert not np.isfinite(rsq_o[i].item())


# ------------------------------------------------------ phase change

def _bubble(nbricks, mode, port=True, nsteps=20):
    if port:
        sim = build_bubble_sim(device="cpu", backend="cellgrid", mode=mode)
    else:
        sim = JSimulation(dim=3, screen=False)
        sim = build_bubble_sim(sim=sim, config_cls=JConfig,
                               backend="cellgrid", mode=mode)
    if nbricks > 1:
        sim.set_mesh(nbricks, shape=(2, 2), axes=(0, 1))
    tags0 = set(sim.get("tag").tolist())
    x0 = sim.get("x").copy()
    sim.run(nsteps)
    return sim, tags0, x0


def _phase_mass(sim, phase):
    t = sim.get("type")
    return float(sim.get("rmass")[t == phase].astype(np.float64).sum())


def _hold_insert(s1, t1, s4, t4, L=3.0):
    assert s1.natoms > len(t1), "no evaporation events fired"
    assert s4.natoms == s1.natoms
    tags = s4.get("tag")
    assert len(np.unique(tags)) == len(tags)
    for phase in (1, 2):
        assert _phase_mass(s4, phase) == pytest.approx(
            _phase_mass(s1, phase), rel=1e-5), phase

    def originals(sim, tags0):
        tag = sim.get("tag")
        keep = np.isin(tag, list(tags0))
        order = np.argsort(tag[keep])
        return {f: sim.get(f)[keep][order] for f in ("x", "e", "rmass")}

    a, b = originals(s1, t1), originals(s4, t4)
    b["x"] = a["x"] + _min_image(b["x"] - a["x"], [L] * 3)
    for f in ("x", "e", "rmass"):
        np.testing.assert_allclose(b[f], a[f], rtol=2e-4, atol=2e-5,
                                   err_msg=f)

    def inserted_x(sim, tags0):
        tag = sim.get("tag")
        x = sim.get("x")[~np.isin(tag, list(tags0))]
        x = x - L * np.floor(x / L)
        return x[np.lexsort(x.T)]

    xa, xb = inserted_x(s1, t1), inserted_x(s4, t4)
    assert len(xa) == len(xb)
    np.testing.assert_allclose(xb, xa, rtol=2e-4, atol=2e-5)


def test_dist_phase_change_insert_cheap():
    """Insert mode at prob = 1 on the 12^3 bubble, 10 steps: 4 bricks (a
    2 x 2 procgrid, events at the brick seams) vs the JAX package's one
    device, event for event (tests/test_dist_phase_change.py's bars);
    minted tags stay unique across bricks."""
    s1, t1, _ = _bubble(1, "insert", port=False, nsteps=10)
    s4, t4, _ = _bubble(4, "insert", nsteps=10)
    _hold_insert(s1, t1, s4, t4)


@pytest.mark.slow
def test_dist_phase_change_insert_matches_single():
    s1, t1, _ = _bubble(1, "insert", port=False)
    s4, t4, _ = _bubble(4, "insert")
    _hold_insert(s1, t1, s4, t4)


@pytest.mark.slow
def test_dist_phase_change_grow_deficit_converges():
    """Grow mode grows only owned targets (the nearest owned vapour, so no
    event waits on a ghost owner): total mass conserved, and the same
    number of events in 4 bricks as on one device."""
    s1, _, _ = _bubble(1, "grow", port=False)
    s4, _, _ = _bubble(4, "grow")
    dm = s1.phase_change_config.dm
    m_l1, m_l4 = _phase_mass(s1, 1), _phase_mass(s4, 1)
    assert m_l4 + _phase_mass(s4, 2) == pytest.approx(
        m_l1 + _phase_mass(s1, 2), rel=1e-5)
    t0 = s1.get("type")
    m0 = float((t0 == 1).sum()) * 0.25 ** 3
    ev1, ev4 = round((m0 - m_l1) / dm), round((m0 - m_l4) / dm)
    assert ev1 > 0, "no grow events fired"
    assert ev4 == ev1, (ev1, ev4)


# ------------------------------------------------------ the recovery loop

def _fluid_sim(nbricks):
    n_side, dx = 16, 1.0
    L = n_side * dx
    sim = Simulation(dim=3, screen=False, device="cpu")
    sim.backend_name = "strip"
    sim.create_box([0, 0, 0], [L, L, L], periodic=(True,) * 3, ntypes=1)
    rng = np.random.default_rng(5)
    ax = np.arange(n_side, dtype=np.float32) * dx
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    g = (g + rng.uniform(-0.05, 0.05, g.shape)).astype(np.float32)
    sim.add_particles(g, np.ones(len(g), np.int32), rho=1.0, e=1.0, cv=1.0,
                      rmass=1.0)
    sim.tables.set_taitwater(1, 1, rho0=1.0, c0=8.0, viscosity=0.4, h=3.0)
    sim.tables.set_rhosum(1, 1, h=3.0)
    sim.pair_taitwater()
    sim.pair_rhosum(every=1)
    sim.set_values(np.ones(sim.natoms, bool),
                   v=rng.normal(0.0, 0.15, (sim.natoms, 3)))
    sim.neighbor_skin = 0.5
    sim.dt = 5e-3
    sim.thermo(5)
    if nbricks > 1:
        sim.set_mesh(nbricks, shape=(2, 2), axes=(0, 1))
    return sim


def _squeezed(monkeypatch):
    real = dist.choose_strip_geometry_dist
    calls = []

    def squeezing(*args, **kw):
        geom, cap = real(*args, **kw)
        calls.append(None if geom is None else (geom.mlo, geom.mhi))
        if len(calls) == 1 and geom is not None:
            geom = geom._replace(mlo=1, mhi=1)
        return geom, cap

    monkeypatch.setattr(dist, "choose_strip_geometry_dist", squeezing)
    return calls


@pytest.mark.slow
def test_dist_coverage_violation_recovers(monkeypatch):
    """A first shared geometry squeezed to one chunk of margin per side:
    the run completes through a re-choice that carries the measured
    shortfall as a floor, every step executed once, still the strip in
    every brick, nothing lost."""
    calls = _squeezed(monkeypatch)
    sim = _fluid_sim(4)
    sim.run(20)
    assert sim._strip_violations >= 1 and len(calls) >= 2
    assert sim._strip_extra > (0, 0)
    assert sim.step_count == 20
    assert sim.time_acc == pytest.approx(20 * sim.dt)
    assert isinstance(sim._runner.backend.inner, StripBackend)
    assert int(sim.aux.overflow.sum()) == 0
    assert sim.natoms == 16 ** 3
    assert np.isfinite(sim.get("e")).all() and np.isfinite(sim.get("v")).all()


@pytest.mark.slow
def test_dist_recovery_matches_uninterrupted(monkeypatch):
    """The recovered 4-brick run lands on the uninterrupted one."""
    ref = _fluid_sim(4)
    ref.run(20)
    _squeezed(monkeypatch)
    sim = _fluid_sim(4)
    sim.run(20)
    assert sim._strip_violations >= 1
    a = {f: ref.get(f) for f in ("tag", "x", "v", "e", "rho")}
    b = {f: sim.get(f) for f in ("tag", "x", "v", "e", "rho")}
    assert np.array_equal(a["tag"], b["tag"])
    np.testing.assert_allclose(_min_image(a["x"] - b["x"], [16.0] * 3), 0.0,
                               atol=5e-4)
    np.testing.assert_allclose(b["v"], a["v"], atol=5e-4)
    np.testing.assert_allclose(b["e"], a["e"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(b["rho"], a["rho"], rtol=2e-4)
