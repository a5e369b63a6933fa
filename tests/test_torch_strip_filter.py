"""The counts that decide the strip kernels' design
(``strip_pair.warp_pass_counts``, ``strip_pair.vapor_pass_counts``) on
small strip layouts: 3D periodic, 3D open, 2D, and a lattice so dense
(cutoff 4.5 spacings, ~330 neighbours a row) that the force kernel's pair
queue flushes often inside one neighbour column.

The kernels filter before they compute: a warp tests its window rows
against the box of its 32 rows (distance below the cutoff), then each lane
tests the box's survivors exactly. Here: every live pair of the windows is
a box survivor (the filter is conservative, as the kernel needs: a pair it
drops is a pair missing from a sum); the pair queue's body passes never
exceed per-lane lists', nor those the lockstep scan's; and the windows hold
every pair within the cutoff: the live pairs of the owned rows equal a
brute-force all-pairs count in numpy (minimum image) on the same
positions. The layout itself is held exactly
against the JAX package in tests/test_torch_strip_layout.py.

The colour-gradient kernel sums the rows of mixed tiles only and gates:
a block stages as candidates only rows of a colour unlike one of its
rows' and inside its box, and each warp applies its own gate in its box
test. The vapor kernel gates on the vapour type and the vapor's cutoff.
Here, on 3D periodic and open, 2D, a vapour sphere, one colour (every
block exits on the gate), tiles flagged 0.5 and 1.0, no vapour row and an
exact lattice (ties at the minimum rsq): every needed pair (of unlike
colour; with a vapour row) survives both boxes and gates, and the needed
pairs the windows hold for the owned rows equal a brute-force count.
These hold the plain versions' windows, which are held against the JAX
package elsewhere; the kernels are held to their one-pass scans on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from tpusph_torch.ops import strip_pair
from tpusph_torch.ops.band_pair import pack_fields
from tpusph_torch.ops.rows import ORHO, RMIX, RSLOT, RTYPE, TABLES_1D
from tpusph_torch.params import PairTables
from tpusph_torch.state import Box, state_from_arrays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layout(dim, shape, periodic, hfac, seed, dx=0.5,
           candidates=strip_pair.DEFAULT_TS_CH, types="random",
           jitter=True, tabs=None):
    """A jittered (or, ``jitter`` False, exact) two-type lattice of
    ``shape`` sites, cutoffs ``hfac`` spacings, on its strip layout (tile
    rows and window chunks chosen from ``candidates``); ``types`` "random"
    (1 or 2 at random), "sphere" (type 2 within L/5 of the box centre, the
    bench's vapour sphere, type 1 elsewhere) or "one" (all type 1):
    (backend, state, aux, cut2), and with a list ``tabs`` also the tables
    on the CPU appended to it."""
    rng = np.random.default_rng(seed)
    ax = [np.arange(m) * dx for m in shape]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape) * jitter
    if dim == 2:
        pts[:, 2] = 0.0
    n = len(pts)
    typ = rng.integers(1, 3, n)
    L = [m * dx for m in shape] + [1.0]
    if types == "sphere":
        centre = np.asarray(L[:dim]) / 2
        typ = np.where(np.linalg.norm(pts[:, :dim] - centre, axis=1)
                       < min(L[:dim]) / 5, 2, 1)
    elif types == "one":
        typ = np.ones(n, np.int64)
    st = state_from_arrays(pts.astype(np.float32), typ, np.full(n, 0.1),
                           capacity=((n + 127) // 128) * 128, device="cpu")
    box = Box.create([0, 0, 0], L[:3], periodic, device="cpu")
    tables = PairTables.zeros(2)
    h = hfac * dx
    for i, j in ((1, 2), (1, 1), (2, 2)):
        tables.set_taitwater(i, j, rho0=1.0, c0=6.0, viscosity=0.4, h=h)
        tables.set_rhosum(i, j, h=h)
        tables.set_heatconduction(i, j, d=0.15, h=0.9 * h)
    tables.set_surfacetension(1, 2, sigma=0.8, h=h)
    geom = strip_pair.choose_strip_geometry(
        box, tables.max_cut(), dim, 0.2, x=st.x[st.alive].numpy(),
        candidates=candidates)
    assert geom is not None
    backend = strip_pair.StripBackend(geom, ntypes=2, device="cpu")
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    if tabs is not None:
        tabs.append(tables.stacked("cpu"))
    return backend, st, aux, box, tables.stacked("cpu").cutmax2["force"]


def brute_force_pairs(x, box, cut2):
    """Ordered pairs (i != j) of the positions ``x`` with 1e-12 < rsq <
    cut2, minimum image on the periodic axes, in float64."""
    x = x.astype(np.float64)
    L = np.asarray(box.hi, np.float64) - np.asarray(box.lo, np.float64)
    per = np.asarray(box.periodic)
    total = 0
    for a in range(0, len(x), 512):
        d = x[a:a + 512, None, :] - x[None, :, :]
        d = np.where(per, d - L * np.round(d / L), d)
        rsq = (d * d).sum(-1)
        total += int(((rsq > 1e-12) & (rsq < cut2)).sum())
    return total


@pytest.mark.parametrize("dim,shape,periodic,hfac,candidates", [
    (3, (12, 12, 12), (True, True, True), 2.2, strip_pair.DEFAULT_TS_CH),
    (3, (12, 12, 12), (False, False, False), 2.2, strip_pair.DEFAULT_TS_CH),
    (2, (40, 40), (True, True, False), 2.2, strip_pair.DEFAULT_TS_CH),
    (3, (20, 20, 12), (True, True, False), 4.5, strip_pair.DEFAULT_TS_CH),
    # 48-row tiles: a warp's lanes lie in two tiles with two windows
    (3, (12, 12, 12), (True, True, True), 2.2, ((48, 16),)),
])
def test_filter_is_conservative_and_windows_hold_every_pair(
        dim, shape, periodic, hfac, candidates):
    backend, st, aux, box, cut2 = layout(dim, shape, periodic, hfac,
                                         seed=dim + len(shape),
                                         candidates=candidates)
    assert backend.geom.ts == candidates[0][0]
    geom = backend.geom
    fld = pack_fields(st, aux.mix)
    c = strip_pair.warp_pass_counts(fld, backend.win, aux.delta, geom, cut2)
    assert c["live_pairs"] > 0
    assert c["live_outside_box"] == 0, c
    assert c["queue_passes"] <= c["list_passes"] <= c["old_passes"], c
    # a row any lane pairs with is a box survivor
    assert c["old_passes"] <= c["box_survivors"], c
    # the windows' pairs of the owned rows are exactly the pairs within the
    # cutoff
    own = st.alive & st.owned
    pi, *_ = strip_pair._window_pairs(fld, backend.win, aux.delta, geom, 0,
                                      geom.ncols, cut2)
    x = st.x[own].numpy()
    assert int(own[pi].sum()) == brute_force_pairs(x, box, cut2)


GATED_CASES = [
    (3, (12, 12, 12), (True, True, True), "random"),
    (3, (12, 12, 12), (False, False, False), "random"),
    (2, (40, 40), (True, True, False), "random"),
    (3, (16, 16, 16), (True, True, True), "sphere"),
    (3, (12, 12, 12), (True, True, True), "one"),
]


def gated_layout(dim, shape, periodic, types, jitter=True):
    """(backend, state, aux, box, tables) of a gated sweep's case."""
    tabs = []
    backend, st, aux, box, _ = layout(dim, shape, periodic, 2.2,
                                      seed=dim + len(shape) + 9, types=types,
                                      jitter=jitter, tabs=tabs)
    return backend, st, aux, box, tabs[0]


@pytest.mark.parametrize("dim,shape,periodic,types", GATED_CASES + [
    (3, (12, 12, 12), (True, True, True), "mix_half")])
def test_cgrad_filter_is_conservative_and_gated(dim, shape, periodic,
                                                types):
    """The colour-gradient kernel's filter (``warp_pass_counts`` with the
    colours): every live pair of unlike colour of a row of a mixed tile
    survives the block's and the warp's box and colour gate, and the
    windows hold exactly the brute-force unlike pairs. One colour: every
    block exits on the gate (its tiles flagged 1.0: with the flags of the
    layout, 0 for one phase, no row is summed). "mix_half": the tiles
    flagged 0.5 and 1.0 in turn (only rows of tiles flagged 1.0 are
    summed)."""
    from test_torch_cell_filter import brute_force_unlike_pairs

    backend, st, aux, box, tabs = gated_layout(
        dim, shape, periodic, "random" if types == "mix_half" else types)
    geom = backend.geom
    fld = pack_fields(st, aux.mix)
    if types == "mix_half":
        tile = torch.arange(geom.n_slots) // geom.ts
        fld[RMIX] = torch.where(tile % 2 == 0, 1.0, 0.5)
    elif types == "one":
        assert float(fld[RMIX].max()) == 0.0
        fld[RMIX] = 1.0
    colors = tabs.tab1[TABLES_1D.index("color")]
    cut2 = tabs.cutmax2["cgrad"]
    c = strip_pair.warp_pass_counts(fld, backend.win, aux.delta, geom, cut2,
                                    colors)
    assert c["live_outside_box"] == 0, c
    assert c["body_passes"] <= c["box_survivors"], c
    wpb = -(-geom.block_rows // 32)
    assert c["box_survivors"] <= wpb * c["staged_with_terms"], c
    assert c["staged_with_terms"] <= c["staged_rows"], c
    alive = fld[RTYPE] > 0.5
    active = alive & (fld[RMIX] > 0.75)
    assert c["rows"] == int(active.sum())
    # the unlike pairs the windows hold for the owned rows of mixed tiles
    pi, pj, *_ = strip_pair._window_pairs(fld, backend.win, aux.delta, geom,
                                          0, geom.ncols, cut2)
    typ = fld[RTYPE].long()
    unlike = colors[typ[pi]] != colors[typ[pj]]
    own = st.alive & st.owned
    x = st.x[own].numpy()
    colour = colors[st.type[own].long()].numpy()
    every = brute_force_unlike_pairs(x, colour, box, cut2)
    held = int((own[pi] & active[pi] & unlike).sum())
    if types == "mix_half":
        assert c["rows"] < int(alive.sum())
        assert 0 < held < every
        return
    # a tile that is not mixed holds no unlike pair within its reach
    assert held == every
    if types == "one":
        assert c["gate_exits"] == c["blocks"] > 0, c
        assert c["staged_with_terms"] == c["box_survivors"] == 0, c
    else:
        assert c["needed_pairs"] > 0, c
    if types == "sphere":
        # the rows of tiles far from the sphere are not summed
        assert 0 < c["rows"] < int(alive.sum()), c


@pytest.mark.parametrize("dim,shape,periodic,types,jitter", [
    *[case + (True,) for case in GATED_CASES],
    # an exact lattice: ties at the minimum rsq
    (3, (12, 12, 12), (True, True, True), "random", False),
])
def test_vapor_filter_is_conservative_and_gated(dim, shape, periodic, types,
                                                jitter):
    """The vapor kernel's filter (``vapor_pass_counts``): every pair of an
    alive row with a vapour row within the vapor's cutoff survives the
    block's and the warp's box and the type gate, and the plain version's
    counts of the owned rows equal the brute-force count of such pairs. No
    vapour row ("one"): every block exits on the gate."""
    from test_torch_cell_filter import brute_force_unlike_pairs

    backend, st, aux, box, tabs = gated_layout(dim, shape, periodic, types,
                                               jitter)
    geom = backend.geom
    fld = pack_fields(st)
    slot = torch.arange(geom.n_slots, dtype=torch.float32)
    fld[RSLOT] = torch.where(st.owned, slot, -slot - 1.0)
    # on the exact lattice a cutoff of 2.04 spacings, just above the shell
    # at 2 spacings: the filter's margin must keep that shell's pairs
    vtype = 2
    cut = min(float(np.sqrt(tabs.cutmax2["force"])) if jitter else 1.02,
              geom.margin_dist)
    c = strip_pair.vapor_pass_counts(fld, backend.win, aux.delta, geom,
                                     vtype, cut)
    assert c["live_outside_box"] == 0, c
    assert c["body_passes"] <= c["box_survivors"], c
    wpb = -(-geom.block_rows // 32)
    assert c["box_survivors"] <= wpb * c["staged_with_terms"], c
    assert c["rows"] == int((fld[RTYPE] > 0.5).sum())
    # pairs (i, j), j vapour: i liquid (half the unlike pairs) or vapour
    own = st.alive & st.owned
    x = st.x[own].numpy()
    vap = st.type[own].numpy() == vtype
    cut2 = strip_pair._vapor_cut2(cut)
    every = (brute_force_unlike_pairs(x, vap.astype(np.float32), box, cut2)
             // 2 + brute_force_pairs(x[vap], box, cut2))
    out = strip_pair.plain_vapor_sweep(fld, backend.win, aux.delta, geom,
                                       vtype, cut)
    assert int(out[ORHO][own].sum()) == every
    if types == "one":
        assert c["gate_exits"] == c["blocks"] > 0, c
        assert c["staged_with_terms"] == c["needed_pairs"] == 0, c
    else:
        assert c["needed_pairs"] > 0, c
    if types == "sphere":
        # blocks far from the sphere exit on the gate
        assert 0 < c["gate_exits"] < c["blocks"], c
