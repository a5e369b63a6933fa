"""The counts that decide the column and band kernels' design
(``cell_filter.cell_pass_counts``) on small cell layouts: each layout 3D
periodic, 3D open and 2D; a lattice so dense (cutoff 4.5 spacings) that
the force kernel's pair queue flushes many times inside one neighbour
column; band sub-cells of c slots not a multiple of 32, so that warps hold
alive rows of two sub-cells; and a column grid with one cell far above
the others (cap 480: the chunks past the other cells' alive rows hold
none, and the dense cell's windows are staged in two rounds).

The kernels filter before they compute: a warp tests its staged rows
against the box of its 32 rows (distance below the cutoff; the block
stages with their terms only the rows inside its own box, the union of
its warps'), then each lane tests the box's survivors exactly. Here: every
live pair of the windows is a survivor of both boxes (the filter is
conservative, as the kernel needs: a pair it drops is a pair missing from
a sum; with the filter radius cut by 3% the first case fails); the pair
queue's body passes never exceed the lockstep scan's, nor those the box
survivors; and the windows hold every pair within the cutoff: the live
pairs equal a brute-force all-pairs count in numpy (minimum image) on the
same positions. The rho and colour-gradient sweep
(``csrc/cell_sweep.cuh``) is held the same way on the band layouts, a
column grid, a vapour sphere of type 2 in type 1 and a lattice of one
colour: its filter keeps every live pair and, for the colour gradient,
its colour gate every pair of unlike colour (with the gate inverted the
sphere case fails), and the unlike pairs equal their brute-force count.
On the column grid the kernels take each staged cell's live reach from
its alive prefix, by a binary search over its types: the invariant that
rests on (a cell's alive slots are exactly its first min(count, cap)
ranks) is held after grid.build and pack_dense, with a cell over the cap
and right after a phase-change insertion, and the search's reach is held
equal to the per-slot ballot reach with fewer type reads.
The layouts themselves are held exactly against the JAX package in
tests/test_torch_cellgrid.py and tests/test_torch_band_layout.py."""

import numpy as np
import pytest
import torch

from tpusph_torch import grid
from tpusph_torch.bench import build_bubble_sim
from tpusph_torch.ops import band_pair, cell_filter, pallas_pair
from tpusph_torch.ops.rows import RTYPE, TABLES_1D
from tpusph_torch.params import PairTables
from tpusph_torch.state import Box, state_from_arrays

from test_torch_strip_filter import brute_force_pairs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lattice(dim, shape, periodic, hfac, seed, dx=0.5, dense_cell=0,
            types="random"):
    """A jittered two-type lattice of ``shape`` sites, cutoffs ``hfac``
    spacings, and ``dense_cell`` more particles packed into a cube of side
    1.2 inside one cell; ``types`` "random" (1 or 2 at random), "sphere"
    (type 2 within L/5 of the box centre, the bench's vapour sphere, type
    1 elsewhere) or "one" (all type 1): (state, box, tables, cutoff), the
    tables on the CPU (``DeviceTables``)."""
    rng = np.random.default_rng(seed)
    ax = [np.arange(m) * dx for m in shape]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape)
    L = [m * dx for m in shape] + [1.0]
    if dense_cell:
        # inside the cell [1.5, 3)^3 of the 12^3 lattice's grid
        pts = np.concatenate([pts, 2.25 + rng.uniform(-0.6, 0.6,
                                                      (dense_cell, 3))])
    if dim == 2:
        pts[:, 2] = 0.0
    n = len(pts)
    typ = rng.integers(1, 3, n)
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
    tables.set_surfacetension(1, 2, sigma=0.8, h=h)
    return st, box, tables.stacked("cpu"), tables.max_cut()


def column_grid(st, box, cutoff, dim, cap=None):
    """(backend, sorted state, cell-grid data) of the column kernel's cell
    grid after its first build."""
    geom = grid.make_geometry(box, cutoff, dim, skin=0.2, cap=cap)
    backend = pallas_pair.PallasBackend(geom, box, ntypes=2, device="cpu")
    st, aux = backend.init_aux(st, box)
    return backend, st, aux


def column_layout(st, box, cutoff, dim, cap=None):
    """(fld, layout, alive positions) of the column kernel's cell grid."""
    backend, st, aux = column_grid(st, box, cutoff, dim, cap)
    assert int(aux.overflow.sum()) == 0
    fld, _, _ = pallas_pair.pack_dense(st, aux, backend.colgrid)
    return fld, backend.colgrid, st.x[st.alive].numpy()


def band_layout(st, box, cutoff, dim):
    """(fld, layout, alive positions) of the band's sub-cell layout."""
    geom = band_pair.choose_band_geometry(box, cutoff, dim, 0.2,
                                          x=st.x[st.alive].numpy())
    assert geom is not None
    backend = band_pair.BandBackend(geom, ntypes=2)
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
    return band_pair.pack_fields(st), geom, st.x[st.alive].numpy()


def two_subcell_warps(fld, geom):
    """Warps of the band kernel holding alive rows of two sub-cells."""
    slot = torch.arange(geom.n_slots)
    alive = fld[RTYPE] > 0.5
    warp = (slot // geom.gc) * (-(-geom.gc // 32)) + (slot % geom.gc) // 32
    sub = slot // geom.c
    first = torch.full((int(warp.max()) + 1,), geom.n_slots).scatter_reduce(
        0, warp[alive], sub[alive], "amin")
    last = torch.full_like(first, -1).scatter_reduce(
        0, warp[alive], sub[alive], "amax")
    return int((last > first).sum())


@pytest.mark.parametrize("kind,dim,shape,periodic,hfac,dense_cell", [
    ("column", 3, (12, 12, 12), (True, True, True), 2.2, 0),
    ("column", 3, (12, 12, 12), (False, False, False), 2.2, 0),
    ("column", 2, (40, 40), (True, True, False), 2.2, 0),
    ("column", 3, (12, 12, 12), (True, True, True), 2.2, 480),
    ("band", 3, (12, 12, 12), (True, True, True), 2.2, 0),
    ("band", 3, (12, 12, 12), (False, False, False), 2.2, 0),
    ("band", 2, (40, 40), (True, True, False), 2.2, 0),
    ("band", 3, (20, 20, 12), (True, True, False), 4.5, 0),
])
def test_filter_is_conservative_and_windows_hold_every_pair(
        kind, dim, shape, periodic, hfac, dense_cell):
    st, box, tabs, cutoff = lattice(dim, shape, periodic, hfac,
                                    seed=dim + len(shape),
                                    dense_cell=dense_cell)
    cut2 = tabs.cutmax2["force"]
    if kind == "column":
        # one cell of 507 rows: cap 510, four chunks of 128 slots a cell
        fld, lay, x = column_layout(st, box, cutoff, dim,
                                    cap=510 if dense_cell else None)
    else:
        fld, lay, x = band_layout(st, box, cutoff, dim)
    c = cell_filter.cell_pass_counts(fld, lay, cut2)
    assert c["live_pairs"] > 0
    assert c["live_outside_box"] == 0, c
    # the column grid finds its reach from the alive prefixes, the band
    # reads every slot
    if kind == "column":
        assert c["reach_reads"] < c["ballot_reads"], c
    else:
        assert c["reach_reads"] == c["ballot_reads"], c
    assert c["queue_passes"] <= c["old_passes"] <= c["box_survivors"], c
    # a warp's survivors lie inside its block's box
    wpc = cell_filter.block_threads(cell_filter.as_band(lay)) // 32
    assert c["box_survivors"] <= wpc * c["staged_with_terms"], c
    assert c["staged_with_terms"] <= c["staged_rows"], c
    if hfac > 4:
        # the pair queue runs many times inside one neighbour column
        assert c["most_window_pairs"] > 4 * 128, c
    if dense_cell:
        # chunks past every alive row, and windows staged in two rounds
        assert c["blocks"] == 4 * lay.ncols * lay.ncz, c
        assert c["blocks_alive"] == lay.ncols * lay.ncz + 3, c
        assert c["multi_round_windows"] > 0, c
    # the windows' pairs are exactly the pairs within the cutoff
    assert c["live_pairs"] == brute_force_pairs(x, box, cut2)


def test_band_cases_cover_c_not_a_multiple_of_32():
    """Two band cases above have sub-cells of c slots, c not a multiple of
    32, and in one of them warps hold alive rows of two sub-cells."""
    odd, two = [], []
    for dim, shape, periodic, hfac in ((2, (40, 40), (True, True, False),
                                        2.2),
                                       (3, (20, 20, 12), (True, True, False),
                                        4.5)):
        st, box, _, cutoff = lattice(dim, shape, periodic, hfac,
                                     seed=dim + len(shape))
        fld, lay, _ = band_layout(st, box, cutoff, dim)
        odd.append(lay.c % 32 != 0)
        two.append(two_subcell_warps(fld, lay))
    assert all(odd) and max(two) > 0, (odd, two)


def brute_force_unlike_pairs(x, colour, box, cut2):
    """Ordered pairs (i != j) of the positions ``x`` with 1e-12 < rsq <
    cut2 (minimum image, float64) whose colours differ."""
    x = x.astype(np.float64)
    L = np.asarray(box.hi, np.float64) - np.asarray(box.lo, np.float64)
    per = np.asarray(box.periodic)
    total = 0
    for a in range(0, len(x), 512):
        d = x[a:a + 512, None, :] - x[None, :, :]
        d = np.where(per, d - L * np.round(d / L), d)
        rsq = (d * d).sum(-1)
        unlike = colour[a:a + 512, None] != colour[None, :]
        total += int(((rsq > 1e-12) & (rsq < cut2) & unlike).sum())
    return total


SWEEP_CASES = [
    ("band", 3, (12, 12, 12), (True, True, True), 2.2, "random"),
    ("band", 3, (12, 12, 12), (False, False, False), 2.2, "random"),
    ("band", 2, (40, 40), (True, True, False), 2.2, "random"),
    ("band", 3, (20, 20, 12), (True, True, False), 4.5, "random"),
    ("band", 3, (16, 16, 16), (True, True, True), 2.2, "sphere"),
    ("band", 3, (12, 12, 12), (True, True, True), 2.2, "one"),
    ("column", 3, (12, 12, 12), (True, True, True), 2.2, "random"),
    ("column", 3, (12, 12, 12), (False, False, False), 2.2, "random"),
    ("column", 2, (40, 40), (True, True, False), 2.2, "random"),
    ("column", 3, (16, 16, 16), (True, True, True), 2.2, "sphere"),
]


@pytest.mark.parametrize("sweep", ["rho", "cgrad"])
@pytest.mark.parametrize("kind,dim,shape,periodic,hfac,types", SWEEP_CASES)
def test_sweep_filter_is_conservative_and_gated(kind, dim, shape, periodic,
                                                hfac, types, sweep):
    """The rho / colour-gradient sweep's filter (csrc/cell_sweep.cuh):
    every live pair survives the boxes, and for the colour gradient every
    live pair of unlike colour also survives the block's and the warp's
    colour gate; the windows' pairs (and their unlike pairs) are exactly
    the brute-force pairs. The vapour sphere leaves blocks with no unlike
    row within reach, which the gate drops; one colour drops every
    block."""
    st, box, tabs, cutoff = lattice(dim, shape, periodic, hfac,
                                    seed=dim + len(shape) + 5, types=types)
    if kind == "column":
        fld, lay, x = column_layout(st, box, cutoff, dim)
    else:
        fld, lay, x = band_layout(st, box, cutoff, dim)
    cut2 = tabs.cutmax2[sweep]
    colors = tabs.tab1[TABLES_1D.index("color")]
    c = cell_filter.cell_pass_counts(fld, lay, cut2, sweep, colors)
    assert c["live_outside_box"] == 0, c
    assert c["body_passes"] <= c["box_survivors"], c
    wpc = cell_filter.block_threads(cell_filter.as_band(lay)) // 32
    assert c["box_survivors"] <= wpc * c["staged_with_terms"], c
    assert c["staged_with_terms"] <= c["staged_rows"], c
    assert c["live_pairs"] == brute_force_pairs(x, box, cut2)
    if kind == "column":
        # the search and, for cgrad, the gate's pass over the prefixes
        assert c["reach_reads"] < c["ballot_reads"], c
    alive = fld[RTYPE] > 0.5
    colour = colors[fld[RTYPE][alive].long()].numpy()
    assert x.shape[0] == colour.shape[0]
    if sweep == "rho":
        assert c["gate_exits"] == 0 and c["needed_pairs"] == c["live_pairs"]
        return
    assert c["needed_pairs"] == brute_force_unlike_pairs(x, colour, box,
                                                         cut2)
    if types == "one":
        # no pair of unlike colour: every block exits on the gate
        assert c["gate_exits"] == c["blocks_alive"] > 0, c
        assert c["staged_rows"] == c["box_survivors"] == 0, c
    elif types == "sphere":
        # blocks far from the sphere exit, those near it sweep
        assert 0 < c["gate_exits"] < c["blocks_alive"], c
        assert c["needed_pairs"] > 0, c


def column_case(case):
    """(fld, colgrid, cell occupancy) of a column grid after its first
    build: a 12^3 lattice ("lattice"), one cell of 507 rows under cap 510
    ("dense_cell") or under the default cap of 64 ("over_cap": pack_dense
    drops its ranks from 64 up), 2D, open edges."""
    dim, shape, periodic, dense, cap = 3, (12, 12, 12), (True,) * 3, 0, None
    if case == "dense_cell":
        dense, cap = 480, 510
    elif case == "over_cap":
        dense = 480
    elif case == "2d":
        dim, shape, periodic = 2, (40, 40), (True, True, False)
    elif case == "open":
        periodic = (False,) * 3
    st, box, _, cutoff = lattice(dim, shape, periodic, 2.2, seed=13,
                                 dense_cell=dense)
    backend, st, aux = column_grid(st, box, cutoff, dim, cap)
    assert (int(aux.overflow.sum()) > 0) == (case == "over_cap")
    fld, _, _ = pallas_pair.pack_dense(st, aux, backend.colgrid)
    return fld, backend.colgrid, aux.counts


def alive_prefixes_hold(fld, cg, counts):
    """Whether the alive slots of every cell are exactly its first
    min(count, cap) ranks."""
    alive = (fld[RTYPE] > 0.5).reshape(-1, cg.cap)
    return torch.equal(alive, torch.arange(cg.cap)
                       < counts.clamp(max=cg.cap)[:, None])


@pytest.mark.parametrize("case", ["lattice", "over_cap", "2d", "open",
                                  "bubble_insertion"])
def test_column_alive_slots_are_each_cells_prefix(case):
    """The invariant the column kernels' live reach rests on
    (csrc/cell_sweep.cuh): after grid.build and pack_dense, type > 0.5
    holds on exactly ranks [0, min(count, cap)) of every cell; with a cell
    over the cap; and on the 12^3 bubble right after a phase-change
    insertion, both on the stale grid (the new rows are in no cell yet)
    and on the rebuild the insertion forces before the next force pass."""
    if case != "bubble_insertion":
        assert alive_prefixes_hold(*column_case(case))
        return
    sim = build_bubble_sim(device="cpu", backend="pallas")
    n0 = sim.natoms
    while sim.natoms == n0:
        assert sim.step_count < 10, "no insertion fired"
        sim.run(1)
    backend = sim._runner.backend
    cg = backend.colgrid
    fld, _, _ = pallas_pair.pack_dense(sim.state, sim.aux, cg)
    assert alive_prefixes_hold(fld, cg, sim.aux.counts)
    assert int((fld[RTYPE] > 0.5).sum()) < sim.natoms
    state, aux, rebuilt = backend.prepare(sim.state, sim.aux,
                                          sim.step_count, sim.box)
    assert rebuilt and int(aux.overflow.sum()) == 0
    fld, _, _ = pallas_pair.pack_dense(state, aux, cg)
    assert alive_prefixes_hold(fld, cg, aux.counts)
    assert int((fld[RTYPE] > 0.5).sum()) == sim.natoms


@pytest.mark.parametrize("case", ["dense_cell", "2d", "open", "over_cap"])
def test_prefix_reach_equals_ballot_reach(case):
    """The column kernels' binary search for each cell's alive prefix
    (``cell_filter.alive_prefix``, the kernel's) finds the reach the
    per-slot ballot pass finds (one past the last alive rank) on every
    cell, with at most ceil(log2(cap + 1)) type reads a cell; on a cell
    that breaks the invariant (a dead rank below an alive one) it does
    not."""
    fld, cg, _ = column_case(case)
    typ = fld[RTYPE].reshape(-1, cg.cap)
    ballot = ((typ > 0.5).long() * torch.arange(1, cg.cap + 1)).amax(1)
    reach, reads = cell_filter.alive_prefix(typ)
    assert torch.equal(reach, ballot)
    assert int(reads.max()) <= int(np.ceil(np.log2(cg.cap + 1)))
    assert int(reads.sum()) < typ.numel()
    # kill the first alive rank the search reads in the fullest cell (its
    # probes halve the cap while they read dead ranks): its alive rows are
    # no prefix, and the search stops below them
    full = int(ballot.argmax())
    rank = cg.cap // 2
    while typ[full, rank] <= 0.5:
        rank //= 2
    typ[full, rank] = 0.0
    reach, _ = cell_filter.alive_prefix(typ)
    assert int(reach[full]) <= rank < int(ballot[full])
