"""The counts that decide the strip rho / force kernels' design
(``strip_pair.warp_pass_counts``) on small strip layouts: 3D periodic, 3D
open, 2D, and a lattice so dense (cutoff 4.5 spacings, ~330 neighbours a
row) that the force kernel's pair queue flushes often inside one neighbour
column.

The kernels filter before they compute: a warp tests its window rows
against the box of its 32 rows (distance below the cutoff), then each lane
tests the box's survivors exactly. Here: every live pair of the windows is
a box survivor (the filter is conservative, as the kernel needs: a pair it
drops is a pair missing from a sum); the pair queue's body passes never
exceed per-lane lists', nor those the lockstep scan's; and the windows hold
every pair within the cutoff: the live pairs of the owned rows equal a
brute-force all-pairs count in numpy (minimum image) on the same
positions. The layout itself is held exactly
against the JAX package in tests/test_torch_strip_layout.py."""

import numpy as np
import pytest
import torch

from tpusph_torch.ops import strip_pair
from tpusph_torch.ops.band_pair import pack_fields
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
           candidates=strip_pair.DEFAULT_TS_CH):
    """A jittered two-type lattice of ``shape`` sites, cutoffs ``hfac``
    spacings, on its strip layout (tile rows and window chunks chosen from
    ``candidates``): (backend, state, aux, cut2)."""
    rng = np.random.default_rng(seed)
    ax = [np.arange(m) * dx for m in shape]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, dim)
    if dim == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    pts = pts + rng.uniform(-0.1 * dx, 0.1 * dx, pts.shape)
    if dim == 2:
        pts[:, 2] = 0.0
    n = len(pts)
    st = state_from_arrays(pts.astype(np.float32), rng.integers(1, 3, n),
                           np.full(n, 0.1),
                           capacity=((n + 127) // 128) * 128, device="cpu")
    L = [m * dx for m in shape] + [1.0]
    box = Box.create([0, 0, 0], L[:3], periodic, device="cpu")
    tables = PairTables.zeros(2)
    h = hfac * dx
    for i, j in ((1, 2), (1, 1), (2, 2)):
        tables.set_taitwater(i, j, rho0=1.0, c0=6.0, viscosity=0.4, h=h)
        tables.set_rhosum(i, j, h=h)
        tables.set_heatconduction(i, j, d=0.15, h=0.9 * h)
    geom = strip_pair.choose_strip_geometry(
        box, tables.max_cut(), dim, 0.2, x=st.x[st.alive].numpy(),
        candidates=candidates)
    assert geom is not None
    backend = strip_pair.StripBackend(geom, ntypes=2, device="cpu")
    st, aux = backend.init_aux(st, box)
    assert int(aux.overflow.sum()) == 0
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
