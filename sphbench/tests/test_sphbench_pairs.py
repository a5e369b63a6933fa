"""The benchmark's pair search and count against a brute-force count."""

import itertools

import numpy as np
import pytest
import torch

from sphbench import pairs


def brute(x, length, cut, periodic=(True,) * 3):
    dx = x[:, None, :] - x[None, :, :]
    dx -= np.where(periodic, length * np.round(dx / length), 0.0)
    rsq = (dx * dx).sum(-1)
    np.fill_diagonal(rsq, np.inf)
    return rsq < cut * cut


PERIODIC = (True, True, True)


@pytest.mark.parametrize("length,cut,n,lo,periodic", [
    ((12.0, 12.0, 12.0), 3.0, 600, 0.0, PERIODIC),   # four cells an axis
    ((6.5, 9.0, 13.0), 3.0, 400, 0.0, PERIODIC),     # two, three, four cells
    ((16.0, 16.0, 16.0), 3.0, 2000, 0.0, PERIODIC),
    # boundary p p f: a 2:1:1 box from a lower corner off the origin
    ((24.0, 12.0, 12.0), 3.0, 1500, (0.0, 0.0, -2.0), (True, True, False)),
    # non-periodic axes of one and two cells, and one of a single cutoff
    ((13.0, 5.0, 3.5), 3.0, 500, (-1.0, 2.0, 0.5), (True, False, False)),
    ((3.0, 7.0, 12.0), 3.0, 400, 0.0, (False, False, False)),
])
def test_pair_search_equals_brute_force(length, cut, n, lo, periodic):
    rng = np.random.default_rng(5)
    L = np.array(length)
    x = np.asarray(lo) + rng.uniform(0, 1, (n, 3)) * L
    # rows past a non-periodic face bin into the face's cell
    x[:5] += np.where(periodic, 0.0, 0.4 * cut)
    x[5:10] -= np.where(periodic, 0.0, 1.3 * cut)
    want = brute(x, L, cut, periodic)
    pl = pairs.PairList(torch.tensor(x), torch.tensor(L), cut, lo, periodic)
    got = np.zeros_like(want)
    got[pl.i.numpy(), pl.j.numpy()] = True
    assert len(pl) == int(want.sum())
    assert (got == want).all()


def test_count_equals_brute_force():
    rng = np.random.default_rng(9)
    L = np.array([14.0, 14.0, 14.0])
    x = rng.uniform(0, 1, (1500, 3)) * L
    typ = np.where(np.linalg.norm(x - L / 2, axis=1) < 4.0, 2, 1)
    near = brute(x, L, 3.0)
    unlike = near & (typ[:, None] != typ[None, :])
    flag = unlike.any(1)
    iface = near & (flag[:, None] | flag[None, :])
    got = pairs.count(torch.tensor(x), torch.tensor(typ), L, 3.0)
    assert got == dict(rows=1500, pairs=int(near.sum()),
                       unlike=int(unlike.sum()),
                       interface=int(iface.sum()))


def test_positions_outside_the_box_wrap():
    x = np.array([[0.5, 0.5, 0.5], [9.7, 0.5, 0.5], [-0.2, 0.6, 0.5]])
    pl = pairs.PairList(torch.tensor(x), 10.0, 1.0)
    got = {(int(i), int(j)) for i, j in zip(pl.i, pl.j)}
    want = {(a, b) for a, b in itertools.permutations(range(3), 2)
            if brute(x, np.array([10.0] * 3), 1.0)[a, b]}
    assert got == want and len(want) == 6
