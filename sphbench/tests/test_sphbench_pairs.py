"""The benchmark's pair search and count against a brute-force count."""

import itertools

import numpy as np
import pytest
import torch

from sphbench import pairs


def brute(x, length, cut):
    dx = x[:, None, :] - x[None, :, :]
    dx -= length * np.round(dx / length)
    rsq = (dx * dx).sum(-1)
    np.fill_diagonal(rsq, np.inf)
    return rsq < cut * cut


@pytest.mark.parametrize("length,cut,n", [
    ((12.0, 12.0, 12.0), 3.0, 600),     # four cells an axis
    ((6.5, 9.0, 13.0), 3.0, 400),       # two, three and four cells
    ((16.0, 16.0, 16.0), 3.0, 2000),
])
def test_pair_search_equals_brute_force(length, cut, n):
    rng = np.random.default_rng(5)
    L = np.array(length)
    x = rng.uniform(0, 1, (n, 3)) * L
    want = brute(x, L, cut)
    pl = pairs.PairList(torch.tensor(x), torch.tensor(L), cut)
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
