"""The device rewrite of `make_stereo_pair` keeps the recipe's statistics."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.frames import make_pool
from depth_estimation_torch.data.synthetic import make_stereo_pair


@pytest.mark.parametrize("layers,max_disp,contrast", [(5, 14, 0.5), (6, 40, 1.0)])
def test_pool_statistics(layers, max_disp, contrast):
    pool = make_pool(2**31 + 12345, 6, 72, 128, layers, max_disp, contrast, "cpu")
    lo, hi = 0.5 - contrast / 2, 0.5 + contrast / 2
    assert pool.left.shape == pool.right.shape == (6, 72, 128, 3)
    assert pool.gt.shape == (6, 72, 128)
    for x in (pool.left, pool.right):
        assert float(x.min()) >= lo - 1e-6 and float(x.max()) <= hi + 1e-6
        assert float(x.max() - x.min()) > 0.9 * contrast  # each texture spans its range
    for p in range(6):
        d = torch.unique(pool.gt[p])
        assert d[0] == 0 and 1 <= len(d) - 1 <= layers  # a layer may hide another
        assert float(d[1:].min()) >= 1 and float(d.max()) <= max_disp
        assert float(d.max()) == d.max().round()


def test_matches_the_recipe_where_it_is_not_random():
    """The numpy recipe and the rewrite agree on what they share: the
    layer count and disparity range, the background's share of gt = 0, and
    the right view equal to the left shifted by gt wherever a layer shows."""
    rng = np.random.RandomState(0)
    ref_bg = np.mean([(make_stereo_pair(rng, 72, 128, 5, 14)[2] == 0).mean() for _ in range(20)])
    pool = make_pool(7, 20, 72, 128, 5, 14, 1.0, "cpu")
    bg = float((pool.gt == 0).float().mean())
    assert abs(bg - ref_bg) < 0.1
    for p in range(20):
        gt = pool.gt[p].long()
        ii, jj = torch.nonzero(gt > 0, as_tuple=True)
        jr = jj - gt[ii, jj]
        ok = jr >= 0
        ii, jj, jr, d = ii[ok], jj[ok], jr[ok], gt[ii, jj][ok]
        # the nearest layer that lands on a right-view pixel is the one it shows
        order = torch.argsort((ii * 128 + jr) * 1000 + d)
        key = (ii * 128 + jr)[order]
        last = torch.ones_like(key, dtype=torch.bool)
        last[:-1] = key[1:] != key[:-1]
        shown = order[last]
        ii, jj, jr = ii[shown], jj[shown], jr[shown]
        assert torch.equal(pool.right[p][ii, jr], pool.left[p][ii, jj])


def test_same_seed_same_pool_other_seed_other_pool():
    a = make_pool(99, 2, 32, 48, 3, 8, 0.5, "cpu")
    b = make_pool(99, 2, 32, 48, 3, 8, 0.5, "cpu")
    c = make_pool(100, 2, 32, 48, 3, 8, 0.5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.left, c.left)
