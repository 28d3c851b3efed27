"""The change-set pool: new rows in A_i, base rows in B_i, the share of
merging pairs, and the cycle that returns the explicit set to its base."""

import numpy as np
import pytest

from bench.lib import changesets, kg
from bench.lib.keys import pack

OC = dict(n_groups=200, group_size=8, n_spokes_per=2, n_plain=3000, hierarchy_depth=3)


@pytest.mark.parametrize("merge_share", [0.0, 0.4])
def test_pool_rows(merge_share):
    g = kg.generate(11, **OC)
    base, pool, n_pairs = changesets.draw_pool(g, 2**31 + 9, 256, 3, merge_share)
    assert n_pairs == round(merge_share * 128)
    for add, delete in pool:
        ka, kd = pack(add), pack(delete)
        assert add.shape == delete.shape == (256, 3)
        assert np.unique(ka).shape[0] == 256 and np.unique(kd).shape[0] == 256
        assert not np.isin(ka, base).any() and np.isin(kd, base).all()
        fresh = add[:, 2] >= g.n_resources
        assert fresh.sum() == 2 * n_pairs and (add[fresh, 1] == g.id_prop).all()
    assert not np.array_equal(pool[0][0], pool[1][0])


def test_cycle_returns_the_explicit_set_to_its_base():
    g = kg.generate(3, **OC)
    base, pool, _ = changesets.draw_pool(g, 4, 128, 2, 0.4)
    current = set(base.tolist())
    for i in range(len(pool)):
        for kind, op, rows in changesets.events(pool, i):
            k = set(pack(rows).tolist())
            current = current | k if op == "add" else current - k
            want = changesets.expected_explicit(base, pool, i, kind)
            assert current == set(want.tolist())
        assert current == set(base.tolist())


def test_same_seed_same_pool():
    g = kg.generate(3, **OC)
    a = changesets.draw_pool(g, 8, 64, 2, 0.4)[1]
    b = changesets.draw_pool(g, 8, 64, 2, 0.4)[1]
    c = changesets.draw_pool(g, 9, 64, 2, 0.4)[1]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    assert not np.array_equal(a[0][1], c[0][1])
