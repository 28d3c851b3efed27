"""The port's union-find (``repro_torch.core.uf``) against the reference's
``merge_pairs_jax``/``_compress_jax`` and ``merge_pairs_np``, exactly:
random pair sets, long chains, pairs already merged and masked-out rows.
The representative of every clique is its minimum ID."""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import uf as juf  # noqa: E402
from repro_torch.core import uf  # noqa: E402


def _pairs(kind, n, m, rng):
    if kind == "random":
        return rng.integers(0, n, (m, 2))
    if kind == "chain":  # one long chain, links in random order
        x = rng.permutation(n - 1)[:m]
        return np.stack([x, x + 1], axis=1)
    # cliques of 4 consecutive IDs, each pair listed in both directions
    x = np.arange(n - 1)
    x = x[x % 4 != 3][: m // 2]
    return np.concatenate([np.stack([x, x + 1], 1), np.stack([x + 1, x], 1)])


@pytest.mark.parametrize("kind", ["random", "chain", "cliques"])
@pytest.mark.parametrize("n,m", [(8, 3), (200, 150), (1000, 900)])
def test_merge_pairs_matches_reference(kind, n, m):
    rng = np.random.default_rng(n + m + len(kind))
    start = np.arange(n, dtype=np.int32)
    # a prior merge, so some pairs join resources that are already merged
    start, _ = juf.merge_pairs_np(start, rng.integers(0, n, (n // 4, 2)))
    pairs = _pairs(kind, n, m, rng).astype(np.int32)
    valid = rng.random(pairs.shape[0]) < 0.85

    got = uf.merge_pairs(torch.from_numpy(start), torch.from_numpy(pairs),
                         torch.from_numpy(valid)).numpy()
    want_jax = np.asarray(juf.merge_pairs_jax(
        jnp.asarray(start), jnp.asarray(pairs), jnp.asarray(valid)
    ))
    want_np, n_merged = juf.merge_pairs_np(start, pairs[valid])
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    port_np, port_merged = uf.merge_pairs_np(start, pairs[valid])
    np.testing.assert_array_equal(port_np, want_np)
    assert port_merged == n_merged
    # the representative is each class's minimum, and rho is idempotent
    assert (got <= np.arange(n)).all()
    np.testing.assert_array_equal(got[got], got)


def test_merge_pairs_all_masked_or_already_merged_is_identity():
    rep = np.asarray([0, 0, 2, 2, 4], np.int32)
    pairs = np.asarray([[0, 1], [3, 2], [4, 4], [1, 4]], np.int32)
    valid = np.asarray([True, True, True, False])
    got = uf.merge_pairs(torch.from_numpy(rep), torch.from_numpy(pairs),
                         torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, rep)


@pytest.mark.parametrize("n", [1, 50, 1000])
def test_compress_matches_reference(n):
    rng = np.random.default_rng(n)
    rep = np.arange(n, dtype=np.int32)
    for x in range(1, n):
        if rng.random() < 0.7:
            rep[x] = rng.integers(0, x)
    got = uf.compress(torch.from_numpy(rep)).numpy()
    np.testing.assert_array_equal(got, np.asarray(juf._compress_jax(jnp.asarray(rep))))
    np.testing.assert_array_equal(got, juf.compress_np(rep))
    np.testing.assert_array_equal(uf.compress_np(rep), juf.compress_np(rep))
