"""The port's kernels (plain versions, via ``ops`` on CPU tensors) against
the reference's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode (``repro.kernels.ops``), bit for bit.

Inputs come from numpy seeds and include duplicates, the KEY_MAX tail, the
21-bit ID boundary and sizes that are no multiple of any block.  Every
value is an integer, so every comparison is exact.
"""

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

from repro.kernels import merge as jmerge, ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import merge, ops  # noqa: E402

KEY_MAX = (1 << 63) - 1
MAX_ID = (1 << 21) - 1
# the largest packable keys: <2^21-1, 2^21-1, 2^21-2> sits just below KEY_MAX
EDGE_KEYS = [
    (MAX_ID << 42) | (MAX_ID << 21) | (MAX_ID - 1),
    (MAX_ID << 42) | (MAX_ID << 21),
    MAX_ID,
    0,
]


def _keys(rng, n, dup):
    keys = rng.integers(0, 1 << 62, n).astype(np.int64)
    n_dup = int(n * dup)
    if n_dup:
        keys[rng.integers(0, n, n_dup)] = rng.choice(keys, n_dup)
    keys[rng.integers(0, n, min(n, len(EDGE_KEYS)))] = EDGE_KEYS[: min(n, 4)]
    keys[-max(n // 8, 1):] = KEY_MAX
    return keys


@pytest.mark.parametrize("n", [1, 7, 128, 513, 1000])
@pytest.mark.parametrize("dup", [0.0, 0.5, 1.0])
def test_dedup_order(n, dup):
    keys = _keys(np.random.default_rng(n * 10 + int(dup * 4)), n, dup)
    port = ops.dedup_order(torch.from_numpy(keys)).numpy()
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, jref.dedup_order_ref(keys))
    with jax.enable_x64(True):
        pallas = np.asarray(jops.dedup_order(jnp.asarray(keys)))
    np.testing.assert_array_equal(port, pallas)


@pytest.mark.parametrize("nq,nk", [(1, 1), (10, 64), (257, 1000), (1000, 3)])
@pytest.mark.parametrize("big", [False, True])
def test_search_bounds(nq, nk, big):
    rng = np.random.default_rng(nq + nk + big)
    keys = np.sort(rng.integers(0, 1 << (62 if big else 20), nk).astype(np.int64))
    keys[-max(nk // 4, 1):] = KEY_MAX
    keys = np.sort(np.concatenate([keys[:-1], [EDGE_KEYS[0]]]))
    queries = np.concatenate([
        rng.choice(keys, nq - nq // 2),
        rng.integers(0, 1 << (62 if big else 20), nq // 2),
    ]).astype(np.int64)
    queries[0] = EDGE_KEYS[0]
    lo, hi = ops.search_bounds(torch.from_numpy(queries), torch.from_numpy(keys))
    want_lo, want_hi = jref.search_bounds_ref(queries, keys)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    # the Pallas kernel pads its key tiles with KEY_MAX, so KEY_MAX queries
    # (the engine's invalid rows) are outside its domain
    real = queries < KEY_MAX
    pallas_lo, pallas_hi = jops.search_bounds(queries, keys)
    np.testing.assert_array_equal(lo.numpy()[real], np.asarray(pallas_lo)[real])
    np.testing.assert_array_equal(hi.numpy()[real], np.asarray(pallas_hi)[real])
    left = ops.searchsorted(torch.from_numpy(keys), torch.from_numpy(queries))
    np.testing.assert_array_equal(left.numpy(), lo.numpy())


@pytest.mark.parametrize("nq,nk", [(9, 50), (300, 1000)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_prefix_range_bounds(nq, nk, k):
    rng = np.random.default_rng(nq * 3 + k)
    ids = rng.integers(0, 12, (nk, 3)).astype(np.int64)
    ids[:4] = MAX_ID  # rows at the 21-bit boundary
    keys = np.sort((ids[:, 0] << 42) | (ids[:, 1] << 21) | ids[:, 2])
    prefixes = rng.integers(0, 14, (nq, k)).astype(np.int32)
    prefixes[0] = MAX_ID
    start, end = ops.prefix_range_bounds(
        torch.from_numpy(prefixes), torch.from_numpy(keys)
    )
    want_s, want_e = jref.prefix_range_bounds_ref(prefixes, keys)
    np.testing.assert_array_equal(start.numpy(), want_s)
    np.testing.assert_array_equal(end.numpy(), want_e)
    # an all-(2^21-1) prefix has the high key KEY_MAX, which the Pallas
    # kernel's KEY_MAX tile padding also matches
    real = ~(prefixes == MAX_ID).all(axis=1)
    pallas_s, pallas_e = jops.prefix_range_bounds(prefixes, keys)
    np.testing.assert_array_equal(start.numpy()[real], np.asarray(pallas_s)[real])
    np.testing.assert_array_equal(end.numpy()[real], np.asarray(pallas_e)[real])


@pytest.mark.parametrize("n,v", [(5, 9), (300, 512), (1025, 700)])
def test_rewrite_triples(n, v):
    rng = np.random.default_rng(n + v)
    spo = rng.integers(0, v, (n, 3)).astype(np.int32)
    rho = np.arange(v, dtype=np.int32)
    merged = rng.integers(0, v, v // 3)
    rho[merged] = rng.integers(0, v, v // 3)
    out, changed = ops.rewrite_triples(torch.from_numpy(spo), torch.from_numpy(rho))
    for want_out, want_changed in (
        jref.rewrite_triples_ref(jnp.asarray(spo), jnp.asarray(rho)),
        jops.rewrite_triples(jnp.asarray(spo), jnp.asarray(rho)),
    ):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
        np.testing.assert_array_equal(changed.numpy(), np.asarray(want_changed))

    # the masked forms: candidate normalisation and the store sweep
    want_out = np.asarray(jref.rewrite_triples_ref(jnp.asarray(spo), jnp.asarray(rho))[0])
    diff = (want_out != spo).any(axis=1)
    valid = rng.random(n) < 0.7
    out_v, changed_v = ops.rewrite_triples(
        torch.from_numpy(spo), torch.from_numpy(rho), valid=torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(out_v.numpy(), np.where(valid[:, None], want_out, 0))
    np.testing.assert_array_equal(changed_v.numpy(), diff & valid)
    epoch = rng.integers(-1, 4, n).astype(np.int32)
    marked = rng.random(n) < 0.2
    out_s, changed_s = ops.rewrite_triples(
        torch.from_numpy(spo), torch.from_numpy(rho),
        epoch=torch.from_numpy(epoch), marked=torch.from_numpy(marked),
    )
    np.testing.assert_array_equal(out_s.numpy(), want_out)
    np.testing.assert_array_equal(changed_s.numpy(), diff & (epoch >= 0) & ~marked)


@pytest.mark.parametrize("na,nb", [(1, 1), (40, 7), (300, 300), (1000, 64)])
def test_merge_matches_reference(na, nb):
    """Rank-merge of a fresh sorted delta into a KEY_MAX-padded index, the
    way the engine inserts; the ranks go through the search kernel."""
    rng = np.random.default_rng(na * nb)
    a = np.sort(rng.integers(0, 1 << 40, na).astype(np.int64))
    a[-max(na // 3, 1):] = KEY_MAX
    b = np.sort(np.concatenate([rng.choice(a, nb // 2), rng.integers(0, 1 << 40, nb - nb // 2)]))
    a_vals = rng.integers(0, 1 << 20, na).astype(np.int32)
    b_vals = rng.integers(0, 1 << 20, nb).astype(np.int32)
    with jax.enable_x64(True):
        want_ranks = jmerge.merge_ranks(jnp.asarray(a), jnp.asarray(b))
        want = jmerge.merge_sorted(jnp.asarray(a), jnp.asarray(a_vals),
                                   jnp.asarray(b), jnp.asarray(b_vals))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got, ref_out in ((merge.merge_ranks(ta, tb), want_ranks),
                         (merge.merge_sorted(ta, torch.from_numpy(a_vals), tb,
                                             torch.from_numpy(b_vals)), want)):
        for g, w in zip(got, ref_out, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _forest(rng, v):
    """A union-find forest as min-hooking leaves it: rep[x] <= x."""
    rep = np.arange(v, dtype=np.int32)
    for x in range(1, v):
        if rng.random() < 0.6:
            rep[x] = rng.integers(0, x)
    for x in range(max(v // 2, 1), min(v, v // 2 + 40)):  # one deep chain
        rep[x] = x - 1
    return rep


@pytest.mark.parametrize("v", [1, 7, 300, 1000])
def test_uf_compress_is_iterated_pointer_jump(v):
    rep = _forest(np.random.default_rng(v), v)
    port = torch.from_numpy(rep.copy())
    ops.uf_compress_(port)
    pallas = jnp.asarray(rep)
    while True:  # rep = rep[rep] to the fixpoint, each step a Pallas call
        nxt = jops.pointer_jump(pallas, pallas)
        if np.array_equal(np.asarray(nxt), np.asarray(pallas)):
            break
        pallas = nxt
    np.testing.assert_array_equal(port.numpy(), np.asarray(pallas))
    ref_rep = jnp.asarray(rep)
    while not np.array_equal(np.asarray(jref.pointer_jump_ref(ref_rep, ref_rep)), np.asarray(ref_rep)):
        ref_rep = jref.pointer_jump_ref(ref_rep, ref_rep)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref_rep))


@pytest.mark.parametrize("v,m", [(9, 4), (300, 200), (1000, 999)])
def test_uf_hook_is_pointer_jump_then_scatter_min(v, m):
    rng = np.random.default_rng(v * m)
    rep = np.arange(v, dtype=np.int32)
    a = rng.integers(0, v, m).astype(np.int32)
    b = rng.integers(0, v, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    # a first hook leaves rep uncompressed; compress it for the second
    rep_t, a_t, b_t = (torch.from_numpy(x.copy()) for x in (rep, a, b))
    ops.uf_hook_(rep_t, a_t, b_t, torch.from_numpy(valid))
    ops.uf_compress_(rep_t)
    rep = rep_t.numpy().copy()
    a_t, b_t = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    flag = ops.uf_hook_(rep_t, a_t, b_t, torch.from_numpy(valid))

    ra = np.asarray(jops.pointer_jump(jnp.asarray(a), jnp.asarray(rep)))
    rb = np.asarray(jops.pointer_jump(jnp.asarray(b), jnp.asarray(rep)))
    lo, hi = np.minimum(ra, rb), np.maximum(ra, rb)
    active = valid & (lo != hi)
    want = rep.copy()
    np.minimum.at(want, hi[active], lo[active])
    np.testing.assert_array_equal(a_t.numpy(), ra)
    np.testing.assert_array_equal(b_t.numpy(), rb)
    np.testing.assert_array_equal(rep_t.numpy(), want)
    assert int(flag) == int(active.any())


def test_cuda_tensors_never_take_the_plain_version():
    """Tensors off the CPU get the kernel or an exception: a meta tensor,
    for which no kernel exists, is refused rather than served by the plain
    version."""
    keys = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ops.dedup_order(keys)
    with pytest.raises(ValueError):
        ops.search_bounds(keys, keys)


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        ops.dedup_order(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.rewrite_triples(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.search_bounds(torch.zeros(8, dtype=torch.int64)[::2],
                          torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.prefix_range_bounds(torch.zeros((4, 4), dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int64))
