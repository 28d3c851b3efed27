"""The port's kernels (plain versions, via ``ops`` on CPU tensors) against
the reference's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode (``repro.kernels.ops``).

Inputs come from numpy seeds and include duplicates, the KEY_MAX tail, the
21-bit ID boundary and sizes that are no multiple of any block.  The
integer kernels (dedup, search, rewrite, union-find) are compared bit for
bit.  The two float kernels, ``segment_sum`` and ``embedding_bag``, sum in
f32 in another order than XLA, and take the reference's own sweeps and
tolerances (``tests/test_kernels.py``); their rows with ids out of range
are held against the Pallas kernels only, which drop those ids, where
``repro.kernels.ref.embedding_bag_ref`` clamps them.
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

from kernel_patterns import (  # noqa: E402
    BAG_PATTERNS, BAG_SHAPES, FM_SHAPES, REWRITE_CASES, SEARCH_PATTERNS,
    SEGMENT_PATTERNS, UNION_PATTERNS, bag_case, fm_case, prefix_case, rewrite_case,
    search_case, segment_case, union_case,
)
from repro.core import uf as juf  # noqa: E402
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


@pytest.mark.parametrize("pattern", SEARCH_PATTERNS)
def test_search_patterns(pattern):
    """The search kernel's input patterns (``kernel_patterns.py``: sorted
    queries with a KEY_MAX tail, cumsum plateaus, one repeated query,
    nearly sorted, long runs of equal queries, no order), both sides and
    each side alone: the plain version equals the reference's oracle, and
    its Pallas kernel on the queries of that kernel's domain."""
    queries, keys = search_case(pattern, 4100, 600, seed=3)
    tq, tk = torch.from_numpy(queries), torch.from_numpy(keys)
    want = jref.search_bounds_ref(queries, keys)
    for got, w in zip(ops.search_bounds(tq, tk), want, strict=True):
        np.testing.assert_array_equal(got.numpy(), w)
    for side, w in zip(("left", "right"), want, strict=True):
        np.testing.assert_array_equal(ops.searchsorted(tk, tq, side=side).numpy(), w)
    real = queries < KEY_MAX
    for got, w in zip(ops.search_bounds(tq, tk), jops.search_bounds(queries, keys),
                      strict=True):
        np.testing.assert_array_equal(got.numpy()[real], np.asarray(w)[real])


@pytest.mark.parametrize("nq,nk", [(0, 10), (10, 0), (10, 1), (1, 1)])
def test_search_empty_and_single(nq, nk):
    queries, keys = search_case("key_max_tail", nq, nk, seed=nq + nk)
    lo, hi = ops.search_bounds(torch.from_numpy(queries), torch.from_numpy(keys))
    want_lo, want_hi = jref.search_bounds_ref(queries, keys)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)


@pytest.mark.parametrize("sorted_rows", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_prefix_patterns(sorted_rows, k):
    """Prefix rows in the join's arbitrary order and sorted, some missing
    every key, over keys with 21-bit-boundary IDs."""
    rows, keys = prefix_case(sorted_rows, 2100, 500, k, seed=k)
    start, end = ops.prefix_range_bounds(torch.from_numpy(rows), torch.from_numpy(keys))
    want_s, want_e = jref.prefix_range_bounds_ref(rows, keys)
    np.testing.assert_array_equal(start.numpy(), want_s)
    np.testing.assert_array_equal(end.numpy(), want_e)
    real = ~(rows == MAX_ID).all(axis=1)
    pallas_s, pallas_e = jops.prefix_range_bounds(rows, keys)
    np.testing.assert_array_equal(start.numpy()[real], np.asarray(pallas_s)[real])
    np.testing.assert_array_equal(end.numpy()[real], np.asarray(pallas_e)[real])


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


@pytest.mark.parametrize("pattern,n", REWRITE_CASES)
def test_rewrite_triples(pattern, n):
    spo, rho, valid, epoch, marked, start = rewrite_case(pattern, n, seed=n)
    spo, valid, epoch, marked = (x[start:] for x in (spo, valid, epoch, marked))
    out, changed = ops.rewrite_triples(torch.from_numpy(spo), torch.from_numpy(rho))
    # ids outside rho are clamped into it, as the reference's gathers clamp
    # ids past the end; the Pallas kernel leaves them 0 and unflagged, and
    # numpy-style indexing wraps negative ids, so those two are held to the
    # rows inside rho
    want_out = np.asarray(jref.rewrite_triples_ref(
        jnp.asarray(np.clip(spo, 0, rho.shape[0] - 1)), jnp.asarray(rho))[0])
    diff = (want_out != spo).any(axis=1)
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(changed.numpy(), diff)
    inside = ((spo >= 0) & (spo < rho.shape[0])).all(axis=1)
    assert inside.all() == (pattern != "out_of_range")
    for other_out, other_changed in (
        jref.rewrite_triples_ref(jnp.asarray(spo), jnp.asarray(rho)),
        jops.rewrite_triples(jnp.asarray(spo), jnp.asarray(rho)),
    ):
        np.testing.assert_array_equal(out.numpy()[inside], np.asarray(other_out)[inside])
        np.testing.assert_array_equal(changed.numpy()[inside],
                                      np.asarray(other_changed)[inside])

    # the masked forms: candidate normalisation and the store sweep
    out_v, changed_v = ops.rewrite_triples(
        torch.from_numpy(spo), torch.from_numpy(rho), valid=torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(out_v.numpy(), np.where(valid[:, None], want_out, 0))
    np.testing.assert_array_equal(changed_v.numpy(), diff & valid)
    out_s, changed_s = ops.rewrite_triples(
        torch.from_numpy(spo), torch.from_numpy(rho),
        epoch=torch.from_numpy(epoch), marked=torch.from_numpy(marked),
    )
    np.testing.assert_array_equal(out_s.numpy(), want_out)
    np.testing.assert_array_equal(changed_s.numpy(), diff & (epoch >= 0) & ~marked)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pattern,n", [("rows", 5), ("rows", 1027), ("unaligned", 1029)])
def test_rewrite_owner(pattern, n, n_shards):
    """``rewrite_owner``: the rewrite and the subject's owner shard, as the
    reference's wrapper of the Pallas kernel (interpret mode) gives them."""
    from repro.kernels.rewrite_triples import rewrite_owner

    spo, rho, *_, start = rewrite_case(pattern, n, seed=n + n_shards)
    spo = spo[start:]
    out, owner = ops.rewrite_owner(torch.from_numpy(spo), torch.from_numpy(rho),
                                   n_shards)
    want_out, want_owner = rewrite_owner(jnp.asarray(spo), jnp.asarray(rho), n_shards)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(owner.numpy(), np.asarray(want_owner))
    assert owner.dtype == torch.int32


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


def _pointer_jump_fixpoint(rep: np.ndarray) -> np.ndarray:
    """rep = rep[rep] to the fixpoint, each step a Pallas call."""
    rep = jnp.asarray(rep)
    while True:
        nxt = jops.pointer_jump(rep, rep)
        if np.array_equal(np.asarray(nxt), np.asarray(rep)):
            return np.asarray(rep)
        rep = nxt


@pytest.mark.parametrize("pattern", UNION_PATTERNS)
def test_uf_union_then_compress(pattern):
    """Union then compress equals merge_pairs_jax and a merge loop of the
    Pallas pointer_jump (the pairs' roots) with a scatter-min hook."""
    rep, pairs, valid = union_case(pattern, 300, seed=len(pattern))
    port = torch.from_numpy(rep.copy())
    ops.uf_union_(port, torch.from_numpy(pairs), torch.from_numpy(valid))
    ops.uf_compress_(port)
    want = juf.merge_pairs_jax(jnp.asarray(rep), jnp.asarray(pairs), jnp.asarray(valid))
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))

    merged = _pointer_jump_fixpoint(rep)
    a, b = jnp.asarray(pairs[valid, 0]), jnp.asarray(pairs[valid, 1])
    while True:
        ra = np.asarray(jops.pointer_jump(a, jnp.asarray(merged)))
        rb = np.asarray(jops.pointer_jump(b, jnp.asarray(merged)))
        lo, hi = np.minimum(ra, rb), np.maximum(ra, rb)
        active = lo != hi
        if not active.any():
            break
        np.minimum.at(merged, hi[active], lo[active])
        merged = _pointer_jump_fixpoint(merged)
    np.testing.assert_array_equal(port.numpy(), merged)
    assert (port.numpy() <= np.arange(rep.shape[0])).all()


SWEEP_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a) -> torch.Tensor:
    """A numpy or jax array as a CPU tensor (bf16 through its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# the reference's sweep (tests/test_kernels.py), plus K = 1 (the FM's
# first-order weights) and one bag of the FM's retrieval query
@pytest.mark.parametrize("b,f,v,k", [(4, 3, 50, 8), (130, 39, 1000, 10),
                                     (64, 26, 513, 16), (300, 39, 777, 1),
                                     (1, 39, 2000, 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_sweep(b, f, v, k, dtype):
    jdt, tdt = SWEEP_DTYPES[dtype]
    rng = np.random.default_rng(b * 7 + f + v + k)
    ids = jnp.asarray(rng.integers(0, v, (b, f)), jnp.int32)
    table = jnp.asarray(rng.normal(size=(v, k)), jdt)
    got = ops.embedding_bag(_to_torch(ids), _to_torch(table))
    assert got.dtype == tdt and got.shape == (b, k)
    rtol = 1e-6 if dtype == "float32" else 5e-2
    for want in (jops.embedding_bag(ids, table), jref.embedding_bag_ref(ids, table)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("k", [1, 10])
def test_embedding_bag_off_table_ids_add_zero(k):
    """Ids below 0 or at or above V add zero, as in the Pallas kernel;
    ``embedding_bag_ref`` would clamp the high ones and wrap the negative
    ones instead (the difference is pinned here)."""
    rng = np.random.default_rng(k)
    v = 6
    table = rng.normal(size=(v, k)).astype(np.float32)
    ids = rng.integers(0, v, (40, 5)).astype(np.int32)
    ids[0] = [0, 6, 1, -1, 2]
    ids[1:, 0] = rng.choice([-7, -1, 6, 100, 1 << 30], 39)
    got = ops.embedding_bag(torch.from_numpy(ids), torch.from_numpy(table)).numpy()
    want = np.asarray(jops.embedding_bag(jnp.asarray(ids), jnp.asarray(table)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], table[[0, 1, 2]].sum(axis=0), rtol=1e-6, atol=1e-6)
    clamped = np.asarray(jref.embedding_bag_ref(jnp.asarray(ids[:1]), jnp.asarray(table)))
    assert not np.allclose(clamped[0], got[0])


def _bag_abs_sum(ids: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Each bag value's sum of |terms|, off-table ids adding nothing."""
    on = (ids >= 0) & (ids < table.shape[0])
    rows = np.abs(table.astype(np.float32))[np.clip(ids, 0, table.shape[0] - 1)]
    return np.where(on[..., None], rows, 0.0).sum(axis=1)


# the FM-serving kernels' tile edges (kernel_patterns): the port's plain
# versions against the Pallas kernels in interpret mode and the reference's
# oracles, within the card tests' limits
@pytest.mark.parametrize("b,f,k", FM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_interact_patterns(b, f, k, dtype):
    jdt, tdt = SWEEP_DTYPES[dtype]
    x = jnp.asarray(fm_case(b, f, k, seed=b + f + k), jdt)
    got = ops.fm_interact(_to_torch(x))
    assert got.dtype == tdt and got.shape == (b,)
    got = got.float().numpy()
    for want in (jops.fm_interact(x), jref.fm_interact_ref(x)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":  # rtol 1e-5 of max(1, the largest |out|)
            limit = 1e-5 * max(1.0, float(np.abs(want).max()))
        else:  # one bf16 rounding
            limit = 2.0**-7 * np.abs(want) + 1e-3
        assert (np.abs(got - want) <= limit).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("b,f,k", BAG_SHAPES)
@pytest.mark.parametrize("pattern", BAG_PATTERNS)
def test_embedding_bag_patterns(b, f, k, pattern):
    """f32, within 1e-5 of each value's sum of |terms|; off-table ids
    against the Pallas kernel only (the oracle clamps them)."""
    ids, table = bag_case(pattern, b, f, 2000, k, seed=b + f + k)
    got = ops.embedding_bag(torch.from_numpy(ids), torch.from_numpy(table)).numpy()
    wants = [jops.embedding_bag(jnp.asarray(ids), jnp.asarray(table))]
    if pattern != "off_table":
        wants.append(jref.embedding_bag_ref(jnp.asarray(ids), jnp.asarray(table)))
    limit = 1e-5 * _bag_abs_sum(ids, table) + 1e-6
    for want in wants:
        assert (np.abs(got - np.asarray(want)) <= limit).all()


@pytest.mark.parametrize("b,f,k", BAG_SHAPES)
def test_embedding_bag_patterns_bf16(b, f, k):
    """bf16 tables, ids banded by field: within 2^-7 of each value's sum
    of |terms| (one bf16 rounding apart)."""
    ids, table = bag_case("banded", b, f, 2000, k, seed=b + f + k)
    jtable = jnp.asarray(table, jnp.bfloat16)
    got = ops.embedding_bag(torch.from_numpy(ids), _to_torch(jtable))
    assert got.dtype == torch.bfloat16
    limit = 2.0**-7 * _bag_abs_sum(ids, np.asarray(jtable, np.float32)) + 1e-6
    for want in (jops.embedding_bag(jnp.asarray(ids), jtable),
                 jref.embedding_bag_ref(jnp.asarray(ids), jtable)):
        assert (np.abs(got.float().numpy() - np.asarray(want, np.float32)) <= limit).all()


# the reference's sweep, plus K = 1 (degree counts) and the GNN widths 70
# and 75, which are no multiple of 32
@pytest.mark.parametrize("n,s,k", [(10, 4, 8), (1000, 100, 16), (513, 700, 4),
                                   (600, 50, 1), (300, 40, 70), (300, 40, 75)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_sweep(n, s, k, dtype):
    jdt, tdt = SWEEP_DTYPES[dtype]
    rng = np.random.default_rng(n + s + k)
    x = jnp.asarray(rng.normal(size=(n, k)), jdt)
    seg = jnp.asarray(rng.integers(0, s, n), jnp.int32)
    got = ops.segment_sum(_to_torch(x), _to_torch(seg), s)
    assert got.dtype == tdt and got.shape == (s, k)
    # the reference's oracle in f32: both kernels accumulate in f32
    expected = jref.segment_sum_ref(x.astype(jnp.float32), seg, s)
    tol = dict(rtol=1e-5, atol=1e-2) if dtype == "float32" else dict(rtol=1e-1, atol=1e-1)
    for want in (jops.segment_sum(x, seg, s), expected):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_segment_sum_drops_out_of_range_segments():
    """Rows whose segment id is below 0 or at or above n are dropped, as
    the Pallas kernel drops them; empty segments are zero."""
    rng = np.random.default_rng(11)
    n, e, k = 9, 200, 5
    x = rng.normal(size=(e, k)).astype(np.float32)
    seg = rng.integers(-3, n + 4, e).astype(np.int32)
    seg[seg == 4] = 5  # segment 4 stays empty
    got = ops.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), n).numpy()
    want = np.asarray(jops.segment_sum(jnp.asarray(x), jnp.asarray(seg), n))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[4] == 0).all()
    keep = (seg >= 0) & (seg < n)
    np.testing.assert_allclose(got.sum(axis=0), x[keep].sum(axis=0), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pattern", SEGMENT_PATTERNS)
@pytest.mark.parametrize("k", [1, 70])
def test_segment_sum_patterns(pattern, k):
    """The segment sum's input patterns (``kernel_patterns.py``: a hub
    segment, even ids, mostly empty segments with ids out of range, one
    segment) at the degree counts' K 1 and GatedGCN's K 70: the plain
    version equals the Pallas kernel and the reference's oracle, both of
    which drop ids out of range, within f32 sums in another order."""
    x, seg = segment_case(pattern, 3000, 200, k, seed=k)
    got = ops.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), 200).numpy()
    abs_sum = np.asarray(jref.segment_sum_ref(jnp.abs(jnp.asarray(x)), jnp.asarray(seg), 200))
    for want in (jops.segment_sum(jnp.asarray(x), jnp.asarray(seg), 200),
                 jref.segment_sum_ref(jnp.asarray(x), jnp.asarray(seg), 200)):
        assert (np.abs(got - np.asarray(want)) <= 1e-5 * abs_sum + 1e-6).all()


@pytest.mark.parametrize("skew", [False, True])
def test_segment_plan_is_a_stable_sort_and_its_offsets(skew):
    """The plan equals ``np.argsort(seg, kind="stable")`` and
    ``np.searchsorted``; with one segment taking a third of the rows the
    sums still equal the reference's."""
    rng = np.random.default_rng(12 + skew)
    n, e = 400, 3000
    seg = rng.integers(-2, n + 2, e).astype(np.int32)
    if skew:
        seg[rng.random(e) < 1 / 3] = 123
    plan = ops.segment_plan(torch.from_numpy(seg), n)
    order = np.argsort(seg, kind="stable")
    np.testing.assert_array_equal(plan.perm.numpy(), order)
    np.testing.assert_array_equal(plan.seg.numpy(), seg[order])
    np.testing.assert_array_equal(plan.offsets.numpy(),
                                  np.searchsorted(seg[order], np.arange(n + 1)))
    assert plan.perm.dtype == plan.seg.dtype == plan.offsets.dtype == torch.int32
    x = rng.normal(size=(e, 7)).astype(np.float32)
    got = ops.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), n, plan=plan)
    want = np.asarray(jops.segment_sum(jnp.asarray(x), jnp.asarray(seg), n))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_cuda_tensors_never_take_the_plain_version():
    """Tensors off the CPU get the kernel or an exception: a meta tensor,
    for which no kernel exists, is refused rather than served by the plain
    version."""
    keys = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ops.dedup_order(keys)
    with pytest.raises(ValueError):
        ops.search_bounds(keys, keys)
    with pytest.raises(ValueError):
        ops.segment_sum(torch.zeros((8, 2), device="meta"),
                        torch.zeros(8, dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError):
        ops.embedding_bag(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                          torch.zeros((5, 2), device="meta"))


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        ops.dedup_order(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.rewrite_triples(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32))
    rep = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):  # pairs of three columns
        ops.uf_union_(rep, torch.zeros((2, 3), dtype=torch.int32),
                      torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):  # flags of another length
        ops.uf_union_(rep, torch.zeros((2, 2), dtype=torch.int32),
                      torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.search_bounds(torch.zeros(8, dtype=torch.int64)[::2],
                          torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.prefix_range_bounds(torch.zeros((4, 4), dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int64))
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):  # integer values
        ops.segment_sum(torch.zeros((4, 2), dtype=torch.int32), seg, 3)
    with pytest.raises(ValueError):  # seg of another length
        ops.segment_sum(torch.zeros((5, 2)), seg, 3)
    with pytest.raises(ValueError):  # a plan of another segment count
        ops.segment_sum(torch.zeros((4, 2)), seg, 3, plan=ops.segment_plan(seg, 2))
    with pytest.raises(TypeError):  # int64 ids
        ops.embedding_bag(torch.zeros((2, 3), dtype=torch.int64), torch.zeros((5, 2)))
    with pytest.raises(ValueError):  # an empty table
        ops.embedding_bag(torch.zeros((2, 3), dtype=torch.int32), torch.zeros((0, 2)))
