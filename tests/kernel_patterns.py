"""Seeded numpy inputs for the search, rewrite, union-find, segment-sum,
FM-interaction and embedding-bag kernels, shared by the CPU tests
(``test_torch_kernels.py``) and the card tests (``test_torch_cuda.py``).

The patterns are the shapes the callers give the kernels, and the edges of
the kernels' tiles: the search kernel answers a tile of sorted queries from
one window of keys in shared memory, or from every s-th key of a window
too large for it; the rewrite takes a row a thread, on any alignment;
the union walks a thread's pair to its roots and hooks them by
compare-and-swap, racing the other threads; the segment sum cuts the sorted rows into equal ranges,
so one segment can cover many of them; the FM interaction streams slabs of
whole rows through shared memory; the embedding bag gives an output value
a thread (at K < 8; a large bag over a large table is swept a group of
fields a launch) or a bag a warp.
"""

from __future__ import annotations

import numpy as np

KEY_MAX = (1 << 63) - 1
MAX_ID = (1 << 21) - 1

SEARCH_PATTERNS = (
    "key_max_tail",      # the membership probe: sorted stream into the arena
    "plateaus",          # compaction: arange into a cumsum with long plateaus
    "all_equal",         # every query one key of a long run of equal keys
    "nearly_sorted",     # sorted but for one swapped pair in each 2,000
    "tile_duplicates",   # sorted, runs of equal queries of 1,500 to 5,000
    "random",            # no order: the store-side join probe
)


def _packed(rng, n: int, n_ids: int) -> np.ndarray:
    spo = rng.integers(0, n_ids, (n, 3)).astype(np.int64)
    return (spo[:, 0] << 42) | (spo[:, 1] << 21) | spo[:, 2]


def search_case(pattern: str, n: int, v: int, seed: int = 0):
    """(queries, keys): n int64 queries and v sorted int64 keys."""
    rng = np.random.default_rng(seed)
    if pattern == "plateaus":  # cumsum of a validity mask with long gaps
        valid = rng.random(v) < 0.5
        for start in rng.integers(0, v, 4):
            valid[start:start + v // 5] = False
        keys = np.cumsum(valid).astype(np.int64)
        return np.arange(1, n + 1, dtype=np.int64), keys
    keys = np.sort(_packed(rng, v, 64))
    keys[-max(v // 8, 1):] = KEY_MAX
    if pattern == "all_equal":
        keys[v // 4: v // 4 + v // 3] = keys[v // 4]
        return np.full(n, keys[v // 4], dtype=np.int64), keys
    hits = keys[rng.integers(0, v, n - n // 2)] if v else _packed(rng, n - n // 2, 64)
    queries = np.concatenate([hits, _packed(rng, n // 2, 64)])
    if pattern == "random":
        return rng.permutation(queries), keys
    queries = np.sort(queries)
    if pattern == "nearly_sorted" and n > 1:
        at = np.arange(1000, n - 1, 2000)
        at = at[queries[at] != queries[at + 1]]
        queries[at], queries[at + 1] = queries[at + 1], queries[at].copy()
    elif pattern == "tile_duplicates":
        runs = rng.integers(1500, 5000, n // 1500 + 1)
        queries = np.repeat(np.sort(queries[rng.integers(0, n, runs.size)]), runs)[:n]
    return queries, keys


def prefix_case(sorted_rows: bool, n: int, v: int, k: int, seed: int = 0):
    """(prefix rows (n, k) int32, keys): rows of the keys' own leading IDs
    (and some that miss), sorted or not, over packed keys with few IDs."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, (v, 3)).astype(np.int64)
    ids[: max(v // 50, 1)] = MAX_ID  # rows at the 21-bit boundary
    keys = np.sort((ids[:, 0] << 42) | (ids[:, 1] << 21) | ids[:, 2])
    rows = ids[rng.integers(0, v, n), :k].astype(np.int32)
    rows[rng.random(n) < 0.2] = rng.integers(0, 14, k)
    if sorted_rows:
        rows = rows[np.lexsort(rows.T[::-1])]
    return np.ascontiguousarray(rows), keys


# (pattern, rows) of the rewrite's inputs: row counts around groups of 4
# rows and tiles of 128 (the edges of a vectorised body), a view that
# starts one row in (12 bytes: no 16-byte chunk is aligned, nor a 4-byte
# word of the masks), and ids outside rho at both ends (clamped into it)
REWRITE_CASES = (
    ("rows", 1), ("rows", 3), ("rows", 4), ("rows", 5), ("rows", 1027),
    ("rows", 127), ("rows", 129), ("rows", 5123),
    ("unaligned", 1029), ("out_of_range", 1000),
)


def rewrite_case(pattern: str, n: int, seed: int = 0):
    """(spo (m, 3) int32, rho (v,) int32, valid (m,) bool, epoch (m,) int32,
    marked (m,) bool, start): the kernel's input is every array from row
    ``start`` on (1 for the unaligned view, which the caller slices after
    moving the arrays to the device), n rows."""
    rng = np.random.default_rng(seed)
    start = 1 if pattern == "unaligned" else 0
    m, v = n + start, max(n // 2, 9)
    rho = np.arange(v, dtype=np.int32) // 4 * 4  # cliques of 4 and their minimum
    moved = rng.integers(0, v, v // 3)
    rho[moved] = rng.integers(0, v, moved.size) // 4 * 4
    rho = np.minimum(rho, np.arange(v, dtype=np.int32))
    spo = rng.integers(0, v, (m, 3))
    if pattern == "out_of_range":
        off = rng.random((m, 3)) < 0.1
        spo[off] = rng.choice([-(1 << 30), -1, v, v + 5, (1 << 31) - 1], int(off.sum()))
    elif pattern not in ("rows", "unaligned"):
        raise ValueError(pattern)
    valid = rng.random(m) < 0.7
    epoch = rng.integers(-1, 4, m).astype(np.int32)
    marked = rng.random(m) < 0.2
    return spo.astype(np.int32), rho, valid, epoch, marked, start


UNION_PATTERNS = (
    "cliques",         # the main path: 8-cliques, all 64 ordered pairs, in a larger buffer
    "cliques_chain",   # 8-cliques hooked pairwise (x, x + 1), plus one long chain
    "permuted_chain",  # one chain through a random permutation of all resources
    "hub",             # one resource in a third of the pairs
    "self_masked",     # a third of the pairs (a, a), half the rows masked out
    "forest",          # random pairs into an uncompressed forest, rep[x] <= x
)


def union_case(pattern: str, v: int, seed: int = 0):
    """(rep (v,) int32, pairs (m, 2) int32, valid (m,) bool) for v
    resources: a forest with rep[x] <= x and the pairs to merge into it."""
    rng = np.random.default_rng(seed)
    rep = np.arange(v, dtype=np.int32)
    if pattern == "cliques":
        g = rng.permutation(v // 8)[: max(v // 16, 1)] * 8
        i, j = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
        pairs = np.stack([(g[:, None, None] + i).reshape(-1),
                          (g[:, None, None] + j).reshape(-1)], axis=1)
        pairs = rng.permutation(pairs)
        pad = rng.integers(0, v, (pairs.shape[0] // 4 + 3, 2))  # masked-out rows
        valid = np.arange(pairs.shape[0] + pad.shape[0]) < pairs.shape[0]
        return rep, np.concatenate([pairs, pad]).astype(np.int32), valid
    if pattern == "cliques_chain":
        x = np.arange(v - 1)
        long_chain = (x >= v // 4) & (x < v // 4 + v // 3)
        x = x[(x % 8 != 7) | long_chain]
        pairs = rng.permutation(np.stack([x, x + 1], axis=1))
    elif pattern == "permuted_chain":
        perm = rng.permutation(v)
        pairs = np.stack([perm[:-1], perm[1:]], axis=1)
        pairs = rng.permutation(pairs)
    elif pattern == "hub":
        pairs = rng.integers(0, v, (v // 2, 2))
        rows = np.flatnonzero(rng.random(pairs.shape[0]) < 0.33)
        pairs[rows, rng.integers(0, 2, rows.size)] = v // 2 + 1
    elif pattern == "self_masked":
        pairs = rng.integers(0, v, (v, 2))
        self_rows = rng.random(v) < 0.33
        pairs[self_rows, 1] = pairs[self_rows, 0]
        return rep, pairs.astype(np.int32), rng.random(v) < 0.5
    elif pattern == "forest":
        hooked = rng.random(v) < 0.6
        hooked[0] = False
        rep[hooked] = rng.integers(0, np.flatnonzero(hooked))
        chain = np.arange(v // 2, min(v, v // 2 + 40))  # a deep chain
        rep[chain] = chain - 1
        pairs = rng.integers(0, v, (v // 3, 2))
    else:
        raise ValueError(pattern)
    return rep, pairs.astype(np.int32), np.ones(pairs.shape[0], dtype=bool)


SEGMENT_PATTERNS = (
    "hub",          # one segment holds 40 % of the rows, as the KG's hub
    "uniform",      # ids spread evenly
    "sparse",       # most segments empty, ids out of range at both ends
    "one_segment",  # every row in one segment
)


def segment_case(pattern: str, e: int, n: int, k: int, seed: int = 0):
    """(x (e, k) float32, seg (e,) int32) for n segments."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, k)).astype(np.float32)
    if pattern == "hub":
        seg = rng.integers(0, n, e)
        seg[rng.random(e) < 0.4] = n // 3
        seg[rng.random(e) < 0.02] = -1
    elif pattern == "uniform":
        seg = rng.integers(0, n, e)
    elif pattern == "sparse":
        seg = rng.choice(rng.integers(0, n, max(n // 50, 1)), e)
        seg[rng.random(e) < 0.05] = rng.choice([-5, -1, n, n + 3])
    elif pattern == "one_segment":
        seg = np.full(e, n // 2)
    else:
        raise ValueError(pattern)
    return x, seg.astype(np.int32)


# (b, f, k) of the FM interaction's inputs: the slab route's edges (one row,
# batches that are no multiple of a slab, 1 to 100 fields, a row of odd
# byte length, a row larger than a stage) and the row route's K > 32
FM_SHAPES = (
    (1, 39, 10),      # one row: a slab of one row
    (23, 39, 10),     # fewer rows than a slab at the bulk shape
    (513, 39, 10),    # serve_p99 plus one
    (300, 1, 10),
    (300, 7, 10),
    (300, 100, 10),
    (777, 7, 3),      # rows of 21 values: 84 bytes in f32, 42 in bf16
    (200, 39, 33),    # K > 32: the row route
    (50, 1200, 10),   # 48,000 bytes a row in f32: larger than a stage
)


def fm_case(b: int, f: int, k: int, seed: int = 0) -> np.ndarray:
    """(b, f, k) float32 field embeddings."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, f, k)) * 0.5).astype(np.float32)


BAG_PATTERNS = (
    "banded",     # field f's ids in its own band of rows, as the FM lays them out
    "uniform",    # ids over the whole table
    "off_table",  # a tenth of the ids below 0 or at or past V: they add zero
)

# (b, f, k) of the embedding bag's inputs: the narrow route's edges (one
# bag, one past or short of a block of 256 threads, 1 to 500 fields, a
# field count no multiple of the 8 loaded at once, K 3) and the wide
# route's (the retrieval query, K > 32)
BAG_SHAPES = (
    (1, 39, 1),
    (255, 39, 1),
    (257, 39, 1),
    (300, 1, 1),
    (300, 7, 1),
    (300, 100, 1),
    (64, 500, 1),
    (300, 39, 3),
    (1, 39, 10),     # the retrieval query
    (100, 39, 40),   # K > 32
    (64, 7, 130),
)


def bag_case(pattern: str, b: int, f: int, v: int, k: int, seed: int = 0):
    """(ids (b, f) int32, table (v, k) float32)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, k)).astype(np.float32)
    if pattern == "banded":
        band = max(v // f, 1)
        ids = rng.integers(0, band, (b, f)) + np.arange(f) * band
        ids = np.minimum(ids, v - 1)
    elif pattern in ("uniform", "off_table"):
        ids = rng.integers(0, v, (b, f))
        if pattern == "off_table":
            off = rng.random((b, f)) < 0.1
            ids[off] = rng.choice([-(1 << 30), -1, v, v + 7], int(off.sum()))
    else:
        raise ValueError(pattern)
    return ids.astype(np.int32), table
