"""Seeded numpy inputs for the search and segment-sum kernels, shared by the
CPU tests (``test_torch_kernels.py``) and the card tests
(``test_torch_cuda.py``).

The patterns are the shapes the callers give the kernels, and the edges of
the kernels' tiles: the search kernel answers a tile of sorted queries from
one window of keys in shared memory, or from every s-th key of a window
too large for it; the segment sum cuts the sorted rows into equal ranges,
so one segment can cover many of them.
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
