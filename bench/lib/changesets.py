"""The change sets of the update traffic, frozen here with the benchmark.

A pool of ``pool`` distinct pairs ``(A_i, B_i)`` is drawn from the seed,
each of ``rows`` explicit rows:

* ``A_i`` is new to the base.  A share ``merge_share`` of its rows are
  fresh ``:idProp`` pairs, ``(a, :idProp, v)`` and ``(b, :idProp, v)`` for
  two existing subjects and a value no base fact names, which merges the
  cliques of ``a`` and ``b`` (the repository's update sampler's
  ``p_merge_add``); the rest copy the predicate and object of a random
  base row to a random existing subject.  The fresh values are the ids
  right after the base's, the same in every ``A_i``.
* ``B_i`` is ``rows`` distinct rows of the base.

A cycle applies add ``A_i``, delete ``A_i``, delete ``B_i``, add ``B_i``,
so the explicit set is the base again after every cycle: :func:`events`
lists the cycle of pool entry ``i`` and :func:`expected_explicit` what the
explicit set is after each of its events.
"""

from __future__ import annotations

import numpy as np

from .kg import KG
from .keys import member, pack, unpack

def draw_pool(kg: KG, seed: int, rows: int, pool: int, merge_share: float):
    """``(base_keys, [(A_i, B_i), ...], n_fresh)``: the base's distinct
    packed keys, the pool, and the fresh value ids each ``A_i`` uses."""
    rng = np.random.default_rng([seed, 0xC4A5E])
    base = np.unique(pack(kg.facts))
    base_rows = unpack(base)
    subjects = np.unique(base_rows[:, 0])
    n_pairs = int(round(merge_share * rows / 2))
    n_copy = rows - 2 * n_pairs
    if base.shape[0] < rows or subjects.shape[0] < 2:
        raise ValueError(f"a base of {base.shape[0]} rows cannot give change sets of {rows}")
    fresh = np.arange(kg.n_resources, kg.n_resources + n_pairs, dtype=np.int32)
    out = []
    for _ in range(pool):
        a, b = rng.integers(subjects.shape[0], size=(2, n_pairs))
        b = np.where(a == b, (b + 1) % subjects.shape[0], b)
        pairs = np.concatenate([
            np.stack([subjects[a], np.full(n_pairs, kg.id_prop), fresh], axis=1),
            np.stack([subjects[b], np.full(n_pairs, kg.id_prop), fresh], axis=1)])
        copies = np.zeros((0,), np.int64)
        while copies.shape[0] < n_copy:  # new rows only: none of the base's
            m = 2 * (n_copy - copies.shape[0]) + 64
            src = base_rows[rng.integers(base_rows.shape[0], size=m)]
            src[:, 0] = subjects[rng.integers(subjects.shape[0], size=m)]
            k = pack(src)
            k = k[~member(base, k)]
            _, first = np.unique(k, return_index=True)
            k = k[np.sort(first)]
            copies = np.concatenate([copies, k[~np.isin(k, copies)]])
        add = np.concatenate([pairs, unpack(copies[:n_copy])]).astype(np.int32)
        delete = base_rows[rng.choice(base_rows.shape[0], size=rows, replace=False)]
        out.append((add, delete))
    return base, out, n_pairs


def events(pool: list, i: int) -> list:
    """The four events of pool entry ``i``'s cycle: ``(kind, op, rows)``."""
    add, delete = pool[i]
    return [("add_a", "add", add), ("delete_a", "delete", add),
            ("delete_b", "delete", delete), ("add_b", "add", delete)]


def expected_count(base: np.ndarray, pool: list, kind: str) -> int:
    """The size of the explicit set after event ``kind`` (A_i is new to
    the base and B_i within it, each of distinct rows)."""
    rows = pool[0][0].shape[0]
    return base.shape[0] + {"add_a": rows, "delete_b": -rows}.get(kind, 0)


def expected_explicit(base: np.ndarray, pool: list, i: int, kind: str) -> np.ndarray:
    """The explicit set (sorted distinct keys) after event ``kind`` of
    entry ``i``'s cycle."""
    add, delete = pool[i]
    if kind == "add_a":
        a = np.sort(pack(add))
        return np.insert(base, np.searchsorted(base, a), a)
    if kind == "delete_b":
        return np.delete(base, np.searchsorted(base, pack(delete)))
    if kind in ("delete_a", "add_b"):
        return base
    raise ValueError(f"unknown event kind {kind!r}")
