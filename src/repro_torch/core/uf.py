"""Representative map rho as a union-find.

The port of ``repro.core.uf``'s merge machinery.  All sameAs pairs of a
round are applied at once.  The reference alternates min-hooking
(``rep[hi] = min(rep[hi], lo)`` for pairs whose roots differ) with
compression until no pair straddles two roots; on the card one lock-free
union joins them all (each pair hooks the larger of its two roots under the
smaller by compare-and-swap, the paper's Algorithm 5) and one compression
finishes.  The representative of a clique is its minimum ID, so the result
is unique whatever the order of hooks.

* ``compress_np`` / ``merge_pairs_np`` — numpy copies of the reference's
  host versions,
* ``clique_sizes`` / ``clique_members`` / ``split_cliques`` — numpy copies
  of the reference's host clique utilities (the Theorem 1 oracle expands
  cliques with them; the incremental delete path splits suspect cliques),
* ``compress`` / ``merge_pairs`` — the torch counterparts of
  ``_compress_jax`` / ``merge_pairs_jax``; on the card, union and
  compression run as the union-find kernels (:func:`repro_torch.kernels.ops.uf_union_`,
  :func:`repro_torch.kernels.ops.uf_compress_`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def compress_np(rep: np.ndarray) -> np.ndarray:
    """Full path compression by pointer doubling (O(log depth) sweeps)."""
    rep = rep.copy()
    while True:
        nxt = rep[rep]
        if np.array_equal(nxt, rep):
            return rep
        rep = nxt


def merge_pairs_np(rep: np.ndarray, pairs: np.ndarray) -> tuple[np.ndarray, int]:
    """Merge (a, b) rows of ``pairs`` into ``rep``; returns (rep', n_merged)."""
    if pairs.size == 0:
        return rep, 0
    rep = compress_np(rep)
    before_roots = int((rep == np.arange(rep.shape[0])).sum())
    a = rep[pairs[:, 0]]
    b = rep[pairs[:, 1]]
    while True:
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        active = lo != hi
        if not active.any():
            break
        np.minimum.at(rep, hi[active], lo[active])
        rep = compress_np(rep)
        a = rep[a]
        b = rep[b]
    after_roots = int((rep == np.arange(rep.shape[0])).sum())
    return rep, before_roots - after_roots


def _sizes_compressed(rep: np.ndarray) -> np.ndarray:
    return np.bincount(rep, minlength=rep.shape[0])


def clique_sizes(rep: np.ndarray) -> np.ndarray:
    """sizes[r] = |clique represented by r| (1 for singletons, 0 for non-roots)."""
    return _sizes_compressed(compress_np(np.asarray(rep)))


def split_cliques(rep: np.ndarray, suspect_reps: np.ndarray) -> np.ndarray:
    """Reset every member of the suspect cliques to a singleton.

    The inverse of min-hooking: members (the representative included)
    become their own roots, and the delete path's forward pass re-merges
    whatever equalities the surviving facts still support.
    """
    if suspect_reps.shape[0] == 0:
        return rep
    rep = rep.copy()
    members = clique_members(rep)
    for r in suspect_reps:
        mem = members.get(int(r))
        if mem is not None:
            rep[mem] = mem.astype(rep.dtype)
    return compress_np(rep)


def _members_compressed(rep: np.ndarray) -> dict[int, np.ndarray]:
    order = np.argsort(rep, kind="stable")
    sorted_rep = rep[order]
    out: dict[int, np.ndarray] = {}
    boundaries = np.flatnonzero(np.diff(sorted_rep)) + 1
    for seg in np.split(order, boundaries):
        if seg.shape[0] > 1:
            out[int(rep[seg[0]])] = np.sort(seg)
    return out


def clique_members(rep: np.ndarray) -> dict[int, np.ndarray]:
    """representative -> member array, only for cliques of size > 1."""
    return _members_compressed(compress_np(np.asarray(rep)))


def compress(rep: torch.Tensor) -> torch.Tensor:
    """Fully compressed copy of the int32 forest ``rep``."""
    out = rep.clone()
    ops.uf_compress_(out)
    return out


def merge_pairs(rep: torch.Tensor, pairs: torch.Tensor,
                pair_valid: torch.Tensor) -> torch.Tensor:
    """Merge the valid (a, b) rows of the (m, 2) int32 ``pairs`` into a copy
    of the forest ``rep`` (``rep[x] <= x``, as merging leaves it); returns
    the compressed result.  One union and one compression: no host read."""
    out = rep.clone()
    ops.uf_union_(out, pairs, pair_valid)
    ops.uf_compress_(out)
    return out
