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
* ``FrozenRho`` — a copy of the reference's frozen rho view with its
  clique expansion tables and incremental refresh (the serving tier's
  epoch snapshots hold one),
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


class FrozenRho:
    """Immutable, fully-compressed view of rho with cached clique structure.

    The SPARQL executor needs ``compress_np`` plus the clique expansion
    tables (``clique_members`` / ``clique_sizes``) for every answer; a
    standing service evaluates many queries against the *same* maintenance
    epoch's rho, so the epoch snapshot freezes the compression once and the
    expansion tables are built lazily and shared across all of the epoch's
    queries.  The underlying array is marked read-only so the view can be
    handed to concurrent readers without defensive copies.
    """

    __slots__ = ("rep", "_members", "_sizes", "_order", "_sorted_rep")

    def __init__(self, rep: np.ndarray) -> None:
        rep = compress_np(np.asarray(rep))
        rep.setflags(write=False)
        self.rep = rep
        self._members: dict[int, np.ndarray] | None = None
        self._sizes: np.ndarray | None = None
        self._order: np.ndarray | None = None
        self._sorted_rep: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.rep.shape[0])

    @property
    def members(self) -> dict[int, np.ndarray]:
        if self._members is None:
            # rep is compressed by construction: skip the redundant sweep
            self._members = _members_compressed(self.rep)
        return self._members

    @property
    def sizes(self) -> np.ndarray:
        if self._sizes is None:
            self._sizes = _sizes_compressed(self.rep)
        return self._sizes

    def normalise(self, ids: np.ndarray) -> np.ndarray:
        """rho-normal form of an int index array (e.g. an (n, 3) batch)."""
        return self.rep[ids]

    def _csr(self) -> tuple[np.ndarray, np.ndarray]:
        # resources grouped by representative: members of rep r are the
        # contiguous run order[searchsorted(sorted_rep, r, left:right)]
        if self._order is None:
            self._order = np.argsort(self.rep, kind="stable")
            self._sorted_rep = self.rep[self._order]
        return self._order, self._sorted_rep

    def expand_ids(self, col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorised clique expansion of a resource-id column.

        Returns ``(row_idx, vals)``: each input row ``i`` contributes one
        output row per member of ``col[i]``'s clique (``row_idx`` repeats
        ``i``, ``vals`` holds the member ids).  An id that is nobody's
        representative — including ids unseen by this rho — expands to
        itself, matching the ``members.get(x, [x])`` singleton convention.
        One searchsorted + gather pass instead of a Python loop over rows:
        the executor's per-answer expansion cost for serving-size bags.
        """
        col = np.asarray(col)
        if col.shape[0] <= 64 and self._members is not None:
            # point-lookup answers: a handful of rows, members table already
            # built (serving pre-warms it at publish) — a direct dict probe
            # per row undercuts the fixed cost of the vectorised pass
            ridx: list[int] = []
            vlist: list[np.ndarray] = []
            for i, x in enumerate(col.tolist()):
                mem = self._members.get(x)
                if mem is None:
                    ridx.append(i)
                    vlist.append(np.asarray([x]))
                else:
                    ridx.extend([i] * mem.shape[0])
                    vlist.append(mem)
            vals = (np.concatenate(vlist) if vlist
                    else np.zeros(0, col.dtype))
            return (np.asarray(ridx, dtype=np.int64),
                    vals.astype(col.dtype, copy=False))
        order, srep = self._csr()
        starts = np.searchsorted(srep, col, side="left")
        counts = np.searchsorted(srep, col, side="right") - starts
        lone = counts == 0
        counts = np.where(lone, 1, counts)
        row_idx = np.repeat(np.arange(col.shape[0]), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(row_idx.shape[0]) - offs[row_idx]
        gathered = order[
            np.minimum(starts[row_idx] + within, order.shape[0] - 1)
        ] if order.shape[0] else np.zeros(row_idx.shape[0], col.dtype)
        vals = np.where(lone[row_idx], col[row_idx], gathered)
        return row_idx, vals.astype(col.dtype, copy=False)

    def refreshed(self, rep: np.ndarray) -> "FrozenRho":
        """An epoch-over-epoch *incremental* refresh of the frozen view.

        Serving publishes one FrozenRho per maintenance epoch, and most
        epochs touch few (often zero) cliques, so rebuilding the clique
        expansion tables from scratch — an argsort over every resource —
        charges every epoch for work proportional to the whole resource
        space.  ``refreshed`` compares ``rep`` against this view and:

          * returns ``self`` when nothing changed (the common plain-add
            epoch) — the cached ``members``/``sizes`` carry over for free;
          * otherwise builds the successor view, recomputing members only
            for the *affected* cliques (any clique that gained or lost a
            member has some resource whose representative changed, so the
            affected set is exactly the old+new representatives of the
            changed resources, plus everything in a freshly interned tail);
            untouched cliques keep their cached member arrays by reference.

        ``sizes`` is always a fresh O(n) bincount — it is cheap and keeps
        the invariant trivial.  Falls back to a plain rebuild when this
        view's member table was never materialised (nothing to reuse).
        """
        rep = compress_np(np.asarray(rep))
        n_old, n_new = self.rep.shape[0], rep.shape[0]
        if n_new == n_old and np.array_equal(rep, self.rep):
            return self
        if self._members is None:
            return FrozenRho(rep)
        n = min(n_old, n_new)
        changed = np.flatnonzero(rep[:n] != self.rep[:n])
        affected = np.union1d(self.rep[changed], rep[changed])
        if n_new > n:  # freshly interned resources and their merge targets
            tail = np.arange(n, n_new)
            affected = np.union1d(affected, np.union1d(tail, rep[tail]))
        out = FrozenRho.__new__(FrozenRho)
        rep.setflags(write=False)
        out.rep = rep
        out._sizes = None
        out._order = None
        out._sorted_rep = None
        # the reference builds this set once per kept clique: at OpenCyc
        # scale (51,600 cliques, thousands affected by a delete) seconds
        gone = set(affected.tolist())
        members = {r: m for r, m in self._members.items() if r not in gone}
        if affected.shape[0]:
            sub = np.flatnonzero(np.isin(rep, affected.astype(rep.dtype)))
            sr = rep[sub]
            order = np.argsort(sr, kind="stable")
            sub, sr = sub[order], sr[order]
            bounds = np.flatnonzero(np.diff(sr)) + 1
            for seg in np.split(sub, bounds):
                if seg.shape[0] > 1:
                    members[int(rep[seg[0]])] = np.sort(seg)
        out._members = members
        return out


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
