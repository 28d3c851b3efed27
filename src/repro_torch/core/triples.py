"""Host-side triples: int64 sort keys and the append-only numpy arena.

The port's copy of the numpy half of ``repro.core.triples``: 21 bits per
position, subject in the high bits, so packed keys sort lexicographically;
and :class:`TripleArena`, the store of the host REW and AX materialisations
(:mod:`repro_torch.core.materialise`).  The paper never deletes facts — it
*marks* them outdated and skips them during matching (§4); the arena mirrors
that: rows are append-only and ``valid`` flips to False when a fact is
rewritten.
"""

from __future__ import annotations

import numpy as np

_SHIFT_S = 42
_SHIFT_P = 21


def pack(spo: np.ndarray) -> np.ndarray:
    """(n,3) int -> (n,) int64 lexicographic sort key."""
    s = spo[:, 0].astype(np.int64)
    p = spo[:, 1].astype(np.int64)
    o = spo[:, 2].astype(np.int64)
    return (s << _SHIFT_S) | (p << _SHIFT_P) | o


def unpack(keys: np.ndarray) -> np.ndarray:
    mask = (1 << 21) - 1
    s = (keys >> _SHIFT_S) & mask
    p = (keys >> _SHIFT_P) & mask
    o = keys & mask
    return np.stack([s, p, o], axis=1).astype(np.int32)


def dedup_rows(spo: np.ndarray) -> np.ndarray:
    """Distinct triples of an (n, 3) batch, first occurrence order kept."""
    spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
    if spo.shape[0] == 0:
        return spo
    _, idx = np.unique(pack(spo), return_index=True)
    return spo[np.sort(idx)]


def setdiff_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of ``a`` whose packed key is not in ``b`` (both (n, 3))."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a
    return a[~np.isin(pack(a), pack(b))]


def apply_op(explicit: np.ndarray, op: str, delta: np.ndarray) -> np.ndarray:
    """Apply an ``("add" | "delete", delta)`` event to an explicit fact set:
    the sorted distinct explicit set a from-scratch run would start from."""
    explicit = np.asarray(explicit, np.int32).reshape(-1, 3)
    delta = np.asarray(delta, np.int32).reshape(-1, 3)
    cur = set(pack(explicit).tolist())
    d = set(pack(delta).tolist())
    cur = (cur | d) if op == "add" else (cur - d)
    keys = np.asarray(sorted(cur), dtype=np.int64)
    return unpack(keys) if keys.shape[0] else np.zeros((0, 3), np.int32)


class TripleArena:
    """Append-only store with outdated-marking, mirroring T in the paper."""

    def __init__(self, capacity: int = 1024) -> None:
        self.spo = np.zeros((capacity, 3), dtype=np.int32)
        self.valid = np.zeros(capacity, dtype=bool)
        self.n = 0
        # membership set over *valid* rows: sorted packed keys + row perm
        self._keys: np.ndarray | None = None
        self._rows: np.ndarray | None = None

    # -- capacity ----------------------------------------------------------
    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        cap = self.spo.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        spo = np.zeros((cap, 3), dtype=np.int32)
        spo[: self.n] = self.spo[: self.n]
        valid = np.zeros(cap, dtype=bool)
        valid[: self.n] = self.valid[: self.n]
        self.spo, self.valid = spo, valid

    # -- index -------------------------------------------------------------
    def _rebuild_index(self) -> None:
        rows = np.flatnonzero(self.valid[: self.n])
        keys = pack(self.spo[rows])
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._rows = rows[order]

    def index(self) -> tuple[np.ndarray, np.ndarray]:
        if self._keys is None:
            self._rebuild_index()
        return self._keys, self._rows  # type: ignore[return-value]

    # -- core ops ----------------------------------------------------------
    def contains(self, spo: np.ndarray) -> np.ndarray:
        """Boolean membership of candidate triples among *valid* rows."""
        keys, _ = self.index()
        cand = pack(np.asarray(spo, dtype=np.int32).reshape(-1, 3))
        if keys.shape[0] == 0:
            return np.zeros(cand.shape[0], dtype=bool)
        pos = np.clip(np.searchsorted(keys, cand), 0, keys.shape[0] - 1)
        return keys[pos] == cand

    def add_batch(self, spo: np.ndarray) -> np.ndarray:
        """T.add for a batch: dedup within the batch and against valid rows.

        Returns the (m,3) array of facts actually added (the new Delta).  The
        membership index is kept up to date by merging the new keys in.
        """
        spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
        if spo.shape[0] == 0:
            return spo
        _, first = np.unique(pack(spo), return_index=True)
        cand = spo[np.sort(first)]
        fresh = cand[~self.contains(cand)]
        if fresh.shape[0] == 0:
            return fresh
        self._ensure(fresh.shape[0])
        rows = np.arange(self.n, self.n + fresh.shape[0])
        self.spo[rows] = fresh
        self.valid[rows] = True
        self.n += fresh.shape[0]
        if self._keys is not None:
            fk = pack(fresh)
            order = np.argsort(fk, kind="stable")
            pos = np.searchsorted(self._keys, fk[order])
            self._keys = np.insert(self._keys, pos, fk[order])
            self._rows = np.insert(self._rows, pos, rows[order])
        return fresh

    def mark_rows(self, rows: np.ndarray) -> None:
        """T.mark: flip validity (facts stay in the arena, as in the paper)."""
        rows = np.asarray(rows).reshape(-1)
        if rows.shape[0] and self._keys is not None:
            live = rows[self.valid[rows]]
            if live.shape[0]:
                keys = np.sort(pack(self.spo[live]))
                pos = np.searchsorted(self._keys, keys)
                self._keys = np.delete(self._keys, pos)
                self._rows = np.delete(self._rows, pos)
        self.valid[rows] = False

    def rows_of(self, facts: np.ndarray) -> np.ndarray:
        """Arena row indices of *valid* rows whose triple is in ``facts``."""
        if facts.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        keys, rows = self.index()
        if keys.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        cand = np.unique(pack(facts))
        pos = np.clip(np.searchsorted(keys, cand), 0, keys.shape[0] - 1)
        hit = keys[pos] == cand
        return rows[pos[hit]]

    def valid_triples(self) -> np.ndarray:
        return self.spo[: self.n][self.valid[: self.n]]

    def rewrite_sweep(self, rep: np.ndarray) -> np.ndarray:
        """Bulk analogue of Algorithm 3: mark outdated rows, return rewrites.

        A row is outdated iff any position changes under rho.  Returns the
        rewritten versions (not yet inserted; the caller routes them through
        ``add_batch`` so re-derivations dedup correctly).
        """
        live = self.spo[: self.n]
        rewritten = rep[live]
        changed = (rewritten != live).any(axis=1) & self.valid[: self.n]
        rows = np.flatnonzero(changed)
        if rows.shape[0] == 0:
            return np.zeros((0, 3), dtype=np.int32)
        self.mark_rows(rows)
        return rewritten[rows].astype(np.int32)

    # -- stats -------------------------------------------------------------
    @property
    def total(self) -> int:
        return self.n

    @property
    def unmarked(self) -> int:
        return int(self.valid[: self.n].sum())

    @property
    def nbytes(self) -> int:
        return self.spo.nbytes + self.valid.nbytes
