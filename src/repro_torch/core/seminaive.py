"""Batched semi-naive rule evaluation on the host (numpy).

The paper uses a fact-at-a-time semi-naive algorithm whose ``T^{<F}/T^{<=F}``
annotated queries guarantee each (rule, substitution) pair is considered at
most once (Claim 7).  The batched equivalent used here is the standard
round-stratified discipline: for a rule with body atoms B1..Bn, round r
evaluates n *delta plans*; plan i matches

    atoms j < i  against T_old      (facts from earlier rounds),
    atom  i      against Delta      (facts added last round),
    atoms j > i  against T_old u Delta,

which assigns every new substitution to exactly one (round, plan) — the bulk
analogue of the paper's annotation trick.

Joins are sort-merge: pack the bound positions of an atom into int64 keys,
sort the candidate triples once, ``searchsorted`` the binding rows, and expand
match ranges with the cumsum trick.  This is the SIMD-friendly replacement for
RDFox's hash indexes and is the same algorithm the device engine uses with
static capacities (:mod:`repro_torch.core.engine`).

A copy of ``repro.core.seminaive``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .rules import Rule
from .terms import is_var


@dataclass
class Bindings:
    """Columnar substitution table: var id -> value column."""

    cols: dict[int, np.ndarray]
    nrows: int

    @staticmethod
    def empty_universe() -> "Bindings":
        """A single empty substitution (the unit of the join)."""
        return Bindings({}, 1)

    def select(self, idx: np.ndarray) -> "Bindings":
        return Bindings({v: c[idx] for v, c in self.cols.items()}, idx.shape[0])


def _pack_cols(cols: list[np.ndarray]) -> np.ndarray:
    """Pack up to 3 int32 columns into one int64 key."""
    key = np.zeros(cols[0].shape[0], dtype=np.int64)
    for c in cols:
        key = (key << 21) | c.astype(np.int64)
    return key


def _const_filter(atom, triples: np.ndarray) -> np.ndarray:
    """Rows of ``triples`` compatible with the atom's constants and
    intra-atom repeated variables."""
    mask = np.ones(triples.shape[0], dtype=bool)
    seen: dict[int, int] = {}
    for pos, t in enumerate(atom):
        if not is_var(t):
            mask &= triples[:, pos] == t
        else:
            if t in seen:
                mask &= triples[:, pos] == triples[:, seen[t]]
            else:
                seen[t] = pos
    return mask


def join_atom(
    bindings: Bindings, atom, triples: np.ndarray
) -> tuple[Bindings, int]:
    """Extend ``bindings`` with matches of ``atom`` against ``triples``.

    Returns (new bindings, number of candidate triples matched by the atom's
    constant pattern) — the latter feeds the 'rule applications' counter when
    the atom is the delta atom.
    """
    mask = _const_filter(atom, triples)
    cand = triples[mask]
    n_cand = cand.shape[0]

    # variable positions (first occurrence only)
    var_pos: dict[int, int] = {}
    for pos, t in enumerate(atom):
        if is_var(t) and t not in var_pos:
            var_pos[t] = pos

    bound = [v for v in var_pos if v in bindings.cols]
    free = [v for v in var_pos if v not in bindings.cols]

    if bindings.nrows == 0 or n_cand == 0:
        cols = {v: np.zeros(0, dtype=np.int32) for v in bindings.cols}
        for v in free:
            cols[v] = np.zeros(0, dtype=np.int32)
        return Bindings(cols, 0), n_cand

    if not bound:
        # cartesian product
        nb, nc = bindings.nrows, n_cand
        row_ids = np.repeat(np.arange(nb), nc)
        cand_ids = np.tile(np.arange(nc), nb)
    else:
        ck = _pack_cols([cand[:, var_pos[v]] for v in bound])
        order = np.argsort(ck, kind="stable")
        ck_sorted = ck[order]
        bk = _pack_cols([bindings.cols[v] for v in bound])
        lo = np.searchsorted(ck_sorted, bk, side="left")
        hi = np.searchsorted(ck_sorted, bk, side="right")
        counts = hi - lo
        total = int(counts.sum())
        row_ids = np.repeat(np.arange(bindings.nrows), counts)
        if total:
            cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(total) - np.repeat(cum, counts)
            cand_ids = order[lo[row_ids] + within]
        else:
            cand_ids = np.zeros(0, dtype=np.int64)

    out = bindings.select(row_ids)
    for v in free:
        out.cols[v] = cand[cand_ids, var_pos[v]].astype(np.int32)
    return out, n_cand


def instantiate_head(head, bindings: Bindings) -> np.ndarray:
    cols = []
    for t in head:
        if is_var(t):
            cols.append(bindings.cols[t])
        else:
            cols.append(np.full(bindings.nrows, t, dtype=np.int32))
    if bindings.nrows == 0:
        return np.zeros((0, 3), dtype=np.int32)
    return np.stack(cols, axis=1)


def eval_rule_delta(
    rule: Rule,
    t_old: np.ndarray,
    t_all: np.ndarray,
    delta: np.ndarray,
) -> tuple[np.ndarray, int, int]:
    """All delta plans of one rule for one round.

    Returns (derived head facts (m,3) with duplicates, n_derivations,
    n_rule_applications).
    """
    heads: list[np.ndarray] = []
    n_deriv = 0
    n_appl = 0
    body = rule.body
    for i in range(len(body)):
        # delta-first join order: plans whose delta atom matches nothing die
        # for free, and surviving plans keep intermediates proportional to
        # the (small) delta instead of to the store — the incremental win
        if delta.shape[0] == 0 or not _const_filter(body[i], delta).any():
            continue
        b = Bindings.empty_universe()
        dead = False
        for j in [i, *(j for j in range(len(body)) if j != i)]:
            if j < i:
                src = t_old
            elif j == i:
                src = delta
            else:
                src = t_all
            b, n_cand = join_atom(b, body[j], src)
            if j == i:
                n_appl += n_cand
            if b.nrows == 0:
                dead = True
                break
        if dead:
            continue
        h = instantiate_head(rule.head, b)
        n_deriv += h.shape[0]
        heads.append(h)
    if heads:
        out = np.concatenate(heads, axis=0)
    else:
        out = np.zeros((0, 3), dtype=np.int32)
    return out, n_deriv, n_appl


def eval_rule_full(rule: Rule, t_all: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Full evaluation of a rule against the current store (the R-queue step:
    a rewritten rule must be re-applied to all facts, paper Algorithm 2)."""
    empty = np.zeros((0, 3), dtype=np.int32)
    return eval_rule_delta(rule, empty, t_all, t_all)
