"""SPARQL evaluation over (T, rho) with correct bag semantics (paper §5).

``evaluate`` implements the paper's strategy:
  1. normalise the query: rho(Q) (constants -> representatives),
  2. match the BGP against the succinct store T (small joins — the win),
  3. run FILTER/BIND steps, expanding their argument variables *first* and
     flagging them so they are not multiplied again later,
  4. project: every projected-out, still-unexpanded variable multiplies the
     answer multiplicity by its owl:sameAs-clique size,
  5. expand the retained, still-unexpanded variables into clique members.

``evaluate_naive`` is the strawman the paper §5 shows to be wrong (match
rho(Q), project, then post-hoc expansion of the answer set): it loses
multiplicities and produces wrong builtin results.  Kept for the tests and
benchmarks that reproduce the paper's argument.

Both evaluators accept either a raw representative array or a pre-frozen
:class:`repro_torch.core.uf.FrozenRho` — serving hands the latter so the clique
expansion tables are computed once per maintenance epoch, not per query.
``evaluate_at`` answers against an epoch snapshot handle
(:class:`repro_torch.core.engine.StoreSnapshot`) instead of reading a live
arena, returning the epoch alongside the bag so callers can attribute every
answer to the completed fixpoint it was computed at.

A copy of ``repro.sparql.executor``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from repro_torch.core.seminaive import Bindings, join_atom
from repro_torch.core.terms import is_var
from repro_torch.core.uf import FrozenRho

from .algebra import Bind, FilterEq, Query


def _norm_const(t: int, rep: np.ndarray) -> int:
    """rho(t) for a query constant.

    A constant interned after this rho was frozen (a resource the serving
    epoch has never seen) is its own representative — a singleton — so the
    query stays answerable (empty match) instead of indexing out of range.
    """
    return int(rep[t]) if t < rep.shape[0] else int(t)


def _normalise_query(q: Query, rep: np.ndarray) -> Query:
    pats = [
        tuple(_norm_const(t, rep) if not is_var(t) else t for t in atom)
        for atom in q.patterns
    ]
    # steps pass through untouched: FILTER comparison values must NOT be
    # normalised (FILTER compares concrete resources, hence runs on
    # expanded bindings), and builtins operate on expanded resources too
    return Query(pats, list(q.steps), list(q.select), q.distinct)


def _match_bgp(patterns, triples: np.ndarray):
    b = Bindings.empty_universe()
    for atom in patterns:
        b, _ = join_atom(b, atom, triples)
        if b.nrows == 0:
            break
    return b


class _Solutions:
    """Columnar solution table with multiplicities and per-var expansion flags."""

    def __init__(self, bindings: Bindings):
        self.cols: dict[int, np.ndarray] = dict(bindings.cols)
        self.strs: dict[int, list[str]] = {}  # builtin outputs (host strings)
        self.mult = np.ones(bindings.nrows, dtype=np.int64)
        self.expanded: set[int] = set()

    @property
    def nrows(self) -> int:
        return self.mult.shape[0]

    def take(self, idx: np.ndarray) -> None:
        self.cols = {v: c[idx] for v, c in self.cols.items()}
        self.strs = {v: [s[i] for i in idx] for v, s in self.strs.items()}
        self.mult = self.mult[idx]

    def expand_var(self, v: int, rho: FrozenRho) -> None:
        """Replace each row by one row per clique member of row[v]."""
        if v in self.expanded or v not in self.cols:
            return
        idx, vals = rho.expand_ids(self.cols[v])
        self.take(idx)
        self.cols[v] = vals
        self.expanded.add(v)


def _rho_view(rep) -> FrozenRho:
    return rep if isinstance(rep, FrozenRho) else FrozenRho(rep)


def evaluate(
    q: Query,
    triples: np.ndarray,
    rep,
    dic,
) -> Counter:
    """Bag of answers: Counter mapping answer tuples (ordered by q.select).

    Answer atoms are resource names (via ``dic``) for resource vars and raw
    strings for builtin-produced vars.  ``rep`` is a representative array or
    a :class:`~repro_torch.core.uf.FrozenRho` view.
    """
    rho = _rho_view(rep)
    qn = _normalise_query(q, rho.rep)
    sol = _Solutions(_match_bgp(qn.patterns, triples))
    return _finish(q, qn, sol, rho, dic)


def _finish(q: Query, qn: Query, sol: _Solutions, rho: FrozenRho, dic) -> Counter:
    """Steps + projection + clique expansion over a matched solution table.

    The tail of :func:`evaluate` after the BGP match — shared verbatim by
    the host matcher and the batched device matcher
    (:mod:`repro_torch.sparql.batched`), so the two paths can only differ in how
    the BGP solution rows were produced, never in the bag semantics layered
    on top of them.
    """
    sizes = rho.sizes

    for step in qn.steps:
        if isinstance(step, Bind):
            # paper §5 Q2: expand *before* evaluating the builtin
            sol.expand_var(step.src, rho)
            names = [dic.lookup(int(x)) for x in sol.cols[step.src]]
            if step.fn == "STR":
                out = [n.lstrip(":") for n in names]
            elif step.fn == "UCASE":
                out = [n.lstrip(":").upper() for n in names]
            else:
                raise ValueError(f"unknown builtin {step.fn}")
            sol.strs[step.dst] = out
            sol.expanded.add(step.dst)
        elif isinstance(step, FilterEq):
            # comparisons see concrete resources: expand first
            sol.expand_var(step.var, rho)
            keep = np.flatnonzero(sol.cols[step.var] == step.value)
            sol.take(keep)

    # projection: projected-out unexpanded vars contribute clique sizes
    keep_vars = list(qn.select)
    for v in list(sol.cols):
        if v not in keep_vars and v not in sol.expanded:
            sol.mult = sol.mult * sizes[sol.cols[v]]
    # expand retained resource vars (unexpanded ones only)
    for v in keep_vars:
        if v in sol.cols:
            sol.expand_var(v, rho)

    if (not sol.strs and keep_vars and sol.nrows > 64
            and all(v in sol.cols for v in keep_vars)):
        # pure-resource answers with non-trivial bags: collapse duplicate
        # rows and look names up once per distinct id instead of once per
        # row — answer bags expand to clique x clique sizes, so the Python
        # per-row loop was the dominant cost of a served scan query.  Small
        # bags (point lookups) stay on the loop: its per-row cost undercuts
        # the fixed np.unique(axis=0) setup below the cutoff
        mat = np.stack([sol.cols[v] for v in keep_vars], axis=1)
        uniq, inv = np.unique(mat, axis=0, return_inverse=True)
        mults = np.zeros(uniq.shape[0], dtype=np.int64)
        np.add.at(mults, inv, sol.mult)
        names = {int(i): dic.lookup(int(i)) for i in np.unique(uniq)}
        out = Counter()
        for row, m in zip(uniq.tolist(), mults.tolist()):
            out[tuple(names[x] for x in row)] = m
    else:
        out = Counter()
        for i in range(sol.nrows):
            key = tuple(
                sol.strs[v][i] if v in sol.strs
                else dic.lookup(int(sol.cols[v][i]))
                for v in keep_vars
            )
            out[key] += int(sol.mult[i])
    if q.distinct:
        return Counter({k: 1 for k in out})
    return out


def evaluate_at(q: Query, snapshot, dic, naive: bool = False):
    """Answer ``q`` against an epoch-consistent snapshot handle.

    ``snapshot`` is any object with ``triples`` (host copy of the live
    normal-form store at some completed maintenance epoch), ``rho`` (a
    :class:`~repro_torch.core.uf.FrozenRho`) and ``epoch`` — canonically
    :class:`repro_torch.core.engine.StoreSnapshot` (device-resident snapshots
    materialise their host copy lazily on first access here).  Returns
    ``(answers, epoch)``: the executor never touches the live arena, so a
    maintenance operation in flight on the owning state cannot leak a
    mid-round store into the answer (the ``as_of_epoch`` contract of
    :mod:`repro_torch.serve.triple_store`).
    """
    fn = evaluate_naive if naive else evaluate
    return fn(q, snapshot.triples, snapshot.rho, dic), snapshot.epoch


def evaluate_naive(q: Query, triples: np.ndarray, rep, dic) -> Counter:
    """The incorrect strategy (paper §5): evaluate rho(Q) on T, run builtins
    on representatives, project, then post-hoc expand the answer set."""
    rho = _rho_view(rep)
    rep = rho.rep
    members = rho.members
    qn = _normalise_query(q, rep)
    sol = _Solutions(_match_bgp(qn.patterns, triples))
    for step in qn.steps:
        if isinstance(step, Bind):
            names = [dic.lookup(int(x)) for x in sol.cols[step.src]]
            sol.strs[step.dst] = [n.lstrip(":") for n in names]
        elif isinstance(step, FilterEq):
            keep = np.flatnonzero(sol.cols[step.var] == _norm_const(step.value, rep))
            sol.take(keep)
    out: Counter = Counter()
    keep_vars = list(qn.select)
    for i in range(sol.nrows):
        # post-hoc expansion: substitute representatives by clique members
        lists = []
        for v in keep_vars:
            if v in sol.strs:
                lists.append([sol.strs[v][i]])
            else:
                ms = members.get(int(sol.cols[v][i]), np.array([sol.cols[v][i]]))
                lists.append([dic.lookup(int(m)) for m in ms])
        import itertools

        for combo in itertools.product(*lists):
            out[tuple(combo)] += 1
    return out
