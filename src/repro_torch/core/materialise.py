"""Materialisation entry points: AX (explicit axiomatisation) and REW (rewriting).

``materialise_ax``   computes [P u P~=]^inf(E) with the paper's rules ~=1..~=5
                     added as ordinary datalog rules (the baseline the paper
                     compares against, §3/§6 'AX mode').
``materialise_rew``  is the paper's contribution (§4): maintain rho, rewrite
                     facts *and rules*, mark-don't-delete, re-evaluate
                     rewritten rules, add reflexive sameAs facts — adapted to
                     bulk-synchronous rounds.

``expand``           computes T^rho (the expansion) — the Theorem 1(3)
                     oracle: expand(REW result) == AX result.

A numpy copy of ``repro.core.materialise``: the paper's baseline and oracle
for the device engine (:mod:`repro_torch.core.engine`), which raises this
module's :class:`Contradiction`.  The port imports nothing of the JAX
package.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from .axiom import is_contradiction, with_axiomatisation
from .rules import Program
from .seminaive import eval_rule_delta, eval_rule_full
from .stats import MatStats
from .terms import DIFFERENT_FROM, SAME_AS
from .triples import TripleArena, dedup_rows as _dedup, pack
from .uf import clique_members, compress_np, merge_pairs_np


class Contradiction(Exception):
    """Rule ~=5 fired: <a, owl:differentFrom, a>."""


@dataclass
class MatResult:
    arena: TripleArena
    rep: np.ndarray
    program: Program          # final (possibly rewritten) program
    stats: MatStats
    dictionary: object = None
    deriv_counter: Counter | None = None  # packed-fact -> times derived

    def triples(self) -> np.ndarray:
        return self.arena.valid_triples()

    def clique_sizes_of(self, ids: np.ndarray) -> np.ndarray:
        from .uf import clique_sizes

        sizes = clique_sizes(self.rep)
        return sizes[self.rep[ids]]


def _check_contradictions(cands: np.ndarray) -> None:
    bad = (cands[:, 1] == DIFFERENT_FROM) & (cands[:, 0] == cands[:, 2])
    if bad.any():
        row = cands[np.flatnonzero(bad)[0]]
        raise Contradiction(f"<{row[0]}, owl:differentFrom, {row[0]}> derived")


# ---------------------------------------------------------------------------
# AX mode
# ---------------------------------------------------------------------------

def materialise_ax(
    facts: np.ndarray,
    program: Program,
    n_resources: int,
    max_rounds: int = 10_000,
    track_derivations: bool = False,
) -> MatResult:
    t0 = time.perf_counter()
    stats = MatStats(mode="AX")
    counter: Counter | None = Counter() if track_derivations else None
    arena = TripleArena()
    p_ax = with_axiomatisation(program)

    cands = np.asarray(facts, dtype=np.int32).reshape(-1, 3)
    stats.triples_explicit = cands.shape[0]
    while cands.shape[0] > 0:
        _check_contradictions(cands)
        delta = arena.add_batch(cands)
        if delta.shape[0] == 0:
            break
        stats.rounds += 1
        if stats.rounds > max_rounds:
            raise RuntimeError("materialisation did not converge")
        live = arena.spo[: arena.n][arena.valid[: arena.n]]
        # rows are append-only, so the trailing delta rows are the new ones
        t_old = live[: live.shape[0] - delta.shape[0]]
        t_all = live
        outs = []
        for rule in p_ax:
            h, nd, na = eval_rule_delta(rule, t_old, t_all, delta)
            stats.derivations += nd
            stats.rule_applications += na
            if counter is not None and h.shape[0]:
                counter.update(pack(h).tolist())
            outs.append(h)
        cands = _dedup(np.concatenate(outs, axis=0)) if outs else np.zeros((0, 3), np.int32)

    stats.triples_total = arena.total
    stats.triples_unmarked = arena.unmarked
    stats.memory_bytes = arena.nbytes
    stats.wall_seconds = time.perf_counter() - t0
    rep = np.arange(n_resources, dtype=np.int32)
    return MatResult(arena, rep, p_ax, stats, deriv_counter=counter)


# ---------------------------------------------------------------------------
# REW mode (the paper's algorithm, bulk-synchronous)
# ---------------------------------------------------------------------------

def rew_rounds(
    arena: TripleArena,
    rep: np.ndarray,
    program: Program,
    cands: np.ndarray,
    stats: MatStats,
    max_rounds: int = 10_000,
    r_queue: list | None = None,
) -> tuple[np.ndarray, Program]:
    """Run the bulk-synchronous REW loop to fixpoint over ``cands``.

    The shared round loop behind :func:`materialise_rew` (which starts from an
    empty arena) and incremental maintenance (which resumes from a
    populated arena: additions seed ``cands`` with the new triples, deletions
    seed it with the rederivation candidates after the B/F overdelete pass).
    Mutates ``arena`` and ``stats`` in place; returns the updated
    ``(rep, program)``.  ``max_rounds`` bounds this invocation, not the
    cumulative ``stats.rounds``.
    """
    p_cur = program
    r_queue = list(r_queue) if r_queue else []  # rules awaiting full re-eval
    cands = np.asarray(cands, dtype=np.int32).reshape(-1, 3)
    rounds_here = 0

    while cands.shape[0] > 0 or r_queue:
        stats.rounds += 1
        rounds_here += 1
        if rounds_here > max_rounds:
            raise RuntimeError("materialisation did not converge")

        # ---- process candidates (Algorithm 4, batched) -------------------
        cands = rep[cands].astype(np.int32) if cands.shape[0] else cands

        sameas = (cands[:, 1] == SAME_AS) if cands.shape[0] else np.zeros(0, bool)
        nontriv = sameas & (cands[:, 0] != cands[:, 2])
        pairs = cands[nontriv][:, [0, 2]]
        rep_changed = False
        if pairs.shape[0]:
            pairs = np.unique(pairs, axis=0)
            stats.sameas_pairs += pairs.shape[0]
            rep, n_merged = merge_pairs_np(rep, pairs)
            if n_merged:
                rep_changed = True
                stats.merged_resources += n_merged

        if rep_changed:
            # re-normalise candidates under the new rho, then sweep the arena
            # (bulk Algorithm 3: mark outdated facts, re-derive their rewriting)
            cands = rep[cands].astype(np.int32)
            rewritten = arena.rewrite_sweep(rep)
        else:
            rewritten = np.zeros((0, 3), np.int32)

        # non-sameAs-pair candidates (pairs became reflexive under new rho)
        to_store = _dedup(np.concatenate([cands, rewritten], axis=0))
        # ~=5 must see the post-merge normal forms: <a,dF,b> with a,b merged
        # is a contradiction even though neither raw candidate was reflexive
        _check_contradictions(to_store)
        delta = arena.add_batch(to_store)

        # reflexivity (Algorithm 4 lines 17-18): <c, sameAs, c> for every
        # resource of every stored fact; chases its own closure through ~=.
        if delta.shape[0]:
            res = np.unique(delta)
            res = np.unique(np.concatenate([res, [SAME_AS]]))
            refl = np.stack(
                [res, np.full_like(res, SAME_AS), res], axis=1
            ).astype(np.int32)
            refl_added = arena.add_batch(refl)
            stats.reflexive_added += refl_added.shape[0]
            stats.derivations += refl_added.shape[0]
            delta = np.concatenate([delta, refl_added], axis=0)

        # ---- rule rewriting barrier (Algorithm 1 lines 6-11) -------------
        if rep_changed:
            p_new, changed_idx = p_cur.rewrite(rep)
            if changed_idx:
                stats.rule_rewrites += 1
                stats.rules_requeued += len(changed_idx)
                r_queue.extend(p_new.rules[i] for i in changed_idx)
            p_cur = p_new

        # ---- evaluate rules on the new delta ------------------------------
        live = arena.spo[: arena.n][arena.valid[: arena.n]]
        t_all = live
        t_old = live[: live.shape[0] - delta.shape[0]]
        outs = []
        for rule in p_cur:
            h, nd, na = eval_rule_delta(rule, t_old, t_all, delta)
            stats.derivations += nd
            stats.rule_applications += na
            outs.append(h)
        for rule in r_queue:
            h, nd, na = eval_rule_full(rule, t_all)
            stats.derivations += nd
            stats.rule_applications += na
            outs.append(h)
        r_queue = []
        cands = _dedup(np.concatenate(outs, axis=0)) if outs else np.zeros((0, 3), np.int32)
        # drop candidates already present (cheap pre-filter; add_batch rededups)
        if cands.shape[0]:
            cands = cands[~arena.contains(rep[cands].astype(np.int32))]

    return compress_np(rep), p_cur


def materialise_rew(
    facts: np.ndarray,
    program: Program,
    n_resources: int,
    max_rounds: int = 10_000,
) -> MatResult:
    t0 = time.perf_counter()
    stats = MatStats(mode="REW")
    arena = TripleArena()
    rep = np.arange(n_resources, dtype=np.int32)

    cands = np.asarray(facts, dtype=np.int32).reshape(-1, 3)
    stats.triples_explicit = cands.shape[0]
    rep, p_cur = rew_rounds(arena, rep, program, cands, stats, max_rounds)

    stats.triples_total = arena.total
    stats.triples_unmarked = arena.unmarked
    stats.memory_bytes = arena.nbytes
    stats.wall_seconds = time.perf_counter() - t0
    return MatResult(arena, rep, p_cur, stats)


def materialise(facts, program, n_resources, mode: str = "REW", **kw) -> MatResult:
    if mode.upper() == "AX":
        return materialise_ax(facts, program, n_resources, **kw)
    if mode.upper() == "REW":
        return materialise_rew(facts, program, n_resources, **kw)
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# expansion + Theorem 1 validators
# ---------------------------------------------------------------------------

def expand(triples: np.ndarray, rep: np.ndarray) -> set[tuple[int, int, int]]:
    """T^rho = { <s,p,o> | <rho(s),rho(p),rho(o)> in T } as an explicit set.

    Only usable at test scale — the whole point of the paper is to avoid ever
    materialising this set.
    """
    rep = compress_np(rep)
    members = clique_members(rep)

    def mem(r: int) -> np.ndarray:
        return members.get(int(r), np.array([r], dtype=np.int64))

    out: set[tuple[int, int, int]] = set()
    for s, p, o in np.asarray(triples):
        ms, mp, mo = mem(s), mem(p), mem(o)
        for a in ms:
            for b in mp:
                for c in mo:
                    out.add((int(a), int(b), int(c)))
    return out


def check_theorem1(res: MatResult, ax: MatResult | None = None) -> None:
    """Assert the three properties of Theorem 1 (raises AssertionError)."""
    t = res.triples()
    # (1) rho captures all equalities: no unmarked non-reflexive sameAs fact
    sa = t[(t[:, 1] == SAME_AS)]
    assert (sa[:, 0] == sa[:, 2]).all(), "non-reflexive sameAs fact survived"
    # (2) T is minimal: every unmarked fact is rho-normal
    assert (res.rep[t] == t).all(), "fact with outdated resource survived"
    # (3) T^rho == [P u P~=]^inf(E)
    if ax is not None:
        lhs = expand(t, res.rep)
        rhs = {tuple(map(int, row)) for row in ax.triples()}
        assert lhs == rhs, (
            f"expansion mismatch: only-rew={len(lhs - rhs)} only-ax={len(rhs - lhs)}"
        )
