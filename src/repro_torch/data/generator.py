"""Clique-injected synthetic KG families mirroring the paper's five datasets.

The port's own copy of ``repro.data.generator`` (``generate``,
``sample_update_stream`` and ``PROFILES``): same code, same seeds, same
facts and events, and no import of the JAX package.  The sampler's query
events (``p_query > 0``) wait for the serving tier and raise.

The paper evaluates on Claros / DBpedia / OpenCyc / UniProt / UOBM, whose
shared structural features are: (a) owl:sameAs triples derived DURING
materialisation (inverse-functional-style rules), (b) DL-style rule programs
(property chains, symmetric/transitive properties, hierarchies), and (c) very
different equality densities — from 5 merges (UniProt) to 361k (OpenCyc).

Each profile below reproduces those regimes at CPU-runnable scale (the knobs
are documented next to the paper dataset they imitate); bench_materialisation
reports the same columns as the paper's Table 2 on them.

Structure: entities are partitioned into k duplicate-groups ("the same
real-world thing registered n times").  Each duplicate carries an
:idProp value shared by its group; the rule

    <x, owl:sameAs, y> <- <x, :idProp, v> & <y, :idProp, v>

(an inverse-functional property, the dominant real-world source of sameAs)
derives the cliques during materialisation, exactly like rule (R)/(S) of the
paper's running example.  Spoke triples hang off duplicates so that merges
"copy" payload triples under AX.  Optional extras per profile:

  * symmetric+transitive :sameHomeTown (the UOBM quadratic-derivation trap),
  * a class hierarchy (type-propagation chains like Claros/OpenCyc),
  * a property chain rule (DBpedia-style join rules),
  * entity-constant rules (``const_rules``): rules whose body references a
    specific clique member by ID, so that merging its clique rewrites the
    rule itself — rho(P) changes, Algorithm 1's queue R fills, and the
    forward-side re-merge machinery is exercised (the ``merge_like``
    profile drives the ``full_plan_evals == 0`` acceptance gate with it).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.rules import Program, parse_program
from repro_torch.core.terms import Dictionary

__all__ = ["generate", "sample_update_stream", "PROFILES"]


def generate(
    n_groups: int = 200,
    group_size: int = 4,
    n_spokes_per: int = 3,
    n_plain: int = 2000,
    n_classes: int = 12,
    hierarchy_depth: int = 3,
    hometown_groups: int = 0,
    hometown_size: int = 0,
    chain_rules: bool = False,
    const_rules: int = 0,
    seed: int = 0,
) -> tuple[np.ndarray, Program, Dictionary]:
    """Returns (facts (N,3) int32, program, dictionary)."""
    rng = np.random.default_rng(seed)
    dic = Dictionary()
    sa = "owl:sameAs"  # parsed rules intern it consistently

    rules = [
        # inverse-functional id => sameAs (the clique generator)
        f"(?x, {sa}, ?y) <- (?x, :idProp, ?v) & (?y, :idProp, ?v)",
    ]
    if hierarchy_depth > 0:
        for lvl in range(hierarchy_depth):
            rules.append(
                f"(?x, rdf:type, :C{lvl + 1}) <- (?x, rdf:type, :C{lvl})"
            )
    if hometown_groups > 0:
        rules += [
            "(?y, :sameHomeTown, ?x) <- (?x, :sameHomeTown, ?y)",
            "(?x, :sameHomeTown, ?z) <- (?x, :sameHomeTown, ?y) & (?y, :sameHomeTown, ?z)",
        ]
    if chain_rules:
        rules += [
            "(?x, :colleagueOf, ?z) <- (?x, :worksAt, ?y) & (?z, :worksAt, ?y)",
            "(?x, :related, ?y) <- (?x, :colleagueOf, ?y)",
        ]
    program = parse_program(rules, dic)

    id_prop = dic.intern(":idProp")
    rdf_type = dic.intern("rdf:type")
    spoke = dic.intern(":spoke")
    works_at = dic.intern(":worksAt")
    home = dic.intern(":sameHomeTown")
    classes = dic.intern_many([f":C{i}" for i in range(hierarchy_depth + 1)])

    rows: list[tuple[int, int, int]] = []

    # duplicate groups -> cliques via :idProp
    for g in range(n_groups):
        vid = dic.intern(f":idval{g}")
        members = dic.intern_many([f":e{g}_{i}" for i in range(group_size)])
        for m in members:
            rows.append((m, id_prop, vid))
            rows.append((m, rdf_type, classes[0]))
        for j in range(n_spokes_per):
            s = dic.intern(f":spoke{g}_{j}")
            rows.append((s, spoke, members[j % group_size]))

    # entity-constant rules: each references its group's LAST member (the
    # highest-ID clique member, interned above in fact order), so rho — whose
    # representative is the clique minimum — rewrites the rule constant on
    # the in-group merge and again whenever an update merges the clique into
    # a lower-ID one.  Parsed AFTER the group entities so the constant is the
    # already-interned member, not a fresh low-ID resource that would win
    # representative election and never be rewritten.
    if const_rules > 0:
        const_lines = [
            f"(?s, :anchored, :A{k}) <- (?s, :spoke, :e{k}_{group_size - 1})"
            for k in range(min(const_rules, n_groups))
        ]
        program = Program(program.rules + parse_program(const_lines, dic).rules)

    # plain (merge-free) payload triples
    ents = dic.intern_many([f":p{i}" for i in range(max(n_plain // 4, 1))])
    orgs = dic.intern_many([f":org{i}" for i in range(max(n_plain // 40, 1))])
    props = dic.intern_many([":knows", ":near", ":partOf"])
    for _ in range(n_plain):
        s = ents[rng.integers(len(ents))]
        p = props[rng.integers(len(props))]
        o = ents[rng.integers(len(ents))]
        rows.append((s, p, o))
    if chain_rules:
        for e in ents:
            rows.append((e, works_at, orgs[rng.integers(len(orgs))]))

    # UOBM-style symmetric+transitive hometown groups (quadratic derivations
    # that rewriting does NOT remove — the paper's UOBM analysis)
    for hg in range(hometown_groups):
        ppl = dic.intern_many([f":ht{hg}_{i}" for i in range(hometown_size)])
        for i in range(hometown_size - 1):
            rows.append((ppl[i], home, ppl[i + 1]))

    facts = np.asarray(rows, dtype=np.int32)
    return facts, program, dic


def _sample_query(rng, current, dic: Dictionary):
    """A random BGP query over the stream's current explicit facts.

    Shapes exercise the paper's §5 hazards against a *live* store: a
    projected-out join variable (clique-size multiplicities), a two-pattern
    join through a shared variable, and a constant pattern whose resource
    must be rho-normalised at the epoch the query is served at.  Variables
    are the executor's negative IDs (?x=-1, ?y=-2, ?z=-3).
    """
    from repro_torch.sparql.algebra import Query

    if not current:
        return Query([(-1, dic.intern(":idProp"), -2)], [], [-1], False)
    _s, p, o = current[rng.integers(len(current))]
    kind = int(rng.integers(3))
    if kind == 0:  # bag semantics: ?y projected out -> clique multiplicities
        patterns, select = [(-1, p, -2)], [-1]
    elif kind == 1:  # join through a shared variable
        patterns, select = [(-1, p, -2), (-3, p, -2)], [-1, -3]
    else:  # constant object: normalised under the serving epoch's rho
        patterns, select = [(-1, p, int(o))], [-1]
    return Query(patterns, [], select, distinct=bool(rng.random() < 0.3))


def sample_update_stream(
    facts: np.ndarray,
    dic: Dictionary,
    n_events: int = 6,
    batch: int = 24,
    p_delete: float = 0.5,
    p_merge_add: float = 0.4,
    p_query: float = 0.0,
    seed: int = 0,
) -> list[tuple[str, object]]:
    """Sample an update stream for incremental-maintenance workloads.

    Returns ``[(op, payload), ...]`` with ``op in {"add", "delete"}``, each
    payload an (m, 3) int32 batch of explicit triples, consistent as a
    sequence (deletions only target facts explicit at that point).  The
    additions include fresh ``:idProp`` edges between existing entities —
    under the generator's inverse-functional rule those derive new sameAs
    merges, and their later deletion forces clique splits.  Plain payload
    additions reuse existing resources.

    With ``p_query > 0`` the trace is a mixed serving workload: events may
    also be ``("query", repro_torch.sparql.Query)``, read-only queries
    sampled over the stream's current explicit facts, which a live store
    answers at whatever maintenance epoch it has completed when they are
    admitted (:mod:`repro_torch.serve.triple_store`).  Queries never mutate
    the stream.  The draws are the reference's, so both packages give the
    same events for the same seed.
    """
    rng = np.random.default_rng(seed)
    current: list[tuple[int, int, int]] = [tuple(map(int, r)) for r in facts]
    id_prop = dic.intern(":idProp")
    events: list[tuple[str, object]] = []
    n_upd_vals = 0

    for ev in range(n_events):
        if p_query > 0 and rng.random() < p_query:
            events.append(("query", _sample_query(rng, current, dic)))
            continue
        do_delete = current and rng.random() < p_delete
        if do_delete:
            m = min(batch, len(current))
            idx = rng.choice(len(current), size=m, replace=False)
            delta = np.asarray([current[i] for i in idx], dtype=np.int32)
            keep = np.ones(len(current), dtype=bool)
            keep[idx] = False
            current = [row for row, k in zip(current, keep) if k]
            events.append(("delete", delta))
            continue
        subjects = sorted({r[0] for r in current})
        if len(subjects) < 2:  # (re)bootstrap an emptied stream
            subjects += dic.intern_many([f":seed{ev}_{i}" for i in range(2)])
        rows: list[tuple[int, int, int]] = []
        for _ in range(batch):
            if not current or rng.random() < p_merge_add:
                # fresh inverse-functional value shared by two existing
                # entities -> derives a new sameAs merge when applied
                a, b = rng.choice(len(subjects), size=2, replace=False)
                vid = dic.intern(f":updval{n_upd_vals}")
                n_upd_vals += 1
                rows.append((subjects[a], id_prop, vid))
                rows.append((subjects[b], id_prop, vid))
            else:
                src = current[rng.integers(len(current))]
                s = subjects[rng.integers(len(subjects))]
                rows.append((s, src[1], src[2]))
        delta = np.unique(np.asarray(rows, dtype=np.int32), axis=0)
        current.extend(tuple(map(int, r)) for r in delta)
        events.append(("add", delta))
    return events

# Reduced-scale stand-ins for the paper's datasets (Table 2 rows).
PROFILES: dict[str, dict] = {
    # Claros: mid-size, many sameAs merges, deep type hierarchy
    "claros_like": dict(
        n_groups=300, group_size=6, n_spokes_per=4, n_plain=4000,
        hierarchy_depth=4,
    ),
    # DBpedia: large plain payload, few merges
    "dbpedia_like": dict(
        n_groups=60, group_size=3, n_spokes_per=2, n_plain=20000,
        hierarchy_depth=2, chain_rules=True,
    ),
    # OpenCyc: equality-dense — many big cliques, little payload
    "opencyc_like": dict(
        n_groups=500, group_size=8, n_spokes_per=2, n_plain=1500,
        hierarchy_depth=3,
    ),
    # UniProt: almost no equalities, heavy payload + chains
    "uniprot_like": dict(
        n_groups=2, group_size=2, n_spokes_per=1, n_plain=25000,
        hierarchy_depth=2, chain_rules=True,
    ),
    # UOBM: few merges + symmetric/transitive hometown cluster
    "uobm_like": dict(
        n_groups=40, group_size=3, n_spokes_per=2, n_plain=3000,
        hierarchy_depth=2, hometown_groups=4, hometown_size=24,
    ),
    # Round-count extremes for the fused-fixpoint dispatch gate
    # (BENCH_incremental's dispatches_per_event).  Chain: almost no
    # merges, deep hierarchy + chain rules => long multi-round forward
    # convergence per event.  Clique: merge-dense, shallow payload =>
    # rounds dominated by the sameAs machinery and overdelete waves.
    "chain_like": dict(
        n_groups=2, group_size=3, n_spokes_per=1, n_plain=6000,
        hierarchy_depth=5, chain_rules=True,
    ),
    "clique_like": dict(
        n_groups=400, group_size=6, n_spokes_per=2, n_plain=1000,
        hierarchy_depth=1,
    ),
    # Merge-heavy stream against entity-constant rules: update merges that
    # relabel a referenced clique member rewrite rho(P) mid-stream, driving
    # the forward-side targeted re-merge path (and the full_plan_evals == 0
    # acceptance gate) rather than only the delete-side rederive machinery.
    "merge_like": dict(
        n_groups=48, group_size=4, n_spokes_per=3, n_plain=600,
        hierarchy_depth=1, const_rules=12,
    ),
}
