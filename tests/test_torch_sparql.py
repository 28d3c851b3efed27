"""The port's SPARQL layer against the reference's: the algebra, the host
executor on the paper's §5 queries, ``FrozenRho``, the shape plans, and the
batched matcher (the prefix form of the search kernel; its plain version
on the CPU) against the reference's vmapped ``_bgp_one`` on bit-equal
published snapshots.  Tolerance: exact.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402
from collections import Counter  # noqa: E402
from functools import partial  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import enable_x64  # noqa: E402

from repro.core import materialise as jmat  # noqa: E402
from repro.core import uf as juf  # noqa: E402
from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.data.datasets import pex as jpex  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro.sparql import Query as JQuery  # noqa: E402
from repro.sparql import batched as jbatched  # noqa: E402
from repro.sparql import evaluate as jevaluate  # noqa: E402
from repro.sparql import evaluate_naive as jevaluate_naive  # noqa: E402
from repro_torch.core import materialise as mat  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.uf import FrozenRho  # noqa: E402
from repro_torch.data.datasets import pex  # noqa: E402
from repro_torch.data.generator import generate  # noqa: E402
from repro_torch.sparql import (  # noqa: E402
    BatchedExecutor, Query, evaluate, evaluate_at, evaluate_naive,
)
from repro_torch.sparql import batched  # noqa: E402

# the paper's §5 queries of tests/test_sparql.py, with each one's answer
Q1 = "SELECT ?x WHERE { (?x, :presidentOf, ?y) }"
PAPER = {
    "q1": (Q1, None, False, Counter({(":Obama",): 3, (":USPresident",): 3})),
    "q1_naive": (Q1, None, True, Counter({(":Obama",): 1, (":USPresident",): 1})),
    "q1_distinct": ("SELECT DISTINCT ?x WHERE { (?x, :presidentOf, ?y) }", None,
                    False, Counter({(":Obama",): 1, (":USPresident",): 1})),
    "q2_bind": ("SELECT ?y WHERE { (?x, :presidentOf, :US) }", "bind", False,
                Counter({("Obama",): 1, ("USPresident",): 1})),
    "q2_naive": ("SELECT ?y WHERE { (?x, :presidentOf, :US) }", "bind", True, None),
    "filter": (Q1, "filter", False, Counter({(":Obama",): 1, (":USPresident",): 1})),
    "join": ("SELECT ?x ?z WHERE { (?x, :presidentOf, ?y) . (?z, :presidentOf, ?y) }",
             None, False, None),
}


@pytest.fixture(scope="module")
def rew():
    facts, prog, dic = pex()
    jfacts, jprog, jdic = jpex()
    res = mat.materialise(facts, prog, dic.n_resources, mode="REW")
    jres = jmat.materialise(jfacts, jprog, jdic.n_resources, mode="REW")
    return res, dic, jres, jdic


@pytest.mark.parametrize("name", sorted(PAPER))
def test_paper_queries_match_reference(rew, name):
    res, dic, jres, jdic = rew
    text, step, naive, want = PAPER[name]
    q, jq = Query.parse(text, dic), JQuery.parse(text, jdic)
    assert (q.patterns, q.select, q.distinct) == (jq.patterns, jq.select, jq.distinct)
    for query, d in ((q, dic), (jq, jdic)):
        if step == "bind":
            query.bind("STR", -1, -2)
            query.select = [-2]
        elif step == "filter":
            query.filter_eq(-2, d.id_of(":America"))
    fn, jfn = (evaluate_naive, jevaluate_naive) if naive else (evaluate, jevaluate)
    got = fn(q, res.triples(), res.rep, dic)
    assert got == jfn(jq, jres.triples(), jres.rep, jdic)
    if want is not None:
        assert got == want
    # through a frozen rho, and against a host snapshot handle
    assert fn(q, res.triples(), FrozenRho(res.rep), dic) == got
    if not naive:
        snap = dataclasses.make_dataclass("S", ["triples", "rho", "epoch"])(
            res.triples(), FrozenRho(res.rep), 7)
        assert evaluate_at(q, snap, dic) == (got, 7)


def test_query_over_full_expansion_equivalence(rew):
    res, dic, _, _ = rew
    exp = np.asarray(sorted(mat.expand(res.triples(), res.rep)), dtype=np.int32)
    q = Query.parse(Q1, dic)
    identity = np.arange(res.rep.shape[0], dtype=np.int32)
    assert evaluate(q, exp, identity, dic) == evaluate(q, res.triples(), res.rep, dic)


# ---------------------------------------------------------------------------
# FrozenRho
# ---------------------------------------------------------------------------

def _members(fr) -> dict:
    return {k: v.tolist() for k, v in fr.members.items()}


@pytest.mark.parametrize("seed", range(4))
def test_frozen_rho_matches_reference(seed):
    """Members, sizes, normalise and both forms of ``expand_ids`` equal the
    reference's, and so does a chain of ``refreshed`` views (merges, a
    split, an interned tail) and a cold view's refresh."""
    rng = np.random.default_rng(seed)
    n = 60
    rep = np.arange(n, dtype=np.int32)
    for _ in range(25):
        a, b = sorted(rng.integers(0, n, 2))
        rep = np.minimum(rep, np.where(rep == rep[b], rep[a], rep))
    fr, jr = FrozenRho(rep), juf.FrozenRho(rep)
    np.testing.assert_array_equal(fr.rep, jr.rep)
    np.testing.assert_array_equal(fr.sizes, jr.sizes)
    assert _members(fr) == _members(jr)
    ids = rng.integers(0, n + 5, (40, 3))
    np.testing.assert_array_equal(fr.normalise(ids[ids < n].reshape(-1)),
                                  jr.normalise(ids[ids < n].reshape(-1)))
    for col in (ids[:10, 0], ids[:, 0], np.repeat(ids[:, 1], 3)):  # both forms
        for a, b in zip(fr.expand_ids(col), jr.expand_ids(col)):
            np.testing.assert_array_equal(a, b)
    for step in range(4):
        nxt = fr.rep.copy()
        if step == 2:  # split a clique
            roots = np.flatnonzero(fr.sizes > 1)
            if roots.shape[0]:
                mem = fr.members[int(roots[0])]
                nxt[mem] = mem
        elif step == 3:  # interned tail, merged into an old clique
            nxt = np.concatenate([nxt, np.asarray([nxt[1], n + 1], np.int32)])
        else:
            a, b = sorted(rng.integers(0, n, 2))
            nxt = np.minimum(nxt, np.where(nxt == nxt[b], nxt[a], nxt)).astype(np.int32)
        fr, jr = fr.refreshed(nxt), jr.refreshed(nxt)
        assert _members(fr) == _members(jr) == _members(FrozenRho(nxt))
        np.testing.assert_array_equal(fr.sizes, jr.sizes)
        assert not fr.rep.flags.writeable
    assert fr.refreshed(fr.rep.copy()) is fr
    cold, jcold = FrozenRho(rep), juf.FrozenRho(rep)
    assert _members(cold.refreshed(fr.rep)) == _members(jcold.refreshed(fr.rep))


def test_frozen_rho_refreshed():
    """The reference's own case (tests/test_serve_async_batched.py)."""
    rep = np.arange(10, dtype=np.int32)
    rep[3] = 1
    rep[4] = 1
    r0 = FrozenRho(rep)
    assert sorted(r0.members[1].tolist()) == [1, 3, 4]
    assert r0.refreshed(rep.copy()) is r0
    rep2 = rep.copy()
    rep2[7] = 1
    r1 = r0.refreshed(rep2)
    assert r1 is not r0 and sorted(r1.members[1].tolist()) == [1, 3, 4, 7]
    assert _members(r1) == _members(FrozenRho(rep2))
    rep3 = rep2.copy()
    rep3[4] = 4
    r2 = r1.refreshed(rep3)
    assert sorted(r2.members[1].tolist()) == [1, 3, 7] and 4 not in r2.members
    rep4 = np.concatenate([rep3, np.asarray([1, 11], np.int32)])
    r3 = r2.refreshed(rep4)
    assert sorted(r3.members[1].tolist()) == [1, 3, 7, 10]
    assert _members(r3) == _members(FrozenRho(rep4))
    assert sorted(FrozenRho(rep).refreshed(rep2).members[1].tolist()) == [1, 3, 4, 7]


# ---------------------------------------------------------------------------
# plans and the matcher
# ---------------------------------------------------------------------------

def _random_bgps(rng, n: int):
    """Random 1-3 atom BGPs over 4 variables and constant slots (value 5)."""
    out = []
    for _ in range(n):
        pats = [tuple(int(rng.choice([-1, -2, -3, -4, 5])) for _ in range(3))
                for _ in range(int(rng.integers(1, 4)))]
        out.append(pats)
    return out


def test_shape_signature_and_plans_match_reference():
    rng = np.random.default_rng(0)
    planned = 0
    for pats in _random_bgps(rng, 200):
        sig, varmap = batched.shape_signature(pats)
        jsig, jvarmap = jbatched.shape_signature(pats)
        assert (sig, varmap) == (jsig, jvarmap)
        plan, jplan = batched.build_plan(sig), jbatched.build_plan(sig)
        assert (plan is None) == (jplan is None)
        if plan is not None:
            planned += 1
            assert [dataclasses.astuple(p) for p in plan.probes] == [
                dataclasses.astuple(p) for p in jplan.probes]
            assert (plan.n_consts, plan.var_order) == (jplan.n_consts, jplan.var_order)
    assert planned > 50


@pytest.fixture(scope="module")
def snapshots():
    """Bit-equal published snapshots of both engines on one store."""
    kw = dict(n_groups=3, group_size=3, n_spokes_per=2, n_plain=120,
              hierarchy_depth=2, chain_rules=True, seed=4)
    facts, prog, dic = generate(**kw)
    jfacts, jprog, _ = jgenerate(**kw)
    cap = 1 << 11
    caps = dict(capacity=cap, bind_cap=cap, out_cap=cap, rewrite_cap=cap)
    te = TorchEngine(dic.n_resources, device="cpu", **caps)
    je = JaxEngine(dic.n_resources, **caps)
    snap = te.publish_snapshot(te.materialise_state(facts, prog))
    jsnap = je.publish_snapshot(je.materialise_state(jfacts, jprog))
    for k in ("d_triples", "d_keys", "d_triples_pos", "d_keys_pos"):
        np.testing.assert_array_equal(getattr(snap, k).numpy(), np.asarray(getattr(jsnap, k)))
    assert snap.n_live == jsnap.n_live
    return snap, jsnap, dic


SIGS = [  # shapes of the serving workload, then joins with every probe form
    ((("v", 0), "c", ("v", 1)),),
    (("c", "c", ("v", 0)),),
    (("c", ("v", 0), ("v", 1)),),
    ((("v", 0), "c", "c"),),
    ((("v", 0), "c", ("v", 1)), (("v", 2), "c", ("v", 1))),
    ((("v", 0), "c", ("v", 1)), (("v", 1), "c", ("v", 2))),
    ((("v", 0), "c", ("v", 0)),),
    (("c", "c", ("v", 0)), (("v", 0), ("v", 1), "c")),
    ((("v", 0), "c", ("v", 1)), (("v", 0), "c", ("v", 1))),
    (("c", "c", "c"),),
]


@pytest.mark.parametrize("width", [16, 256])
@pytest.mark.parametrize("si", range(len(SIGS)))
def test_matcher_matches_reference_bgp_one(snapshots, si, width):
    """The explicit-batch matcher equals the reference's ``_bgp_one`` under
    ``jax.vmap`` on the same snapshot and constants: the same bound
    columns, validity and overflow flags, position by position (width 16
    overflows some queries)."""
    snap, jsnap, _ = snapshots
    sig = SIGS[si]
    plan, jplan = batched.build_plan(sig), jbatched.build_plan(sig)
    rng = np.random.default_rng(si)
    tri = snap.triples
    B = 12
    consts = np.zeros((B, plan.n_consts), np.int32)
    for b in range(B):
        row = tri[rng.integers(tri.shape[0])] if b % 4 else rng.integers(0, 40, 3)
        slot = 0
        for atom in sig:  # constants from a real row, at their positions
            for pos, t in enumerate(atom):
                if t == "c":
                    consts[b, slot] = row[pos]
                    slot += 1
    out, valid, overflow = batched._bgp(
        plan.probes, plan.var_order, width,
        snap.d_triples, snap.d_keys, snap.d_triples_pos, snap.d_keys_pos,
        torch.from_numpy(consts))
    with enable_x64():
        fn = jax.vmap(partial(jbatched._bgp_one, jplan.probes, jplan.var_order, width),
                      in_axes=(None, None, None, None, 0))
        jout, jvalid, joverflow = fn(jsnap.d_triples, jsnap.d_keys,
                                     jsnap.d_triples_pos, jsnap.d_keys_pos,
                                     jax.numpy.asarray(consts))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(joverflow))
    assert valid.any()


def test_batched_executor_matches_scalar_with_both_fallbacks(snapshots):
    """Queries in shape groups equal the scalar host path; a non-batchable
    shape and a short group stay on the host, and a width overflow is
    recomputed there (never truncated)."""
    snap, _, dic = snapshots
    tri = snap.triples
    ps = np.unique(tri[:, 1])
    queries = [Query([(-1, int(p), -2)], [], [-1, -2], False) for p in ps]
    queries += [Query([(int(s), int(p), -1)], [], [-1], False) for s, p, _ in tri[:20]]
    queries += [Query([(-1, -2, -3)], [], [-1, -2], False),  # no bound prefix
                Query([(-1, int(ps[0]), -1)], [], [-1], True)]  # a group of one
    for width, min_batch in ((4, 2), (4096, 2), (4096, 100)):
        bx = BatchedExecutor(width=width, min_batch=min_batch, max_batch=8)
        got = bx.run(queries, snap, dic)
        for q, g in zip(queries, got):
            assert g == evaluate_at(q, snap, dic)
        assert bx.stats["fallback"] >= 2
        if width == 4:
            assert bx.stats["overflow"] > 0 and bx.stats["batched"] > 0
        if min_batch == 100:
            assert bx.stats["batched"] == 0
