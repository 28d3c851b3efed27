"""The serving tier's cooperative scheduler against the reference's.

``repro_torch.serve.TripleStore`` (on a CPU ``TorchEngine``) and
``repro.serve.triple_store.TripleStore`` (on ``JaxEngine``) take the same
mixed trace under the same tick schedule: every ticket's epoch and answer
bag are equal, and equal to the from-scratch oracle at that epoch; every
published snapshot (four device arrays over their padded length, ``n_live``,
rho) is bit-equal; and no published snapshot changes after its
publication (the port's engine writes its state in place).  Then the
reference's scheduled edge cases (tests/test_serve_triple_store.py) on the
port's store.  Tolerance: exact.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from serve_cases import (  # noqa: E402
    FUZZ_COMBOS, PROFILES, Published, both, packset, run_trace, same_snapshot,
    stores,
)
from repro_torch.core.materialise import materialise_rew  # noqa: E402
from repro_torch.core.triples import apply_op  # noqa: E402
from repro_torch.sparql import Query, evaluate  # noqa: E402


@pytest.mark.parametrize("gen_kw, seed", [(kw, s) for _n, kw, s in PROFILES],
                         ids=[n for n, _kw, _s in PROFILES])
def test_differential_consistency(gen_kw, seed):
    run_trace(gen_kw, seed=seed, n_events=6, batch=8, ticks_seed=seed)


@pytest.mark.parametrize("gen_kw, seed, n_events, batch, ticks_seed", FUZZ_COMBOS,
                         ids=["serve_basic", "serve_dense"])
def test_fuzz_fallback_schedules(gen_kw, seed, n_events, batch, ticks_seed):
    run_trace(gen_kw, seed, n_events, batch, ticks_seed)


def _spoke_case():
    return both("generate", n_groups=1, group_size=4, n_spokes_per=3,
                n_plain=0, hierarchy_depth=0, seed=0)


@pytest.mark.parametrize("phase", ["overdeleted", "rederive"])
def test_query_admitted_mid_delete_reads_published_snapshot(phase):
    """A query admitted after the overdelete wave finalises, or at the
    targeted-rederive phase, is answered at the previous epoch's
    fixpoint, as the reference's is, though the live arena hides rows the
    rederivation will restore."""
    (facts, prog, dic), (jf, jp, jd) = _spoke_case()
    ts, js = stores(facts, prog, dic, jf, jp, jd)
    spoke = dic.id_of(":spoke")
    q = Query([(-1, spoke, -2)], [], [-1], False)
    baseline = ts.query_now(q)
    assert baseline.epoch == 0 and sum(baseline.answer.values()) > 0
    assert baseline.answer == js.query_now(q).answer

    edge = facts[np.flatnonzero(facts[:, 1] == dic.id_of(":idProp"))[:1]]
    t = ts.submit_update("delete", edge)
    js.submit_update("delete", edge)
    ticks = 0
    while ts.inflight_phase != phase:
        ts.step()
        js.step()
        assert ts.inflight_phase == js.inflight_phase
        ticks += 1
        assert ticks < 100, f"never reached the {phase} phase"
    assert t.status == "running"
    if phase == "overdeleted":
        live = ts.engine.state_triples(ts.state)
        assert packset(live) < packset(ts.snapshot.triples)
        assert evaluate(q, live, ts.engine.state_rep(ts.state), dic) != baseline.answer
    mid = ts.submit_query(q)
    ts.step()
    assert mid.status == "done" and mid.epoch == 0
    assert mid.answer == baseline.answer

    ts.drain()
    js.drain()
    same_snapshot(ts.snapshot, js.snapshot)
    after = ts.query_now(q)
    assert after.epoch == 1
    ref = materialise_rew(apply_op(facts, "delete", edge), prog, dic.n_resources)
    assert after.answer == evaluate(q, ref.triples(), ref.rep, dic)


def test_split_then_query_old_representative_expands_post_split():
    (facts, prog, dic), (jf, jp, jd) = both("clique", n=6)
    ts, js = stores(facts, prog, dic, jf, jp, jd, cap=256)
    sa = dic.id_of("owl:sameAs")
    a = [dic.id_of(f":a{i}") for i in range(6)]
    q_old_rep = Query([(-1, sa, a[0])], [], [-1], False)
    assert ts.query_now(q_old_rep).answer == {(f":a{i}",): 1 for i in range(6)}

    ts.submit_update("delete", facts[2:3])  # a2 ~ a3 -> {a0,a1,a2}|{a3,a4,a5}
    js.submit_update("delete", facts[2:3])
    ts.drain()
    js.drain()
    same_snapshot(ts.snapshot, js.snapshot)
    post = ts.query_now(q_old_rep)
    assert post.epoch == 1
    assert post.answer == {(":a0",): 1, (":a1",): 1, (":a2",): 1}
    q_new_rep = Query([(-1, sa, a[4])], [], [-1], False)
    assert ts.query_now(q_new_rep).answer == {(":a3",): 1, (":a4",): 1, (":a5",): 1}


def test_snapshot_isolated_from_maintenance_and_noop_epochs():
    """An old snapshot is bytewise what it was at publication after later
    updates on the same store (the port's engine writes its arena and
    index in place); no-op updates still cross an epoch barrier."""
    (facts, prog, dic), (jf, jp, jd) = both("clique", n=5)
    ts, js = stores(facts, prog, dic, jf, jp, jd, cap=256)
    pub = Published(ts, clone=True)
    snap0 = ts.snapshot
    before = packset(snap0.triples)

    for store in (ts, js):
        store.submit_update("delete", facts[1:2])
        store.drain()
    assert ts.epoch == 1 and ts.snapshot is not snap0
    assert packset(snap0.triples) == before
    assert not snap0.rho.rep.flags.writeable
    for store in (ts, js):
        store.submit_update("add", facts[1:2])
        store.drain()
    pub.assert_unchanged()

    t = ts.submit_update("delete", np.asarray([[9, 9, 9]], np.int32))
    js.submit_update("delete", np.asarray([[9, 9, 9]], np.int32))
    ts.drain()
    js.drain()
    assert t.status == "done" and t.epoch == 3 and ts.epoch == 3
    assert packset(ts.snapshot.triples) == packset(ts.engine.state_triples(ts.state))
    same_snapshot(ts.snapshot, js.snapshot)
    pub.assert_unchanged()


def test_query_constant_unseen_at_serving_epoch():
    (facts, prog, dic), (jf, jp, jd) = both("clique", n=4)
    ts, _ = stores(facts, prog, dic, jf, jp, jd, cap=256)
    sa = dic.id_of("owl:sameAs")
    fresh = dic.intern(":arrives-later")
    assert fresh >= ts.snapshot.n_res
    q = Query([(-1, sa, fresh)], [], [-1], False)
    ts.submit_update("add", np.asarray([[fresh, sa, dic.id_of(":a0")]], np.int32))
    early = ts.submit_query(q)
    ts.step()
    assert early.status == "done" and early.epoch == 0
    assert early.answer == {}
    ts.drain()
    late = ts.query_now(q)
    assert late.epoch == 1
    assert late.answer == {(":a0",): 1, (":a1",): 1, (":a2",): 1, (":a3",): 1,
                           (":arrives-later",): 1}


def test_mixed_trace_generator_shapes():
    from serve_cases import trace

    (facts, _prog, dic), (jf, _jp, jd) = both("clique", n=4)
    upd, _ = trace(dic, jd, facts, jf, n_events=4, batch=4, seed=0)
    assert all(op in ("add", "delete") for op, _ in upd)
    qs, _ = trace(dic, jd, facts, jf, n_events=4, batch=4, p_query=1.0, seed=0)
    assert all(op == "query" for op, _ in qs)
    for _op, q in qs:
        assert isinstance(q, Query) and q.select
        assert all(len(atom) == 3 for atom in q.patterns)
