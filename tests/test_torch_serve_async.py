"""The serving tier's batched drain, publication and launch ledger
against the reference's (tests/test_serve_async_batched.py; the threaded
scheduler is in tests/test_torch_serve_threaded.py).

  * batched == scalar == the reference's answers == the from-scratch oracle
    at every epoch, across the reference's profiles, with the host
    fallbacks exercised;
  * ``publish_snapshot`` describes exactly the rows ``read_snapshot``
    copies, every array a new tensor;
  * ``dispatch_counts`` books launches per phase and per thread.

Tolerance: exact.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from serve_cases import (  # noqa: E402
    PROFILES, Oracle, both, caps, cpu_store, packset, same_snapshot, stores,
    trace,
)
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparql import Query  # noqa: E402
from repro_torch.sparql.batched import build_plan, shape_signature  # noqa: E402
from repro_torch.sparql.executor import evaluate_at  # noqa: E402


def _mixed_queries(facts, pdic, jdic, n, seed):
    """The reference's mixed list: generator shapes, a const-subject probe
    and an all-var atom (non-batchable), in both packages."""
    qs, jqs = trace(pdic, jdic, facts, facts, n_events=n, batch=4, p_query=1.0,
                    seed=seed)
    s0, p0 = int(facts[0, 0]), int(facts[0, 1])
    extra = [([(s0, p0, -1)], [-1]), ([(-1, -2, -3)], [-1, -2])]
    from repro.sparql import Query as JQuery

    return ([q for _, q in qs] + [Query(p, [], s, False) for p, s in extra],
            [q for _, q in jqs] + [JQuery(p, [], s, False) for p, s in extra])


@pytest.mark.parametrize("gen_kw, seed", [(kw, s) for _n, kw, s in PROFILES],
                         ids=[n for n, _kw, _s in PROFILES])
def test_batched_matches_scalar_reference_and_oracle_per_epoch(gen_kw, seed):
    (facts, prog, dic), (jf, jp, jd) = both("generate", **gen_kw, seed=seed)
    updates, jupdates = trace(dic, jd, facts, jf, n_events=3, batch=6, seed=seed)
    ts, js = stores(facts, prog, dic, jf, jp, jd)
    bx, jbx = ts._batched, js._batched
    queries, jqueries = _mixed_queries(facts, dic, jd, n=8, seed=seed + 1)
    oracle = Oracle(facts, prog, dic)
    done = []
    for ev in [None] + list(zip(updates, jupdates)):
        if ev is not None:
            (op, delta), (_, jdelta) = ev
            done.append(ts.submit_update(op, delta))
            js.submit_update(op, jdelta)
            ts.drain()
            js.drain()
            oracle.apply(done[-1:])
        snap, jsnap = ts.snapshot, js.snapshot
        same_snapshot(snap, jsnap, f"epoch {snap.epoch}")
        got = bx.run(queries, snap, dic)
        want = jbx.run(jqueries, jsnap, jd)
        for q, jq, (ans, ep), (jans, jep) in zip(queries, jqueries, got, want):
            assert (ans, ep) == (jans, jep) == evaluate_at(q, snap, dic)
            assert ans == oracle.answer(q, ep), f"epoch {ep} {q.patterns}"
    assert bx.stats == jbx.stats
    assert bx.stats["batched"] > 0 and bx.stats["fallback"] > 0


def test_non_batchable_and_short_groups_fall_back():
    (facts, prog, dic), (jf, jp, jd) = both(
        "generate", n_groups=1, group_size=3, n_spokes_per=1, n_plain=10,
        hierarchy_depth=0, seed=0)
    ts, _ = stores(facts, prog, dic, jf, jp, jd)
    bx = ts._batched
    sig, _ = shape_signature(Query([(-1, -2, -3)], [], [-1], False).patterns)
    assert build_plan(sig) is None
    q = Query([(-1, int(facts[0, 1]), -2)], [], [-1], False)
    (got,) = bx.run([q], ts.snapshot, dic)
    assert bx.stats["batched"] == 0 and bx.stats["fallback"] == 1
    assert got == evaluate_at(q, ts.snapshot, dic)


def test_batched_overflow_falls_back_to_host():
    (facts, prog, dic), (jf, jp, jd) = both(
        "generate", n_groups=2, group_size=3, n_spokes_per=2, n_plain=60,
        hierarchy_depth=1, seed=1)
    ts, js = stores(facts, prog, dic, jf, jp, jd, query_width=4, min_batch=2)
    ps = np.unique(np.asarray(facts)[:, 1])
    qs = [Query([(-1, int(p), -2)], [], [-1, -2], False) for p in ps[:4]]
    from repro.sparql import Query as JQuery

    jqs = [JQuery(q.patterns, [], q.select, False) for q in qs]
    got = ts._batched.run(qs, ts.snapshot, dic)
    assert ts._batched.stats["overflow"] > 0
    assert got == js._batched.run(jqs, js.snapshot, jd)
    for q, g in zip(qs, got):
        assert g == evaluate_at(q, ts.snapshot, dic)


def test_publish_snapshot_matches_read_snapshot():
    (facts, prog, dic), _ = both("generate", n_groups=2, group_size=3,
                                 n_spokes_per=2, n_plain=40, hierarchy_depth=1,
                                 seed=5)
    eng = TorchEngine(dic.n_resources, device="cpu", **caps())
    state = eng.materialise_state(facts, prog)
    dev = eng.publish_snapshot(state)
    host = eng.read_snapshot(state)
    assert dev.epoch == host.epoch and dev.on_device and not host.on_device
    assert packset(dev.triples) == packset(host.triples)
    assert (dev.rho.rep == host.rho.rep).all()
    n = dev.n_live
    keys, pos = dev.d_keys[:n].numpy(), dev.d_keys_pos[:n].numpy()
    assert (np.diff(keys) >= 0).all() and (np.diff(pos) >= 0).all()
    assert packset(dev.d_triples_pos[:n].numpy()) == packset(dev.triples)
    # every array is a tensor of its own, not a view of the state
    owned = {state.spo.untyped_storage().data_ptr(),
             state.sorted_keys.untyped_storage().data_ptr()}
    for k in ("d_triples", "d_keys", "d_triples_pos", "d_keys_pos"):
        assert getattr(dev, k).untyped_storage().data_ptr() not in owned
    assert set(eng.last_publish) == {"gather_ms", "sort_ms", "read_ms", "rho_ms"}


def test_tally_counts_per_thread_and_recording_counts_nowhere():
    before = dict(ops.LAUNCHES)
    seen = {}

    def worker():
        with ops.tally() as mine:
            ops.book({"prefix_range_bounds": 2})
        seen["worker"] = mine

    with ops.tally() as outer, ops.tally() as inner:
        ops.book({"dedup_order": 1})
        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
        assert not th.is_alive()
        with ops.recording() as rec:
            ops.book({"search_bounds": 5})
    assert outer == inner == {"dedup_order": 1}
    assert seen["worker"] == {"prefix_range_bounds": 2}
    assert rec == {"search_bounds": 5}
    assert ops.by_kernel({"prefix_range_bounds": 2, "search_bounds": 1}) == {
        "search_bounds": 3}
    assert ops.LAUNCHES["dedup_order"] == before["dedup_order"] + 1
    assert ops.LAUNCHES["search_bounds"] == before["search_bounds"] + 2


def test_launch_counts_lose_nothing_across_threads():
    """Eight threads book launches at once under a short switch interval:
    ``LAUNCHES`` gains every one, and each thread's tally holds exactly
    its own."""
    import sys

    n_threads, n_calls = 8, 2000
    before = ops.LAUNCHES["search_bounds"]
    tallies = [None] * n_threads

    def worker(i):
        with ops.tally() as mine:
            for _ in range(n_calls):
                ops.book({"prefix_range_bounds": 1, "search_bounds": 1})
        tallies[i] = mine

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert ops.LAUNCHES["search_bounds"] - before == 2 * n_threads * n_calls
    assert tallies == [{"prefix_range_bounds": n_calls, "search_bounds": n_calls}] * n_threads


@pytest.fixture
def counted(monkeypatch):
    """Every plain version of a kernel books a launch, as the kernel's
    wrapper does on the card, so the ledger can be read on the CPU."""
    for name in ("dedup_order", "search_bounds", "prefix_range_bounds",
                 "rewrite_triples"):
        plain = getattr(ops.ref, name)

        def counting(*a, _n=name, _f=plain, **k):
            ops.book({_n: 1})
            return _f(*a, **k)

        monkeypatch.setattr(ops.ref, name, counting)


@pytest.mark.parametrize("threaded", [False, True])
def test_dispatch_counts_by_phase(counted, threaded):
    """Launches land under the phase that made them in the launch ledger:
    maintenance steps by the label they reached, publication and queries
    apart, per thread (queries never sort, publication never probes).  The
    dispatch ledger of the same store reconciles with the static phase
    profile."""
    (facts, prog, dic), (jf, jp, jd) = both(
        "generate", n_groups=2, group_size=3, n_spokes_per=1, n_plain=20,
        hierarchy_depth=1, seed=3)
    tr, _ = trace(dic, jd, facts, jf, n_events=3, batch=4, seed=3)
    queries, _ = _mixed_queries(facts, dic, jd, n=6, seed=4)
    store = cpu_store(facts, prog, dic, threaded=threaded)
    try:
        for op, delta in tr:
            store.submit_update(op, delta)
            for q in queries:
                store.submit_query(q)
            store.drain()
        dc = store.launch_counts
        problems = store.audit()
    finally:
        store.close()
    by_phase = dc["by_phase"]
    assert dc["total"] == sum(dc["by_family"].values()) > sum(by_phase.values())
    assert by_phase.get("query/prefix_range_bounds", 0) > 0
    assert by_phase.get("publish/dedup_order", 0) == len(tr) + 1
    assert not any(k.startswith("query/") and "prefix" not in k for k in by_phase)
    assert not any(k.startswith("publish/") and "dedup" not in k for k in by_phase)
    ops_seen = {k.split("/")[0] for k in by_phase}
    for op, _ in tr:
        assert f"{op}:forward" in ops_seen
    assert dc["compiles_by_family"] == {}  # no graph on the CPU
    assert problems == []


@pytest.mark.parametrize("threaded", [False, True])
def test_triple_store_dispatch_counts_and_audit(threaded):
    """The reference's store ledger case: after a mixed add/delete/query
    stream the dispatch ledger reconciles with the static phase profile,
    every ``by_phase`` key is ``"<tag>/<family>"`` with a tag of that
    profile, and the batched drains count under ``"query"``."""
    from repro_torch.core.incremental_spmd import static_dispatch_profile
    from repro_torch.data.generator import generate, sample_update_stream

    facts, prog, dic = generate(n_groups=2, group_size=3, n_spokes_per=1,
                                n_plain=25, hierarchy_depth=1, seed=2)
    store = cpu_store(facts, prog, dic, threaded=threaded)
    try:
        for op, payload in sample_update_stream(facts, dic, n_events=6, batch=5,
                                                p_query=0.5, seed=2):
            if op == "query":
                for q in [payload] * 2:  # a shape group of two: batched
                    store.submit_query(q)
            else:
                store.submit_update(op, payload)
            store.drain()
        assert store.audit() == []
        d = store.dispatch_counts
    finally:
        store.close()
    profile = static_dispatch_profile(prog)
    assert d["total"] > 0 and d["by_family"]
    assert d["by_phase"] and sum(d["by_phase"].values()) <= d["total"]
    for key in d["by_phase"]:
        tag, fam = key.rsplit("/", 1)
        assert fam in profile[tag], key
    tags = {key.rsplit("/", 1)[0] for key in d["by_phase"]}
    assert {"publish", "add:forward", "delete:seed"} <= tags, tags
    assert d["compiles_by_family"] == {}  # no graph on the CPU
