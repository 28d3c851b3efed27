"""The serving tier's threaded scheduler against the reference's
(tests/test_serve_async_batched.py): a ``threaded=True`` store
(maintenance on the worker thread, reads racing it from this thread) lands
every answer on the reference's answer at its epoch and on the
from-scratch oracle, publishes snapshots bit-equal to the reference's
epoch by epoch, leaves every published snapshot as it was, and ends where
the cooperative scheduler ends, on the reference's threaded case and its
trace profiles; ``step`` is refused, a failed update surfaces on the
caller and rolls the state back.  Tolerance: exact.
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
    PROFILES, Oracle, Published, both, caps, cpu_store, packset, same_snapshot,
    small_case, stores, trace,
)
from repro.sparql.executor import evaluate_at as jevaluate_at  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.serve import TripleStore  # noqa: E402


# the reference's threaded case, then its trace profiles
THREADED = [("threaded_basic", dict(n_groups=2, group_size=3, n_spokes_per=1,
                                    n_plain=20, hierarchy_depth=1), 11, 8, 6)]
THREADED += [(n, kw, s, 6, 8) for n, kw, s in PROFILES]


@pytest.mark.parametrize("gen_kw, seed, n_events, batch",
                         [case[1:] for case in THREADED], ids=[c[0] for c in THREADED])
def test_threaded_trace_matches_reference_oracle_and_cooperative(gen_kw, seed,
                                                                 n_events, batch):
    (facts, prog, dic), (jf, jp, jd) = both("generate", **gen_kw, seed=seed)
    tr, jtr = trace(dic, jd, facts, jf, n_events=n_events, batch=batch,
                    p_query=0.5, seed=seed)
    jstore = stores(facts, prog, dic, jf, jp, jd)[1]
    jpub = Published(jstore)
    store_t = TripleStore(facts, prog, dic, device="cpu", threaded=True,
                          engine=TorchEngine(dic.n_resources, device="cpu", **caps()))
    pub = Published(store_t, clone=True)
    rng = np.random.default_rng(seed)
    updates, queries = [], []
    try:
        for (op, payload), (_, jpayload) in zip(tr, jtr):
            if op == "query":
                queries.append((store_t.submit_query(payload), jpayload))
            else:
                updates.append(store_t.submit_update(op, payload))
                jstore.submit_update(op, jpayload)
            if rng.random() < 0.6:  # race reads against in-flight epochs
                store_t._drain_queries()
        store_t.drain()
        jstore.drain()
        assert all(t.status == "done" for t in updates + [q for q, _ in queries])
        assert store_t.epoch == jstore.epoch == len(updates)
        assert [t.epoch for t in updates] == list(range(1, len(updates) + 1))
        for i, (a, b) in enumerate(zip(pub.snaps, jpub.snaps)):
            same_snapshot(a, b, f"snapshot {i}")
        assert len(pub.snaps) == len(jpub.snaps) == len(updates) + 1
        pub.assert_unchanged()
        oracle = Oracle(facts, prog, dic)
        oracle.apply(updates)
        for t, jq in queries:
            jans, _ = jevaluate_at(jq, jpub.snaps[t.epoch], jd)
            assert t.answer == jans == oracle.answer(t.query, t.epoch)

        store_c = TripleStore(facts, prog, dic, device="cpu",
                              engine=TorchEngine(dic.n_resources, device="cpu", **caps()))
        for op, payload in tr:
            if op == "query":
                store_c.submit_query(payload)
            else:
                store_c.submit_update(op, payload)
        store_c.drain()
        assert store_c.epoch == store_t.epoch
        same_snapshot(store_t.snapshot, store_c.snapshot)
    finally:
        store_t.close()


def test_threaded_step_forbidden_and_close_idempotent():
    facts, prog, dic = small_case()
    with cpu_store(facts, prog, dic, threaded=True) as s:
        with pytest.raises(RuntimeError):
            s.step()
        t = s.submit_update("delete", facts[:1])
        s.drain()
        assert t.status == "done" and s.epoch == 1
    s.close()


def test_threaded_failed_update_surfaces_on_caller():
    facts, prog, dic = small_case()
    store = cpu_store(facts, prog, dic, threaded=True)
    try:
        orig, tripped = store._make_gen, []

        def boom(t):
            if not tripped:
                tripped.append(True)
                raise RuntimeError("injected maintenance failure")
            return orig(t)

        store._make_gen = boom
        t = store.submit_update("delete", facts[:1])
        with pytest.raises(RuntimeError, match="injected"):
            store.drain()
        assert t.status == "failed"
        t2 = store.submit_update("delete", facts[:1])  # worker survived
        store.drain()
        assert t2.status == "done" and store.epoch == 1
    finally:
        store.close()


def test_failed_update_mid_phase_rolls_back():
    """A threaded update that dies after its first phase rolls the live
    state back to its snapshot; the retried update then lands as if the
    failed one never ran."""
    facts, prog, dic = small_case()
    store = cpu_store(facts, prog, dic, threaded=True)
    clean = cpu_store(facts, prog, dic)
    try:
        orig, tripped = store._make_gen, []

        def dies_after_first_phase(t):
            gen = orig(t)
            if tripped:
                return gen
            tripped.append(True)

            def wrapped():
                yield next(gen)
                next(gen)  # runs the next phase on the live state
                raise RuntimeError("injected mid-phase failure")
            return wrapped()

        store._make_gen = dies_after_first_phase
        delta = facts[:2]
        store.submit_update("delete", delta)
        with pytest.raises(RuntimeError, match="mid-phase"):
            store.drain()
        assert store.epoch == 0 and store.inflight is None
        store.submit_update("delete", delta)
        store.drain()
        clean.submit_update("delete", delta)
        clean.drain()
        same_snapshot(store.snapshot, clean.snapshot)
        assert packset(store.engine.state_triples(store.state)) == packset(
            clean.engine.state_triples(clean.state))
    finally:
        store.close()
