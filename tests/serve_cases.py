"""Shared by the serving-tier differential tests: both packages' stores on
the same trace, the snapshot comparison, the from-scratch oracle and the
cases.

The reference side is ``repro.serve.triple_store.TripleStore`` on
``JaxEngine`` under the jax 0.9 shim (set by the importing test module
before it imports this one); the port's is
``repro_torch.serve.TripleStore`` on a CPU ``TorchEngine`` at the same
caps.  Both packages' generators make the same facts and events (checked
here), each with its own dictionary and ``Query`` objects.
"""

import numpy as np
import torch

from repro.core.engine_jax import JaxEngine
from repro.data.datasets import single_clique as jsingle_clique
from repro.data.generator import generate as jgenerate
from repro.data.generator import sample_update_stream as jsample
from repro.serve.triple_store import TripleStore as JStore
from repro_torch.core.engine import TorchEngine
from repro_torch.core.materialise import materialise_rew
from repro_torch.core.triples import apply_op, pack
from repro_torch.data.datasets import single_clique
from repro_torch.data.generator import generate, sample_update_stream
from repro_torch.serve import TripleStore
from repro_torch.sparql import evaluate

SNAP_ARRAYS = ("d_triples", "d_keys", "d_triples_pos", "d_keys_pos")

# the profiles of tests/test_serve_triple_store.py (_TRACE_PROFILES) and
# tests/test_serve_async_batched.py (_PROFILES): the same three
PROFILES = [
    ("chain_like", dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=20,
                        hierarchy_depth=1, chain_rules=True), 3),
    ("clique_like", dict(n_groups=2, group_size=5, n_spokes_per=2, n_plain=10,
                         hierarchy_depth=1), 5),
    ("dbpedia_like", dict(n_groups=2, group_size=3, n_spokes_per=2, n_plain=60,
                          hierarchy_depth=2, chain_rules=True), 7),
]
# the seeded fuzz combos of tests/test_serve_triple_store.py
FUZZ_COMBOS = [
    (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=15,
          hierarchy_depth=1), 19, 5, 6, 23),
    (dict(n_groups=1, group_size=4, n_spokes_per=2, n_plain=5,
          hierarchy_depth=0), 29, 6, 5, 31),
]


def caps(cap: int = 1 << 11) -> dict:
    return dict(capacity=cap, bind_cap=cap, out_cap=cap, rewrite_cap=cap)


def stores(facts, prog, dic, jfacts, jprog, jdic, cap: int = 1 << 11, **kw):
    """The port's store and the reference's on the same facts and caps."""
    ts = TripleStore(facts, prog, dic, device="cpu",
                     engine=TorchEngine(dic.n_resources, device="cpu", **caps(cap)),
                     **kw)
    js = JStore(jfacts, jprog, jdic, engine=JaxEngine(jdic.n_resources, **caps(cap)),
                **kw)
    return ts, js


def both(kind: str, **kw):
    """``(port (facts, program, dic), reference (facts, program, dic))`` of
    ``generate`` (kind "generate") or ``single_clique`` (kind "clique")."""
    if kind == "clique":
        a, b = single_clique(kw["n"]), jsingle_clique(kw["n"])
    else:
        a, b = generate(**kw), jgenerate(**kw)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2].n_resources == b[2].n_resources
    return a, b


def trace(pdic, jdic, facts, jfacts, **kw):
    """Both packages' ``sample_update_stream`` on the same arguments,
    checked equal: the same ops, deltas and queries."""
    got = sample_update_stream(facts, pdic, **kw)
    want = jsample(jfacts, jdic, **kw)
    assert [op for op, _ in got] == [op for op, _ in want]
    for (op, a), (_, b) in zip(got, want):
        if op == "query":
            assert (a.patterns, a.steps, a.select, a.distinct) == (
                b.patterns, b.steps, b.select, b.distinct)
        else:
            np.testing.assert_array_equal(a, b)
    assert pdic.n_resources == jdic.n_resources
    return got, want


def same_snapshot(ps, js, tag: str = "") -> None:
    """The port's published snapshot equals the reference's bit for bit:
    the four device arrays over their whole padded length, ``n_live``,
    the epoch and rho."""
    assert (ps.epoch, ps.n_live, ps.on_device) == (js.epoch, js.n_live, js.on_device), tag
    for k in SNAP_ARRAYS:
        want = np.asarray(getattr(js, k))
        got = getattr(ps, k).numpy()
        assert got.dtype == want.dtype, f"{tag} {k}"
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {k}")
    np.testing.assert_array_equal(ps.rho.rep, js.rho.rep, err_msg=f"{tag} rho")
    np.testing.assert_array_equal(ps.triples, np.asarray(js.triples),
                                  err_msg=f"{tag} triples")


class Published:
    """Records every snapshot a store publishes after it was made (the
    first is the construction's), with clones of the port's device arrays
    taken at publication."""

    def __init__(self, store, clone: bool = False) -> None:
        self.snaps = [store.snapshot]
        self.clones = [self._clone(store.snapshot)] if clone else None
        inner = store._publish

        def publish():
            snap = inner()
            self.snaps.append(snap)
            if clone:
                self.clones.append(self._clone(snap))
            return snap

        store._publish = publish

    @staticmethod
    def _clone(snap) -> dict:
        out = {k: getattr(snap, k).clone() for k in SNAP_ARRAYS}
        out["rep"] = snap.rho.rep.copy()
        return out

    def assert_unchanged(self, tag: str = "") -> None:
        """Every recorded snapshot is bytewise what it was at publication."""
        for i, (snap, c) in enumerate(zip(self.snaps, self.clones)):
            for k in SNAP_ARRAYS:
                assert torch.equal(getattr(snap, k), c[k]), f"{tag} snapshot {i} {k}"
            np.testing.assert_array_equal(snap.rho.rep, c["rep"])


class Oracle:
    """Explicit-set bookkeeping and from-scratch answers per completed
    epoch: the port's numpy ``materialise_rew`` of the explicit set at
    that epoch, then ``evaluate``."""

    def __init__(self, facts, program, dic):
        self.program, self.dic = program, dic
        self.explicit_at = {0: np.asarray(facts, np.int32)}
        self._mat = {}

    def apply(self, tickets) -> None:
        for t in sorted(tickets, key=lambda t: t.epoch):
            prev = self.explicit_at[t.epoch - 1]
            self.explicit_at[t.epoch] = apply_op(prev, t.op, t.delta)

    def mat(self, epoch):
        if epoch not in self._mat:
            self._mat[epoch] = materialise_rew(
                self.explicit_at[epoch], self.program, self.dic.n_resources)
        return self._mat[epoch]

    def answer(self, q, epoch):
        ref = self.mat(epoch)
        return evaluate(q, ref.triples(), ref.rep, self.dic)


def packset(spo) -> set:
    return set(pack(np.asarray(spo, np.int32).reshape(-1, 3)).tolist())


def run_trace(gen_kw, seed, n_events, batch, ticks_seed, cap: int = 1 << 11):
    """A mixed trace through both stores under the same randomized tick
    pattern (the reference's ``_run_trace``): every ticket's epoch and
    answer equal the reference's and the oracle's, every published
    snapshot equals the reference's, and no published snapshot changed
    after its publication.  Returns the port's store and its tickets."""
    (facts, prog, dic), (jf, jp, jd) = both("generate", **gen_kw, seed=seed)
    kw = dict(n_events=n_events, batch=batch, p_query=0.5, seed=seed)
    tr, jtr = trace(dic, jd, facts, jf, **kw)
    if not any(op == "query" for op, _ in tr):
        extra = trace(dic, jd, facts, jf, n_events=1, batch=1, p_query=1.0,
                      seed=seed + 1)
        tr.append(extra[0][0])
        jtr.append(extra[1][0])
    ts, js = stores(facts, prog, dic, jf, jp, jd, cap)
    pub, jpub = Published(ts, clone=True), Published(js)
    rng = np.random.default_rng(ticks_seed)
    updates, queries, jqueries = [], [], []
    for (op, payload), (_, jpayload) in zip(tr, jtr):
        if op == "query":
            queries.append(ts.submit_query(payload))
            jqueries.append(js.submit_query(jpayload))
        else:
            updates.append(ts.submit_update(op, payload))
            js.submit_update(op, jpayload)
        for _ in range(int(rng.integers(0, 3))):
            ts.step()
            js.step()
            assert ts.inflight_phase == js.inflight_phase
    ts.drain()
    js.drain()
    assert all(t.status == "done" for t in updates + queries)
    assert ts.epoch == js.epoch == len(updates)
    assert len(pub.snaps) == len(jpub.snaps) == len(updates) + 1
    for i, (a, b) in enumerate(zip(pub.snaps, jpub.snaps)):
        same_snapshot(a, b, f"snapshot {i}")
    pub.assert_unchanged()
    oracle = Oracle(facts, prog, dic)
    oracle.apply(updates)
    ref = oracle.mat(ts.epoch)
    assert packset(ts.snapshot.triples) == packset(ref.triples())
    assert (ts.snapshot.rho.rep[: ref.rep.shape[0]] == ref.rep).all()
    for t, jt in zip(queries, jqueries):
        assert (t.epoch, t.answer) == (jt.epoch, jt.answer), f"query {t.uid}"
        assert t.answer == oracle.answer(t.query, t.epoch), f"query {t.uid}"
    assert ts._batched.stats == js._batched.stats
    return ts, queries


def small_case():
    """The reference's small case of its scheduler tests (port side)."""
    return both("generate", n_groups=1, group_size=3, n_spokes_per=1, n_plain=5,
                hierarchy_depth=0, seed=0)[0]


def cpu_store(facts, prog, dic, **kw):
    return TripleStore(facts, prog, dic, device="cpu",
                       engine=TorchEngine(dic.n_resources, device="cpu", **caps()), **kw)
