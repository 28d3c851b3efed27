"""Shared by the incremental differential tests: the reference's update
driver, the state comparison, the from-scratch check and the cases.

The reference side is ``JaxEngine`` under the jax 0.9 shim (set by the
importing test module before it imports this one).  Its updates run through
:func:`ref_update`, which is ``JaxEngine._apply_update`` with the phase
generator iterated here, so the reference's yield labels are recorded; the
port records its own in ``TorchEngine.last_split["phases"]``.
"""

import numpy as np
from jax.experimental import enable_x64

from repro.core import incremental_spmd as jinc
from repro.core import rules as jrules
from repro.core.engine_jax import CapacityError as RefCapacityError
from repro.core.engine_jax import JaxEngine
from repro.core.materialise import Contradiction as RefContradiction
from repro.core.triples import pack
from repro.data.generator import PROFILES as JPROFILES
from repro.data.generator import generate as jgenerate
from repro.data.generator import sample_update_stream as jsample
from repro_torch.core import rules
from repro_torch.core.engine import Contradiction, TorchEngine, state_to_arrays
from repro_torch.core.terms import DIFFERENT_FROM, SAME_AS
from repro_torch.core.triples import apply_op
from repro_torch.data.generator import PROFILES, generate, sample_update_stream

ARRAYS = ("spo", "epoch", "marked", "tomb", "n_used", "rep", "sort_perm",
          "sorted_keys")
# every counter both packages book but the wall and the host arena bytes
# (and triples_unmarked, which a read of the store sets, not an update);
# the retry counters are compared net of the base run (the port's base run
# books its restarts, the reference's none)
SKIP = ("mode", "wall_seconds", "memory_bytes", "contradiction",
        "triples_unmarked", "capacity_retries", "wide_growth_restarts")

# the profile shapes of tests/test_fused.py's _COMBOS
COMBOS = {
    "clique_ish": (dict(n_groups=1, group_size=5, n_spokes_per=2, n_plain=8,
                        hierarchy_depth=0), 3),
    "chain_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=25,
                       hierarchy_depth=3), 5),
    "dbpedia_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=30,
                         hierarchy_depth=1, chain_rules=True), 7),
    "uobm_ish": (dict(n_groups=2, group_size=3, n_spokes_per=1, n_plain=15,
                      hierarchy_depth=1, hometown_groups=1, hometown_size=5), 9),
}
PROFILE_CUTS = {
    "claros_small": ("claros_like", dict(n_groups=6, n_plain=100)),
    "merge_like": ("merge_like", dict(n_groups=8, n_plain=80)),
}
PROBE = dict(n_groups=4, group_size=3, n_spokes_per=1, n_plain=40,
             hierarchy_depth=1, seed=0)

N_RES = 9
CONSTS = list(range(3, N_RES))
PREDS = CONSTS + [SAME_AS]
VARS = [-1, -2]


def _random_stream(seed: int):
    """A random program of tests/test_torch_fused.py's shape (up to 2 rules
    of 1-2 atoms over 6 constants, 2 variables and sameAs, differentFrom in
    heads), 8 facts, and 4 events: random adds of 3 triples and deletes
    of half the explicit set."""
    rng = np.random.default_rng(200 + seed)

    def triples(n):
        return np.asarray([(rng.choice(CONSTS), rng.choice(PREDS), rng.choice(CONSTS))
                           for _ in range(n)], np.int32)

    facts = triples(8)
    spec = []
    for _ in range(rng.integers(1, 3)):
        body = tuple(
            (int(rng.choice(CONSTS + VARS)), int(rng.choice(PREDS)),
             int(rng.choice(CONSTS + VARS)))
            for _ in range(rng.integers(1, 3))
        )
        body_vars = [t for a in body for t in a if t < 0]
        so = CONSTS + body_vars if body_vars else CONSTS
        spec.append(((int(rng.choice(so)), int(rng.choice(PREDS + [DIFFERENT_FROM])),
                      int(rng.choice(so))), body))
    events, cur = [], facts
    for i in range(4):
        if i % 2:
            cur_u = np.unique(cur, axis=0)
            pick = rng.choice(cur_u.shape[0], max(cur_u.shape[0] // 2, 1), replace=False)
            delta = cur_u[pick]
            events.append(("delete", delta))
            cur = apply_op(cur, "delete", delta)
        else:
            delta = triples(3)
            events.append(("add", delta))
            cur = apply_op(cur, "add", delta)
    return facts, facts, spec, N_RES, events


def case(name: str, n_events: int = 4, batch: int | None = None,
         seed: int | None = None):
    """``(facts, ref facts, rule spec, n_resources, events)``: both packages'
    generators make the same facts and events (checked here).  The probe's
    stream (batch 8, seed 0) adds, deletes, adds and deletes; the others'
    (batch 6, seed 1) add once and delete three times."""
    dflt = (8, 0) if name == "probe" else (6, 1)
    batch = dflt[0] if batch is None else batch
    seed = dflt[1] if seed is None else seed
    if name.startswith("random"):
        return _random_stream(int(name.split("-")[1]))
    if name == "probe":
        kw, gen_seed = dict(PROBE), None
        facts, program, dic = generate(**kw)
        jfacts, _, jdic = jgenerate(**kw)
    elif name in COMBOS:
        kw, gen_seed = COMBOS[name]
        facts, program, dic = generate(**kw, seed=gen_seed)
        jfacts, _, jdic = jgenerate(**kw, seed=gen_seed)
    else:
        base, cut = PROFILE_CUTS[name]
        facts, program, dic = generate(**dict(PROFILES[base], **cut))
        jfacts, _, jdic = jgenerate(**dict(JPROFILES[base], **cut))
    np.testing.assert_array_equal(facts, jfacts)
    events = sample_update_stream(facts, dic, n_events=n_events, batch=batch, seed=seed)
    jevents = jsample(jfacts, jdic, n_events=n_events, batch=batch, seed=seed)
    assert [op for op, _ in events] == [op for op, _ in jevents]
    for (_, d), (_, jd) in zip(events, jevents):
        np.testing.assert_array_equal(d, jd)
    assert dic.n_resources == jdic.n_resources
    return facts, jfacts, [(r.head, r.body) for r in program.rules], dic.n_resources, events


def programs(spec):
    return (rules.Program([rules.Rule(h, b) for h, b in spec]),
            jrules.Program([jrules.Rule(h, b) for h, b in spec]))


def ref_update(eng: JaxEngine, state, op: str, delta, max_rounds: int = 10_000):
    """``JaxEngine._apply_update`` with the phase generator iterated here:
    the same rollback and retry, and the yield labels of the last attempt."""
    phases = jinc.spmd_add_phases if op == "add" else jinc.spmd_delete_phases
    eng._maybe_reset_fallback(state)
    while True:
        snap = eng._snapshot(state)
        try:
            eng._set_update_buffers(True)
            with enable_x64():
                labels = list(phases(eng, state, delta, max_rounds))
            break
        except RefCapacityError as e:
            eng._recover_capacity(state, snap, e)
    eng._barrier(state)
    return labels


def explicit_set(rows) -> set:
    return set(pack(np.asarray(rows, np.int32).reshape(-1, 3)).tolist())


def assert_same_state(ts, js, base_retries: int, tag: str = "") -> None:
    """The port's state equals the reference's: the eight arrays, the
    explicit set, the program, the round counter and every counter."""
    arrays = state_to_arrays(ts)
    for k in ARRAYS:
        want = np.asarray(getattr(js, k))
        np.testing.assert_array_equal(arrays[k].reshape(want.shape), want,
                                      err_msg=f"{tag} {k}")
    assert explicit_set(TorchEngine.explicit_rows(ts)) == explicit_set(js.explicit), tag
    assert ([(r.head, r.body) for r in ts.program.rules]
            == [(r.head, r.body) for r in js.program.rules]), tag
    assert (ts.r, ts.update_epoch, ts.index_dirty) == (js.r, js.update_epoch,
                                                       js.index_dirty), tag
    got, want = ts.stats.as_dict(), js.stats.as_dict()
    for k in got:
        if k not in SKIP:
            assert got[k] == want[k], f"{tag} {k}: {got[k]} != {want[k]}"
    assert got["capacity_retries"] - base_retries == want["capacity_retries"], tag
    assert got["wide_growth_restarts"] == want["wide_growth_restarts"], tag


def assert_from_scratch(te: TorchEngine, ts, n_res: int, program, tag: str = "") -> None:
    """The reference's own oracle: the state equals a from-scratch run of
    its explicit set, the same rho and normal-form store."""
    explicit = TorchEngine.explicit_rows(ts)
    fresh = TorchEngine(ts.n_res, device="cpu", capacity=te.capacity,
                        bind_cap=te.bind_cap, out_cap=te.out_cap,
                        rewrite_cap=te.rewrite_cap)
    spo, rep, _ = fresh.materialise(explicit, program)
    np.testing.assert_array_equal(te.state_rep(ts), rep, err_msg=tag)
    assert explicit_set(te.state_triples(ts)) == explicit_set(spo), tag


def run_stream(name: str, caps: int = 1 << 9, **engine_kw):
    """Both engines through one case's base run and events.  Yields, after
    the base run and after each event, ``(tag, port engine, port state,
    ref state, port base retries, port labels, ref labels, program)``;
    a Contradiction of both ends the stream (``"contradiction"`` tag)."""
    facts, jfacts, spec, n_res, events = case(name)
    prog, jprog = programs(spec)
    kw = dict(capacity=caps, bind_cap=caps, out_cap=caps, rewrite_cap=caps, **engine_kw)
    je = JaxEngine(n_res, **kw)
    te = TorchEngine(n_res, device="cpu", **kw)
    try:
        js = je.materialise_state(jfacts, jprog)
    except RefContradiction:
        try:
            te.materialise_state(facts, prog)
        except Contradiction:
            yield "contradiction", None, None, None, 0, None, None, prog
            return
        raise AssertionError("the reference raised a contradiction, the port not")
    ts = te.materialise_state(facts, prog)
    base = ts.stats.capacity_retries
    yield "base", te, ts, js, base, None, None, prog
    for i, (op, delta) in enumerate(events):
        try:
            labels = ref_update(je, js, op, delta)
        except RefContradiction:
            try:
                (te.add_facts if op == "add" else te.delete_facts)(ts, delta)
            except Contradiction:
                yield "contradiction", None, None, None, 0, None, None, prog
                return
            raise AssertionError(f"event {i}: the reference raised, the port not")
        (te.add_facts if op == "add" else te.delete_facts)(ts, delta)
        got = [label for label, _ in te.last_split["phases"]]
        yield f"{i}:{op}", te, ts, js, base, got, labels, prog
