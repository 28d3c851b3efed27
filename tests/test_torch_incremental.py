"""Incremental add and delete of the port against ``JaxEngine`` and the
host subsystem against ``repro.core.incremental``.

``TorchEngine.add_facts``/``delete_facts`` on the CPU against
``JaxEngine``'s (under the jax 0.9 shim), event by event, exactly: on the
probe stream under the host loops and under the requeue baseline of
rederivation, on a random stream under the host loops; a contradiction
raised by an add.  Then the pieces: the update sampler,
``split_cliques``, the plan builders of the delete and re-merge paths, and
the numpy host subsystem (:mod:`repro_torch.core.incremental`) against the
reference's.  The retry and state-lifecycle tests are in
``tests/test_torch_incremental_retry.py``.
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
import torch  # noqa: E402

from incremental_cases import (  # noqa: E402
    assert_from_scratch, assert_same_state, case, explicit_set, programs,
    run_stream,
)
from repro.core import engine_jax as jeng  # noqa: E402
from repro.core import incremental as jinc  # noqa: E402
from repro.core import uf as juf  # noqa: E402
from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.core.materialise import Contradiction as RefContradiction  # noqa: E402
from repro.data.generator import PROFILES as JPROFILES  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro.data.generator import sample_update_stream as jsample  # noqa: E402
from repro_torch.core import engine, incremental, uf  # noqa: E402
from repro_torch.core.engine import Contradiction, TorchEngine  # noqa: E402
from repro_torch.core.terms import DIFFERENT_FROM, SAME_AS  # noqa: E402
from repro_torch.core.triples import apply_op  # noqa: E402
from repro_torch.data.generator import PROFILES, generate, sample_update_stream  # noqa: E402

# the probe stream's counters after its last event under targeted
# rederivation (the reference's, on the CPU)
PROBE_END = dict(od_waves=7, overdeleted=105, suspects_split=4,
                 rederive_targeted=4, triples_total=342)


def _check_stream(name, caps, **kw):
    stats = None
    for tag, te, ts, js, base, got, want, _prog in run_stream(name, caps=caps, **kw):
        assert tag != "contradiction"
        assert_same_state(ts, js, base, f"{name} {tag}")
        assert got == want, f"{name} {tag}: phase labels"
        assert_from_scratch(te, ts, ts.n_res, ts.base_program, f"{name} {tag}")
        if tag != "base" and not kw.get("fuse_rounds", True):
            assert te.last_split["captures"] == 0
        stats = ts.stats
    return stats


@pytest.mark.parametrize("fuse,mode", [(False, "targeted"), (True, "requeue")],
                         ids=["host_loop-targeted", "fused-requeue"])
def test_probe_stream_matches_reference(fuse, mode):
    """The profile file runs the default engine (fused, targeted); here the
    host loops and the requeue baseline of rederivation."""
    stats = _check_stream("probe", 1 << 8, fuse_rounds=fuse, rederive_mode=mode)
    if mode == "targeted":
        assert {k: getattr(stats, k) for k in PROBE_END} == PROBE_END
        assert stats.rederive_full_fallback == 0
    else:
        assert stats.rederive_targeted == 0 and stats.rederive_full_fallback > 0
    assert stats.capacity_retries == 1  # a retry mid-update at 256-row caps


def test_random_stream_host_loops_match_reference():
    """A random program whose updates re-merge onto rule constants (the
    merge-targeted plans) and split cliques, under the host loops."""
    stats = _check_stream("random-0", 1 << 9, fuse_rounds=False)
    assert stats.remerge_targeted and stats.suspects_split


def test_contradiction_raised_by_an_add():
    facts = np.array([[5, DIFFERENT_FROM, 6], [5, 7, 8]], np.int32)
    add = np.array([[5, SAME_AS, 6]], np.int32)
    prog, jprog = programs([])
    je = JaxEngine(10, capacity=64, bind_cap=64, out_cap=64, rewrite_cap=64)
    js = je.materialise_state(facts, jprog)
    with pytest.raises(RefContradiction):
        je.add_facts(js, add)
    for fuse in (True, False):
        te = TorchEngine(10, capacity=64, bind_cap=64, out_cap=64,
                         rewrite_cap=64, device="cpu", fuse_rounds=fuse)
        ts = te.materialise_state(facts, prog)
        with pytest.raises(Contradiction):
            te.add_facts(ts, add)


def test_materialise_incremental_on_and_off_the_device():
    facts, _, spec, n_res, events = case("probe")
    prog, _ = programs(spec)
    kw = dict(capacity=256, bind_cap=256, out_cap=256, rewrite_cap=256, device="cpu")
    spo, rep, stats = TorchEngine(n_res, **kw).materialise_incremental(
        facts, prog, events)
    hspo, hrep, hstats = TorchEngine(n_res, **kw).materialise_incremental(
        facts, prog, events, on_device=False)
    np.testing.assert_array_equal(rep, hrep)
    assert explicit_set(spo) == explicit_set(hspo)
    cur = facts
    for op, delta in events:
        cur = apply_op(cur, op, delta)
    want = TorchEngine(n_res, **kw).materialise(cur, prog)
    np.testing.assert_array_equal(rep, want[1])
    assert explicit_set(spo) == explicit_set(want[0])
    with pytest.raises(ValueError):
        TorchEngine(n_res, **kw).materialise_incremental(facts, prog, [("upsert", facts)])


@pytest.mark.parametrize("name,seed,batch,p_delete", [
    ("opencyc_like", 0, 24, 0.5), ("merge_like", 3, 8, 0.3),
    ("uobm_like", 5, 16, 0.8), ("claros_like", 1, 4, 0.0),
])
def test_sample_update_stream_matches_reference(name, seed, batch, p_delete):
    kw = dict(PROFILES[name], n_groups=6, n_plain=50)
    facts, _, dic = generate(**kw)
    jf, _, jd = jgenerate(**dict(JPROFILES[name], n_groups=6, n_plain=50))
    got = sample_update_stream(facts, dic, n_events=6, batch=batch,
                               p_delete=p_delete, seed=seed)
    want = jsample(jf, jd, n_events=6, batch=batch, p_delete=p_delete, seed=seed)
    assert [op for op, _ in got] == [op for op, _ in want]
    for (_, d), (_, w) in zip(got, want):
        np.testing.assert_array_equal(d, w)
    assert dic.n_resources == jd.n_resources
    with pytest.raises(NotImplementedError):
        sample_update_stream(facts, dic, p_query=0.5)


@pytest.mark.parametrize("seed", range(4))
def test_split_cliques_matches_reference(seed):
    rng = np.random.default_rng(seed)
    rep = np.arange(40, dtype=np.int32)
    pairs = rng.integers(0, 40, (15, 2))
    rep, _ = uf.merge_pairs_np(rep, pairs)
    roots = np.flatnonzero(uf.clique_sizes(rep) > 1)
    suspect = rng.choice(roots, min(len(roots), 2), replace=False)
    got = uf.split_cliques(rep, suspect)
    np.testing.assert_array_equal(got, juf.split_cliques(rep, suspect))
    # the device path's split: members of a suspect clique to themselves
    t = torch.from_numpy(rep)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[torch.from_numpy(suspect)] = True
    dev_split = torch.where(mask[t.long()], torch.arange(40, dtype=torch.int32), t)
    np.testing.assert_array_equal(dev_split.numpy(), got)


@pytest.mark.parametrize("name", ["probe", "merge_like", "uobm_ish", "random-0"])
def test_plan_builders_match_reference(name):
    _, _, spec, _, _ = case(name)
    prog, jprog = programs(spec)

    def fields(plan):
        return [tuple(vars(s).values()) for s in plan]

    for rule, jrule in zip(prog.rules, jprog.rules):
        for full, tomb in ((False, False), (True, False), (False, True)):
            got = engine.build_plans(rule, full=full, tombstone=tomb)
            want = jeng.build_plans(jrule, full=full, tombstone=tomb)
            assert [fields(p) for p in got] == [fields(p) for p in want]
        plan, head_vars = engine.build_rederive_plan(rule)
        jplan, jhead_vars = jeng.build_rederive_plan(jrule)
        assert (fields(plan), head_vars) == (fields(jplan), jhead_vars)
        for anchor in range(len(rule.body)):
            assert fields(engine.build_merge_plan(rule, anchor)) == fields(
                jeng.build_merge_plan(jrule, anchor))
    # classify_remerge on every rule rewritten under a merging rho
    consts = sorted(prog.constants())
    rep = np.arange(max(consts, default=0) + 2, dtype=np.int32)
    for a, b in zip(consts[::2], consts[1::2]):
        rep[max(a, b)] = min(a, b)
    new, _ = prog.rewrite(rep)
    jnew, _ = jprog.rewrite(rep)
    for old, nr, jold, jnr in zip(prog.rules, new.rules, jprog.rules, jnew.rules):
        assert engine.classify_remerge(old, nr) == jeng.classify_remerge(jold, jnr)


@pytest.mark.parametrize("name", ["probe", "merge_like", "claros_small", "random-1"])
def test_host_subsystem_matches_reference(name):
    facts, jfacts, spec, n_res, events = case(name)
    prog, jprog = programs(spec)
    try:
        want = jinc.materialise_incremental(jfacts, jprog, n_res)
    except RefContradiction:
        with pytest.raises(Contradiction):
            incremental.materialise_incremental(facts, prog, n_res)
        return
    got = incremental.materialise_incremental(facts, prog, n_res, device="cpu")
    for op, delta in events:
        try:
            (jinc.add_facts if op == "add" else jinc.delete_facts)(want, delta)
        except RefContradiction:
            with pytest.raises(Contradiction):
                (incremental.add_facts if op == "add"
                 else incremental.delete_facts)(got, delta)
            return
        (incremental.add_facts if op == "add" else incremental.delete_facts)(got, delta)
        np.testing.assert_array_equal(got.rep, want.rep)
        np.testing.assert_array_equal(got.triples(), want.triples())
        assert explicit_set(got.explicit) == explicit_set(want.explicit)
        assert [(r.head, r.body) for r in got.program.rules] == [
            (r.head, r.body) for r in want.program.rules]
        g, w = got.result().stats.as_dict(), want.result().stats.as_dict()
        for k in g:
            if k not in ("mode", "wall_seconds"):
                assert g[k] == w[k], k
    # the kernel route of the normal forms (the plain version on the CPU)
    rows = got.triples()
    np.testing.assert_array_equal(
        incremental.normal_forms(rows, got.rep, use_kernel=True, device="cpu"),
        incremental.normal_forms(rows, got.rep))
