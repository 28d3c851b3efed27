"""Updates that roll back and retry, and the life of a state, against
``JaxEngine`` and on the port alone.

From 4-row capacities every growth is a rollback to the update's snapshot
and a retry (the store grows mid-update, the index is rebuilt, a delta
buffer falls back to the wide buffers and is probed again 4 updates
later), in both packages alike, event by event (arrays, explicit set,
program, counters, capacities).  On the port: a restored snapshot is the
state as it was (the round bodies write the arena in place, so the
snapshot clones it); a no-effect update yields no phase and advances the
epoch; a state is left alone by another state's updates.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import numpy as np  # noqa: E402

from incremental_cases import (  # noqa: E402
    assert_from_scratch, assert_same_state, case, programs, ref_update,
)
from repro.core.engine_jax import JaxEngine  # noqa: E402
from repro.data.generator import generate as jgenerate  # noqa: E402
from repro.data.generator import sample_update_stream as jsample  # noqa: E402
from repro_torch.core.engine import TorchEngine, state_to_arrays  # noqa: E402
from repro_torch.data.generator import generate, sample_update_stream  # noqa: E402


def _arrays(state) -> dict:
    """Copies of the state's arrays (on the CPU ``state_to_arrays`` shares
    the tensors' memory)."""
    return {k: v.copy() for k, v in state_to_arrays(state).items()}


def test_capacity_retry_from_four_rows():
    """Updates from 4-row buffers: every growth is a rollback to the
    snapshot and a retry, in both packages alike; the results, the
    capacities and the fallback state the engines end at are the same."""
    kw = dict(n_groups=1, group_size=3, n_spokes_per=1, n_plain=4,
              hierarchy_depth=1, seed=2)
    facts, program, dic = generate(**kw)
    jf, jp, jd = jgenerate(**kw)
    events = sample_update_stream(facts, dic, n_events=7, batch=3, seed=1)
    jevents = jsample(jf, jd, n_events=7, batch=3, seed=1)
    caps = dict(capacity=4, bind_cap=4, out_cap=4, rewrite_cap=4)
    je = JaxEngine(dic.n_resources, **caps)
    te = TorchEngine(dic.n_resources, device="cpu", **caps)
    js = je.materialise_state(jf, jp)
    ts = te.materialise_state(facts, program)
    base = ts.stats.capacity_retries
    assert_same_state(ts, js, base, "base")
    for (op, delta), (_, jdelta) in zip(events, jevents):
        ref_update(je, js, op, jdelta)
        (te.add_facts if op == "add" else te.delete_facts)(ts, delta)
        assert_same_state(ts, js, base, op)
        assert_from_scratch(te, ts, ts.n_res, program, op)
    assert "delete" in [op for op, _ in events]
    assert ts.stats.capacity_retries > base  # updates were rolled back
    # the store grew mid-update (the index rebuilt at the retry's start),
    # a delta buffer overflowed into the wide fallback, and 4 updates
    # later the narrow buffers were probed again
    assert ts.stats.index_rebuilds >= 2 and not te._delta_fallback
    names = ("capacity", "bind_cap", "out_cap", "rewrite_cap", "delta_out",
             "delta_bind", "delta_rewrite", "_delta_fallback")
    assert [getattr(te, n) for n in names] == [getattr(je, n) for n in names]


def test_snapshot_is_a_copy():
    """A rollback restores the state as it was, though the round bodies
    write the arena in place."""
    facts, _, spec, n_res, events = case("probe")
    prog, _ = programs(spec)
    te = TorchEngine(n_res, device="cpu", capacity=256, bind_cap=256,
                     out_cap=256, rewrite_cap=256)
    ts = te.materialise_state(facts, prog)
    before = _arrays(ts)
    snap = te._snapshot(ts)
    te.add_facts(ts, events[0][1])
    te.delete_facts(ts, events[1][1])
    assert state_to_arrays(ts)["n_used"] != before["n_used"]
    te._restore(ts, snap)
    for k, v in state_to_arrays(ts).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_no_effect_updates_yield_nothing_and_advance_the_epoch():
    facts, _, spec, n_res, _ = case("probe")
    prog, _ = programs(spec)
    te = TorchEngine(n_res, device="cpu", capacity=256, bind_cap=256,
                     out_cap=256, rewrite_cap=256)
    ts = te.materialise_state(facts, prog)
    before = _arrays(ts)
    stats = ts.stats.as_dict()
    absent = np.array([[n_res - 1, n_res - 1, n_res - 1]], np.int32)
    for op, delta in (("add", facts[:5]), ("delete", absent),
                      ("delete", np.zeros((0, 3), np.int32))):
        (te.add_facts if op == "add" else te.delete_facts)(ts, delta)
        assert te.last_split["phases"] == []
    assert ts.update_epoch == 3
    for k, v in state_to_arrays(ts).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert ts.stats.as_dict() | {"wall_seconds": 0} == stats | {"wall_seconds": 0}


def test_a_state_is_unchanged_by_another_states_updates():
    facts, _, spec, n_res, events = case("probe")
    prog, _ = programs(spec)
    te = TorchEngine(n_res, device="cpu", capacity=256, bind_cap=256,
                     out_cap=256, rewrite_cap=256)
    first = te.materialise_state(facts, prog)
    before = _arrays(first)
    second = te.materialise_state(facts, prog)
    for op, delta in events:
        (te.add_facts if op == "add" else te.delete_facts)(second, delta)
    for k, v in state_to_arrays(first).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
