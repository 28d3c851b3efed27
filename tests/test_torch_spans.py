"""The port's spans on the CPU (``repro_torch.core.spans``): with them on, a
materialisation and an update under ``torch.profiler`` give the span tree
the maintenance phases and the round stages name; with them off, no span
and no counter; the sort counter equals a count of the keys handed to
``dedup_order``; the phase ranges of two threads stay apart; and
``last_split`` times every read.  The markers and the captured graphs'
stages run on the card only (``test_torch_cuda.py``)."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import dispatch_crosscheck
from repro_torch.core import spans
from repro_torch.core.engine import KEY_MAX, RoundLog, TorchEngine
from repro_torch.core.stats import DispatchCounter
from repro_torch.data.generator import PROFILES, generate, sample_update_stream
from repro_torch.kernels import ops

CAP = 1 << 10  # holds the closure: no restart
ROUND_STAGES = ["rew.merge", "rew.sweep", "rew.dedup", "rew.join", "rew.flags"]
DELETE_PHASES = ["prepare", "seed", "wave", "finalize", "split", "rederive", "forward"]


@pytest.fixture(scope="module")
def kg():
    facts, program, dic = generate(**dict(PROFILES["opencyc_like"], n_groups=8,
                                          n_plain=120))
    events = sample_update_stream(facts, dic, n_events=6, batch=8, seed=1)
    return facts, program, dic.n_resources, events


@pytest.fixture
def on():
    spans.enable(True)
    try:
        yield
    finally:
        spans.enable(False)


def _engine(n_res, cap=CAP):
    return TorchEngine(n_res, device="cpu", capacity=cap, bind_cap=cap, out_cap=cap,
                       rewrite_cap=cap)


def _first(events, op):
    return next(d for o, d in events if o == op)


def _tree(prof) -> list:
    """``(name, parent program span)`` of every program span, in order."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not spans_name(e.name):
            continue
        par = e.cpu_parent
        while par is not None and not spans_name(par.name):
            par = par.cpu_parent
        out.append((e.name, par.name if par is not None else None))
    return out


def spans_name(name: str) -> bool:
    return name.startswith(("rew.", "maint."))


def test_materialise_and_delete_give_the_span_tree(kg, on):
    facts, program, n_res, events = kg
    eng = _engine(n_res)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = eng.materialise_state(facts, program)
        eng.delete_facts(state, _first(events, "delete"))
    labels = [lb for lb, _ in eng.last_split["phases"]]
    tree = _tree(prof)
    names = [n for n, _ in tree]
    parent = dict(tree)  # every name below has one parent throughout
    assert names[0] == "rew.materialise" and parent["rew.materialise"] is None
    for leaf in ("rew.upload", "rew.distinct", "rew.stats"):
        assert (leaf, "rew.materialise") in tree
    assert ("rew.round", "rew.materialise") in tree
    for s in ROUND_STAGES:
        assert {p for n, p in tree if n == s} == {"rew.round"}
    # each round's stages in process_static's order
    stage_seq = [n for n in names if n in ROUND_STAGES]
    assert stage_seq == ROUND_STAGES * (len(stage_seq) // len(ROUND_STAGES))
    assert ("rew.read", "rew.round") in tree

    # the delete: its phases under maint.delete, in order, and the labels
    # it yields fall between them
    assert ("maint.delete", None) in tree
    assert ("maint.snapshot", "maint.delete") in tree
    assert ("maint.barrier", "maint.delete") in tree
    phases = [n.removeprefix("maint.delete.") for n, p in tree
              if p == "maint.delete" and n.startswith("maint.delete.")]
    assert phases == DELETE_PHASES
    assert labels[0] == "seeded" and labels[-3:] == ["overdeleted", "split", "rederive"]
    assert set(labels[1:-3]) == {"wave"}  # seed -> wave -> finalize ...
    assert {p for n, p in tree if n in ("maint.tomb_join", "maint.od_step")} \
        == {"maint.delete.wave"}
    assert {p for n, p in tree if n == "rew.round" and p != "rew.materialise"} \
        == {"maint.delete.forward"}
    # the split dispatches nothing: the static profile needs no entry for it
    assert not [k for k in eng.dispatches.by_phase if k[0] == "delete:split"]
    assert dispatch_crosscheck(eng.dispatches, program) == []
    split = eng.last_split
    # every phase reads; the barrier's read is under no phase
    assert set(split["phase_wait_s"]) == {f"delete:{p}" for p in DELETE_PHASES} | {None}
    assert split["wait_s"] == pytest.approx(sum(split["phase_wait_s"].values()))
    assert 0 < split["wait_s"] < split["call_s"]
    assert split["call_s"] >= split["attempt_s"] + split["retries_s"]


def test_add_gives_its_phases(kg, on):
    facts, program, n_res, events = kg
    eng = _engine(n_res)
    state = eng.materialise_state(facts, program)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.add_facts(state, _first(events, "add"))
    tree = _tree(prof)
    assert [n for n, p in tree if p == "maint.add"] == [
        "maint.snapshot", "maint.add.prepare", "maint.add.forward", "maint.barrier"]
    assert ("rew.upload", "maint.add.prepare") in tree


def test_with_spans_off_no_span_and_no_counter(kg):
    facts, program, n_res, events = kg
    assert not spans.enabled()
    eng = _engine(n_res)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = eng.materialise_state(facts, program)
        first = dict(eng.last_split)
        eng.delete_facts(state, _first(events, "delete"))
    assert _tree(prof) == []
    for split in (first, eng.last_split):
        assert "sort_keys" not in split and "sort_pad_keys" not in split
    assert "wait_s" in first and "phase_wait_s" not in first
    assert "phase_wait_s" in eng.last_split and "call_s" in eng.last_split


@pytest.mark.parametrize("op,cap", [
    pytest.param("materialise", CAP, id="materialise"),
    pytest.param("delete", CAP, id="delete"),
    pytest.param("add", CAP, id="add"),
    pytest.param("materialise", 64, id="materialise-restarts"),
    pytest.param("delete", 64, id="delete-retries"),
])
def test_sort_counter_is_the_keys_handed_to_dedup_order(kg, on, op, cap, monkeypatch):
    """``sort_keys`` and ``sort_pad_keys`` equal a NumPy count of every key
    and every KEY_MAX key the call handed to ``dedup_order``, over every
    attempt of a call that restarts (64-row caps)."""
    facts, program, n_res, events = kg
    eng = _engine(n_res, cap)
    state = eng.materialise_state(facts, program) if op != "materialise" else None
    seen = []
    real = ops.dedup_order

    def counting(keys):
        seen.append(keys.numpy().copy())
        return real(keys)

    monkeypatch.setattr(ops, "dedup_order", counting)
    if op == "materialise":
        attempts = eng.materialise_state(facts, program).stats.capacity_retries + 1
    else:
        (eng.add_facts if op == "add" else eng.delete_facts)(state, _first(events, op))
        attempts = eng.last_split["attempts"]
    split = eng.last_split
    assert split["sort_keys"] == sum(k.shape[0] for k in seen) > 0
    assert split["sort_pad_keys"] == sum(int((k == KEY_MAX).sum()) for k in seen)
    assert 0 < split["sort_pad_keys"] < split["sort_keys"]
    assert (attempts > 1) == (cap != CAP)  # the 64-row caps make the call restart


def test_phase_ranges_of_two_threads_stay_apart(on, monkeypatch):
    """Two threads' phase tags on one counter each open and close their
    own thread's range, and a ``"query"`` tag closes its thread's phase
    range and opens none (a profiler session records only the thread that
    started it: both are taken to be recorded here)."""
    monkeypatch.setattr(spans, "_recording", lambda: True)
    counter = DispatchCounter()
    go = threading.Barrier(2, timeout=60)
    seen = {}

    def open_ranges():
        return [r.name for r in spans._stack()]

    def worker():
        counter.phase = "delete:wave"
        go.wait()
        counter.phase = "delete:finalize"
        seen["worker"] = open_ranges()
        go.wait()
        counter.phase = None
        seen["worker after"] = open_ranges()

    t = threading.Thread(target=worker)
    t.start()
    counter.phase = "add:forward"
    go.wait()
    go.wait()
    seen["main"] = open_ranges()
    counter.phase = "query"
    seen["main query"] = open_ranges()
    counter.phase = None
    seen["main after"] = open_ranges()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == {"worker": ["maint.delete.finalize"], "main": ["maint.add.forward"],
                    "main query": [], "worker after": [], "main after": []}
    assert counter.phase is None


def test_no_range_without_a_recording_session(on):
    """With the spans on but no profiler session, no range opens (it
    would record nothing); the phase tag is still set."""
    counter = DispatchCounter()
    counter.phase = "delete:wave"
    with spans.span("rew.materialise"):
        assert spans._stack() == []
    assert spans.open_span("rew.round") is None
    counter.phase = None


def test_phase_span_names():
    assert spans.phase_span("delete:split") == "maint.delete.split"
    assert spans.phase_span("add:forward") == "maint.add.forward"
    assert spans.phase_span("retry") == "maint.retry"
    assert spans.phase_span("query") is None and spans.phase_span("publish") is None


def test_a_range_left_open_closes_with_its_parent(on):
    """A round that raised before its end leaves its range open; the
    enclosing range closes it, so the ranges still nest."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("rew.materialise"):
            spans.open_span("rew.round")
            spans.stage("rew.merge", torch.device("cpu"))
        with spans.span("maint.add"):
            pass
    assert _tree(prof) == [("rew.materialise", None), ("rew.round", "rew.materialise"),
                           ("rew.merge", "rew.round"), ("maint.add", None)]


def test_captured_graphs_is_empty_on_the_cpu(kg):
    facts, program, n_res, _ = kg
    eng = _engine(n_res)
    eng.materialise_state(facts, program)
    assert eng.captured_graphs() == []


def test_read_waits_sum_to_wait_s(kg):
    facts, program, n_res, _ = kg
    eng = _engine(n_res)
    eng.materialise_state(facts, program)
    split = eng.last_split
    assert split["reads"] >= len(split["rounds"]) + 1
    assert split["wait_s"] >= sum(r["wait_s"] for r in split["rounds"])
    assert np.isfinite(split["wait_s"]) and split["wait_s"] < split["wall_s"]


def test_a_restarted_log_sums_the_reads_of_every_attempt():
    """A log handed the failed attempt's log starts its rounds anew and
    goes on summing the reads, by phase tag too."""
    tags = DispatchCounter()
    cpu = torch.device("cpu")
    first = RoundLog(cpu, tags)
    tags.phase = "delete:wave"
    first.read(lambda: time.sleep(0.01))
    second = RoundLog(cpu, tags, first)
    second.begin_round()
    second.read(lambda: time.sleep(0.01))
    second.end_round()
    tags.phase = None
    second.read(lambda: None)
    out = second.finish()
    assert len(out["rounds"]) == 1 and out["reads"] == 2
    assert set(out["phase_wait_s"]) == {"delete:wave", None}
    assert out["phase_wait_s"]["delete:wave"] >= 0.02
    assert out["wait_s"] == pytest.approx(sum(out["phase_wait_s"].values()))
    assert first.wait_s < 0.02 <= out["wait_s"]


def test_two_engines_count_their_own_sorts(kg, on, monkeypatch):
    """A call of one engine that runs, on another thread, inside a call of
    another engine (here the whole of it, within the first call's first
    sort) leaves the first call's sort counts as they are alone, and
    counts its own."""
    facts, program, n_res, _ = kg
    alone = _engine(n_res)
    alone.materialise_state(facts, program)
    want = alone.last_split["sort_keys"], alone.last_split["sort_pad_keys"]
    first, second = _engine(n_res), _engine(n_res)
    got = {}

    def run_second():
        second.materialise_state(facts, program)
        got["second"] = second.last_split["sort_keys"], second.last_split["sort_pad_keys"]

    inner = threading.Thread(target=run_second)
    real = ops.dedup_order

    def pausing(keys):
        if threading.current_thread() is not inner and not inner.ident:
            inner.start()
            inner.join(timeout=300)
        return real(keys)

    monkeypatch.setattr(ops, "dedup_order", pausing)
    first.materialise_state(facts, program)
    got["first"] = first.last_split["sort_keys"], first.last_split["sort_pad_keys"]
    assert got == {"first": want, "second": want}
