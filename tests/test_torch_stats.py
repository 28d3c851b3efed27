"""The port's ``MatStats`` and ``DispatchCounter`` against the reference's
``repro.core.stats``: the same fields in the same order, the paper's AX/REW
factor rows, and the dispatch counter's totals, snapshots, resets and its
thread-local phase under concurrent threads."""

import dataclasses
import sys
import threading

import pytest

from repro.core import stats as jstats
from repro.core.materialise import materialise_ax as jmaterialise_ax
from repro.core.materialise import materialise_rew as jmaterialise_rew
from repro.data.datasets import single_clique as jsingle_clique
from repro_torch.core.materialise import materialise_ax, materialise_rew
from repro_torch.core.stats import DispatchCounter, MatStats
from repro_torch.data.datasets import single_clique


def test_matstats_fields_are_the_reference():
    """The same fields, in the reference's order (``contradiction`` before
    ``memory_bytes``), with the same defaults."""
    assert [f.name for f in dataclasses.fields(MatStats)] == \
        [f.name for f in dataclasses.fields(jstats.MatStats)]
    assert MatStats().as_dict() == jstats.MatStats().as_dict()


@pytest.mark.parametrize("n", [5, 8])
def test_factor_over_is_the_reference(n):
    """The paper's factor rows (AX over REW) on a single clique: the
    port's host AX and REW give the reference's triples, rule applications
    and derivations factors."""
    facts, prog, dic = single_clique(n)
    jfacts, jprog, jdic = jsingle_clique(n)
    got = materialise_rew(facts, prog, dic.n_resources).stats.factor_over(
        materialise_ax(facts, prog, dic.n_resources).stats)
    want = jmaterialise_rew(jfacts, jprog, jdic.n_resources).stats.factor_over(
        jmaterialise_ax(jfacts, jprog, jdic.n_resources).stats)
    assert set(got) == set(want) == {"triples", "rule_applications",
                                     "derivations", "time"}
    for k in ("triples", "rule_applications", "derivations"):
        assert got[k] == want[k], k
    assert got["derivations"] > 5.0 and got["triples"] > 1.0


def test_factor_over_of_empty_counters_is_inf():
    assert MatStats().factor_over(MatStats(derivations=3))["derivations"] == float("inf")


def test_dispatch_counter_snapshot_and_reset():
    c = DispatchCounter()
    c.record("a")
    c.record("a")
    c.record_compile("a")
    snap = c.snapshot()
    assert snap["total"] == 2 and snap["by_family"] == {"a": 2}
    assert c.by_phase == {(None, "a"): 2}
    c.reset()
    assert c.total == 0 and not c.by_family and not c.compiles
    assert c.phase is None


def test_dispatch_counter_phase_is_per_thread_and_loses_nothing():
    """Eight threads, each under its own phase, record at once under a
    short switch interval: every total is exact and no thread's phase
    leaks onto another's dispatches."""
    c = DispatchCounter()
    n_threads, n_calls = 8, 2000
    start = threading.Barrier(n_threads)

    def worker(i):
        c.phase = f"p{i}"
        start.wait(timeout=30)
        for _ in range(n_calls):
            c.record("unit")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert c.total == c.by_family["unit"] == n_threads * n_calls
    assert dict(c.by_phase) == {(f"p{i}", "unit"): n_calls for i in range(n_threads)}
    assert c.phase is None  # this thread never set one
