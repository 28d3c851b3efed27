"""repro_torch.analysis against repro.analysis: the passes, the planted
fixtures, the registered inventory, the dispatch auditor and its CLI; and
the ``sameas_rew`` config behind ``TorchEngine.from_config``.

Positive direction: the port's registered inventory lints clean at the
probe geometry on the reference's four probe datasets, with the
reference's unit labels, and a driven update stream's dispatches
reconcile with the static phase profile, which equals the reference's.

Negative direction: each planted fixture, written in torch, trips exactly
the pass the reference's fixture trips on its jaxpr, with a location.

The one pinned difference in the dispatch ledger: the port counts a fused
round (``fforward``) and a fused wave (``fwave``) a dispatch each, where
the reference runs one compiled loop for a whole stretch of rounds or
waves; every other (phase, family) count of the shared stream is the
reference's.
"""

import jax
import jax.experimental
import jax.extend.core

# jax 0.9 moved these; the reference package still imports them by their
# old names.  Set at import so every test process sees the same modules.
jax.experimental.enable_x64 = jax.enable_x64
jax.core.Jaxpr = jax.extend.core.Jaxpr

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import analysis as janalysis  # noqa: E402
from repro.analysis import fixtures as jfixtures  # noqa: E402
from repro.core import engine_jax as jeng  # noqa: E402
from repro.core import incremental_spmd as jinc  # noqa: E402
from repro.core.stats import DispatchCounter as JDispatchCounter  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    ALL_PASSES,
    DtypeSafety,
    NoArenaScatter,
    NoArenaSort,
    NoHostCallback,
    audit_engine,
    audited_fn_labels,
    build_probe,
    count_sorts_at_least,
    dispatch_crosscheck,
    record,
)
from repro_torch.analysis.fixtures import (  # noqa: E402
    ARENA,
    EXPECTED_PASS,
    FIXTURES,
    trace_fixture,
)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.incremental_spmd import static_dispatch_profile  # noqa: E402
from repro_torch.core.stats import DispatchCounter  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ["pex", "chain", "clique", "dbpedia_like"]
FUSED = {"fforward", "fwave"}  # one dispatch a round / wave here


def _run_passes(label, trace, arena_rows):
    vs = []
    for p in ALL_PASSES:
        vs += p.run(label, trace, arena_rows)
    return vs


_probes: dict = {}


def _probe(dataset):
    """The port's probe (CPU) and the reference's, built once a dataset."""
    if dataset not in _probes:
        _probes[dataset] = (build_probe(dataset, device="cpu"),
                            janalysis.build_probe(dataset))
    return _probes[dataset]


# ---------------------------------------------------------------------------
# planted fixtures: every pass catches its bug class, with a location
# ---------------------------------------------------------------------------

def test_fixture_inventory_is_the_reference():
    assert FIXTURES == jfixtures.FIXTURES
    assert EXPECTED_PASS == jfixtures.EXPECTED_PASS
    assert ARENA == jfixtures.ARENA


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_trips_expected_pass(name):
    """Each fixture trips exactly the passes the reference's fixture trips
    on its jaxpr (its expected pass, and no other), with an actionable
    report."""
    label, trace, rows = trace_fixture(name, device="cpu")
    vs = _run_passes(label, trace, rows)
    jlabel, jx, jrows = jfixtures.trace_fixture(name)
    want = {v.pass_name for p in janalysis.ALL_PASSES for v in p.run(jlabel, jx, jrows)}
    assert {v.pass_name for v in vs} == want == {EXPECTED_PASS[name]}
    v = vs[0]
    assert v.fn == f"fixture:{name}"
    assert v.primitive and v.path
    assert str(v).startswith(f"[{EXPECTED_PASS[name]}] fixture:{name}:")
    assert set(v.as_dict()) == {"pass_name", "fn", "primitive", "path", "detail"}


def test_nested_fixture_reports_nested_path():
    """The plant one level down is reported where it ran: inside the
    plain version's scope, not at the top."""
    label, trace, rows = trace_fixture("nested_cond_sort", device="cpu")
    vs = NoArenaSort().run(label, trace, rows)
    assert vs and vs[0].path != "<top>", [str(v) for v in vs]
    assert vs[0].path == "plain:dedup_order"


def test_fixtures_do_not_cross_fire():
    """Each fixture is clean under the reference's choice of another pass."""
    others = {
        "arena_sort": NoArenaScatter(),
        "arena_scatter": NoArenaSort(),
        "int32_key": NoHostCallback(),
        "host_callback": DtypeSafety(),
    }
    for name, p in others.items():
        label, trace, rows = trace_fixture(name, device="cpu")
        assert p.run(label, trace, rows) == [], (name, p.name)


def test_count_sorts_at_least_thresholds():
    """Arena-length sorts count; a threshold past them counts none."""
    _l, trace, rows = trace_fixture("arena_sort", device="cpu")
    assert count_sorts_at_least(trace, rows) == 1
    assert count_sorts_at_least(trace, rows + 1) == 0


def test_dtype_safety_allows_widening_and_untainted_casts():
    """Only narrowing casts of packed-key-tainted values violate: widening
    a key, or narrowing a value that never saw a pack, is fine; a copy of a
    packed key into an int32 buffer is not."""
    s = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int64)

    def benign():
        key = (s.to(torch.int64) << 21) | s.to(torch.int64)
        return key + 1, key.to(torch.float64), x.to(torch.int32)

    assert DtypeSafety().run("benign", record(benign), ARENA) == []

    def copied():
        out = torch.zeros(8, dtype=torch.int32)
        out.copy_(s.to(torch.int64) << 42)
        return out

    vs = DtypeSafety().run("copied", record(copied), ARENA)
    assert [v.primitive for v in vs] == ["aten.copy_.default"]


def test_host_reads_are_recorded():
    """Every form of host read a unit could make is seen on the CPU:
    scalars, data-sized results, a mask index, ``tolist`` and ``numpy``."""
    orig = torch.Tensor.tolist
    x = torch.arange(8)
    m = x > 3
    reads = {
        "item": lambda: x[0].item(), "bool": lambda: bool(m.any()),
        "nonzero": lambda: torch.nonzero(m), "mask": lambda: x[m],
        "tolist": lambda: x.tolist(), "numpy": lambda: x.numpy(),
    }
    for name, fn in reads.items():
        assert NoHostCallback().run(name, record(fn), ARENA), name
    assert NoHostCallback().run("none", record(lambda: x[x.clamp(0, 3)] + 1),
                                ARENA) == []
    assert torch.Tensor.tolist is orig  # the recorder's hooks are gone


def test_host_loop_process_makes_no_host_read():
    """The host loop's round step makes no host read inside its body: its
    counts, bits and fresh delta come back in one read after it."""
    (eng, state, _), _ = _probe("pex")
    (label, run), = engine.AUDIT_REGISTRY["process"].builder(eng, state)
    trace = record(run)
    assert NoHostCallback().run(label, trace, ARENA) == []
    assert any(ev.op == "aten.sort.stable" for ev in trace)  # the stream's dedup


# ---------------------------------------------------------------------------
# positive direction: the registered inventory lints clean on every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", DATASETS)
def test_inventory_lints_clean(dataset):
    (eng, state, program), (jeng_, jstate, _jprog) = _probe(dataset)
    assert int(state.spo.shape[0]) == int(jstate.spo.shape[0])
    vs = audit_engine(eng, state)
    assert vs == [], [str(v) for v in vs]
    labels = audited_fn_labels(eng, state)
    assert sorted(labels) == sorted(janalysis.audited_fn_labels(jeng_, jstate))
    fams = {lbl.split(":")[0] for lbl in labels}
    assert fams >= {
        "process", "squeeze", "rebuild_index", "seed_tombs",
        "od", "finalize_tombs", "extract_od", "member", "occupancy",
        "fforward", "fwave", "snapshot", "bgp",
    }, fams
    if program.rules:
        assert {"plan", "rplan"} <= fams, fams


@pytest.mark.parametrize("dataset", DATASETS + [None])
def test_static_dispatch_profile_is_the_reference(dataset):
    if dataset is None:
        assert static_dispatch_profile() == jinc.static_dispatch_profile()
        return
    (_, _, program), (_, _, jprogram) = _probe(dataset)
    assert static_dispatch_profile(program) == jinc.static_dispatch_profile(jprogram)


def test_static_dispatch_profile_on_pex():
    (_, _, program), _ = _probe("pex")
    prof = static_dispatch_profile(program)
    assert prof["add:prepare"] == {"rebuild_index": 1}
    assert prof["add:forward"] == {"fforward": 1, "process": 1, "plan": 2,
                                   "squeeze": 1, "mplan": 2}
    assert prof["query"] == {"bgp": None}


def test_driven_stream_dispatches_reconcile():
    """The same delete and add through ``JaxEngine`` and a CPU
    ``TorchEngine`` from the clique probe: both reconcile with their static
    profiles, tag the same (phase, family) pairs, and count the same
    dispatches but for the fused loops' (pinned), and end on the same rho."""
    from repro.data.datasets import clique_with_spokes as jclique

    (peng, pstate, program), (_, _, jprogram) = _probe("clique")
    caps = dict(capacity=4096, bind_cap=256, out_cap=256, rewrite_cap=256)
    eng = TorchEngine(peng.n_resources, device="cpu", **caps)
    state = TorchEngine.cloned(pstate)
    jfacts, jprog, jdic = jclique(6, 4)
    jeng_ = jeng.JaxEngine(jdic.n_resources, **caps)
    jstate = jeng_.materialise_state(jfacts, jprog)
    rows = TorchEngine.explicit_rows(state)[:2]
    for e, s in ((eng, state), (jeng_, jstate)):
        e.dispatches.reset()
        e.delete_facts(s, rows)
        e.add_facts(s, rows)
        assert e.dispatches.phase is None  # generators reset their tag
        assert e.dispatches.total > 0
    assert dispatch_crosscheck(eng.dispatches, program) == []
    assert janalysis.dispatch_crosscheck(jeng_.dispatches, jprogram) == []
    got = {k: n for k, n in eng.dispatches.by_phase.items() if k[0] is not None}
    want = {k: n for k, n in jeng_.dispatches.by_phase.items() if k[0] is not None}
    assert got and set(got) == set(want)
    for key in got:
        if key[1] in FUSED:
            assert got[key] >= want[key], key
        else:
            assert got[key] == want[key], key
    np.testing.assert_array_equal(state.rep.numpy(), np.asarray(jstate.rep))


# ---------------------------------------------------------------------------
# dispatch cross-check semantics (pure, no recording)
# ---------------------------------------------------------------------------

def test_dispatch_crosscheck_flags_unknowns():
    """The reference's case, on both packages' counters: the same two
    problems, word for word."""
    counters = (DispatchCounter(), JDispatchCounter())
    for c in counters:
        c.phase = "add:forward"
        c.record("process")          # admitted
        c.phase = "add:mystery"
        c.record("process")          # unknown phase
        c.phase = "delete:wave"
        c.record("rogue")            # unregistered family in a known phase
        c.phase = "retry"
        c.record("rebuild_index")    # capacity-retry recovery: admitted
        c.phase = None
        c.record("anything")         # untagged: never checked
    probs = dispatch_crosscheck(counters[0])
    assert probs == janalysis.dispatch_crosscheck(counters[1])
    assert len(probs) == 2, probs
    assert any("unknown phase 'add:mystery'" in p for p in probs)
    assert any(
        "delete:wave" in p and "'rogue'" in p and "static profile allows" in p
        for p in probs
    )


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )


def test_cli_check_passes_on_inventory(tmp_path):
    out_json = tmp_path / "report.json"
    r = _cli("--check", "--device", "cpu", "--json", str(out_json))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s), 0 dispatch problem(s)" in r.stdout
    report = json.loads(out_json.read_text())
    assert report["violations"] == []
    assert report["dispatch"]["problems"] == []
    assert report["fns"] and report["passes"]
    assert report["dispatch"]["total"] > 0
    assert report["launches"] and not any(report["launches"].values())  # CPU
    for key in report["dispatch"]["runtime_by_phase"]:
        ph, fam = key.rsplit("/", 1)
        assert fam in report["dispatch"]["static_profile"][ph], key


@pytest.mark.parametrize("name", FIXTURES)
def test_cli_fixture_exits_nonzero(name):
    r = _cli("--fixture", name, "--device", "cpu", "--json", "-")
    # rc 1 == expected pass fired (rc 2 would mean the audit went blind)
    assert r.returncode == 1, (name, r.returncode, r.stdout + r.stderr)
    assert EXPECTED_PASS[name] in r.stdout
    assert "fired as planted" in r.stdout


# ---------------------------------------------------------------------------
# the sameas_rew config
# ---------------------------------------------------------------------------

def test_archs_and_sameas_rew_spec_are_the_reference():
    from repro.configs import all_archs as jall_archs
    from repro.configs import get_arch as jget_arch
    from repro_torch.configs import all_archs, get_arch

    assert all_archs() == jall_archs()
    ours, theirs = get_arch("sameas_rew"), jget_arch("sameas_rew")
    for attr in ("config", "reduced"):
        assert dataclasses.asdict(getattr(ours, attr)) == \
            dataclasses.asdict(getattr(theirs, attr))
    assert [dataclasses.asdict(s) for s in ours.shapes] == \
        [dataclasses.asdict(s) for s in theirs.shapes]
    assert (ours.name, ours.family, ours.source) == \
        (theirs.name, theirs.family, theirs.source)
    for name in all_archs():
        ours, theirs = get_arch(name), jget_arch(name)
        assert (ours.name, ours.family, ours.source) == \
            (theirs.name, theirs.family, theirs.source)
        for attr in ("config", "reduced"):
            assert dataclasses.asdict(getattr(ours, attr)) == \
                dataclasses.asdict(getattr(theirs, attr))
        assert [dataclasses.asdict(s) for s in ours.shapes] == \
            [dataclasses.asdict(s) for s in theirs.shapes]


def test_from_config_reduced_on_pex_is_the_reference():
    """``TorchEngine.from_config(REDUCED)`` on pex: the triples, rho and
    counters of ``JaxEngine.from_config(REDUCED)`` (its ``route_cap`` has
    no effect on one device in either package)."""
    from repro.configs.sameas_rew import REDUCED as JREDUCED
    from repro.core.triples import pack
    from repro.data.datasets import pex as jpex
    from repro_torch.configs.sameas_rew import REDUCED
    from repro_torch.data.datasets import pex

    eng = TorchEngine.from_config(REDUCED, device="cpu")
    assert (eng.n_resources, eng.capacity, eng.seed_chunk) == (1024, 256, 64)
    spo, rep, stats = eng.materialise(*pex()[:2])
    jspo, jrep, jstats = jeng.JaxEngine.from_config(JREDUCED).materialise(*jpex()[:2])
    assert set(pack(spo).tolist()) == set(pack(np.asarray(jspo)).tolist())
    np.testing.assert_array_equal(rep, np.asarray(jrep))
    for k in ("derivations", "rule_applications", "merged_resources",
              "reflexive_added", "rounds", "triples_total", "triples_unmarked"):
        assert getattr(stats, k) == getattr(jstats, k), k
