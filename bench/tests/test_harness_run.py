"""Whole runs on the CPU at a small size: every cell kind comes out
correct; with the timed path broken underneath it does not, for each fault
these cells can have; the control does not either; and a configuration, a
traffic mix and a per-layer metric are added as files and entries alone."""

import hashlib
import json
import time

import numpy as np
import pytest
import torch

from bench import control
from bench.lib import check, harness, kg as kgen
from bench.tests.tiny import REPO, make_root
from repro_torch import TorchEngine

CELLS = ["oc.rew", "up.rew", "oc.updates", "up.updates"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench_root"))


def run(root, cell, seconds=1.0, trace=False):
    return harness.run(root, cell, 2**31 + 77, seconds, trace, time.perf_counter(),
                       device="cpu")["result"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]


def _alter(state):
    """One live row's object changed where the program produced it."""
    live = torch.nonzero((state.epoch >= 0) & ~state.marked).reshape(-1)
    row = int(live[len(live) // 2])
    state.spo[row, 2] = (state.spo[row, 2] + 1) % state.rep.shape[0]


FAULTS = ["unchanged", "half", "altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    mat, add, delete = (TorchEngine.materialise_state, TorchEngine.add_facts,
                        TorchEngine.delete_facts)
    warm = {"done": False}  # set-up runs the sound path; the window the broken one

    def broken_mat(self, facts, program, *a, **k):
        if not warm["done"]:
            return mat(self, facts, program, *a, **k)
        if fault == "unchanged":
            return self._fresh_state(program)
        if fault == "half":
            return mat(self, facts[: len(facts) // 2], program, *a, **k)
        state = mat(self, facts, program, *a, **k)
        _alter(state)
        return state

    def broken(fn):
        def update(self, state, delta, *a, **k):
            if not warm["done"]:
                return fn(self, state, delta, *a, **k)
            if fault == "unchanged":
                return state
            if fault == "half":
                return fn(self, state, delta[: len(delta) // 2], *a, **k)
            out = fn(self, state, delta, *a, **k)
            _alter(state)
            return out
        return update

    setup = harness.traffic.KINDS[("rew_repeat" if cell.endswith(".rew")
                                   else "changeset_cycle")].setup

    def setup_then_break(self):
        out = setup(self)
        warm["done"] = True
        return out

    monkeypatch.setattr(TorchEngine, "materialise_state", broken_mat)
    monkeypatch.setattr(TorchEngine, "add_facts", broken(add))
    monkeypatch.setattr(TorchEngine, "delete_facts", broken(delete))
    kind = harness.traffic.KINDS["rew_repeat" if cell.endswith(".rew") else "changeset_cycle"]
    monkeypatch.setattr(kind, "setup", setup_then_break)
    result = run(root, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    p = harness.plan(root, cell)
    for seed in (1, 2**31 + 5, 12):
        kg = kgen.generate(seed, **p["config"]["generator"])
        outs = control.control_outputs(p, kg, seed, 40)
        checks = check.compare(outs, harness.reference_of(p["config"], kg), 0)
        assert not check.passed(checks), checks


def _driver(root, cell, capacity=None):
    p = harness.plan(root, cell)
    config = p["config"]
    if capacity is not None:
        config = dict(config, engine=dict(config["engine"], capacity=capacity))
    kg, program, engine = harness.build(config, 2**31 + 21, "cpu")
    return harness.traffic.ChangesetCycle(engine, kg, program, p["traffic"], config,
                                          2**31 + 21)


def test_store_is_put_back_only_before_a_cycle_that_could_fill_the_arena(root):
    driver = _driver(root, "oc.updates")
    setup = driver.setup()
    cap = driver.engine.capacity
    assert setup["capacity"] == cap and setup["cycle_growth"] > 0
    assert driver.state.stats.triples_total == setup["base_rows"]
    recs = [driver.step() for _ in range(4 * 12)]
    restored = [n for n, r in enumerate(recs) if r["restored"]]
    assert restored and all(n % 4 == 0 for n in restored)
    assert len(driver.restores) == len(restored)
    assert all(r["ok"] and r["triples_total"] <= cap for r in recs)
    assert driver.engine.capacity == cap  # no event overflowed the arena
    before = [recs[n - 1]["triples_total"] for n in restored]
    assert all(t + 1.25 * setup["cycle_growth"] > cap for t in before)
    kept = [recs[n - 1]["triples_total"] for n in range(4, len(recs), 4) if n not in restored]
    assert all(t + 1.25 * setup["cycle_growth"] <= cap for t in kept)


def test_setup_refuses_caps_that_one_cycle_overflows(root):
    driver = _driver(root, "oc.updates")
    base = driver.engine.materialise_state(driver.kg.facts, driver.program)
    tight = _driver(root, "oc.updates", capacity=base.stats.triples_total + 64)
    with pytest.raises(RuntimeError, match="too small"):
        tight.setup()


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    bench = root / "bench"
    (bench / "configs" / "cl.json").write_text(json.dumps(dict(
        name="cl", reference="rew",
        generator=dict(n_groups=60, group_size=6, n_spokes_per=4, n_plain=800,
                       hierarchy_depth=4),
        expect=dict(merged=300), update_feed=dict(merge_share=0.4),
        engine=dict(arch="sameas_rew", capacity=1 << 14, bind_cap=1 << 14,
                    out_cap=1 << 14, rewrite_cap=1 << 14))))
    (bench / "traffic" / "rew_short.json").write_text(json.dumps(dict(
        kind="rew_repeat", trace_warm=1, trace_ops=2)))
    (bench / "metrics" / "rew.rounds.py").write_text(
        "def read(ctx):\n    return sum(o['rounds'] for o in ctx.ops) / len(ctx.ops)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="cl", source="https://arxiv.org/abs/1411.3622",
                                file="bench/configs/cl.json", reduced=[], why="test"))
    spec["workloads"].append(dict(name="cl.rew", config="cl", traffic="rew_short",
                                  chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "rew_ms" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append("cl.rew")
    spec["per_layer"].append(dict(name="rew.rounds", unit="rounds", better="lower",
                                  source="program_counter", layer="REW round loop",
                                  moves="rew_ms", workloads=["cl.rew"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    p = harness.plan(root, "cl.rew")
    assert p["config"]["name"] == "cl" and p["traffic"]["trace_ops"] == 2
    assert "rew.rounds" in [m["name"] for m in p["per_layer"]]
    plain = run(root, "cl.rew")
    assert plain["correct"] and "rew_ms" in plain["metrics"]
    traced = run(root, "cl.rew", trace=True)
    assert traced["correct"] and traced["metrics"]["rew.rounds"]["value"] == 5
    assert {k: v for k, v in _digests(root).items() if k in before} == before


def test_repository_spec_names_existing_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (REPO / "bench" / "reference" / f"{cfg['reference']}.py").is_file()
    for w in spec["workloads"]:
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert harness.reader(REPO, m["name"]) is not None


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    record = harness.run(REPO, "opencyc.rew", 2**31 + 1, 2.0, False, time.perf_counter())
    assert record["result"]["correct"], record["result"]["checks"]
    assert np.isfinite(record["result"]["metrics"]["rew_ms"]["value"])
