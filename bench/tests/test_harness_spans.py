"""The attribution of a trace to the program's spans (``bench/lib/spans.py``)
on synthetic events: by correlation, by marker, the host self times and
idle gaps; the existing readers read the same with the program's spans
and markers as without; the new readers read None where the program has
no spans."""

import pytest

from bench.lib import readings, spans, trace
from bench.lib.harness import Ctx
from bench.tests.test_harness_metrics import synthetic

H, D = False, True
RADIX = "void (anonymous namespace)::radix_pass(PassArgs, int)"
CAT = "void at::native::CatArrayBatchedCopy<int, 4>(...)"
EW = "void at::native::vectorized_elementwise_kernel<4, ...>"


def ev(name, a, b, device, kind="", corr=0, linked=0, thread=1):
    return spans.Ev(name, a, b, device, kind, thread, corr, linked)


def mark(stage, at, corr):
    return ev(f"void span_mark_kernel<{stage}>()", at, at + 0.1, D, "kernel", corr)


def events():
    """A window from 2 to 98 us (the harness's spin kernels) over one
    materialisation: an upload, a round replayed from a graph with its
    markers, a read, an eager kernel and a copy linked to a CPU op only."""
    return [
        ev(trace.SPAN, 0.0, 100.0, H, "user_annotation"),
        ev(trace.MARK, 1.0, 2.0, D, "kernel"),
        ev(trace.MARK, 98.0, 99.0, D, "kernel"),
        ev("rew.materialise", 4.0, 95.0, H, "user_annotation"),
        ev("rew.upload", 6.0, 10.0, H, "user_annotation"),
        ev("aten::fill_", 9.0, 9.5, H, "cpu_op", corr=55),
        ev("rew.round", 20.0, 60.0, H, "user_annotation"),
        ev("rew.round", 20.0, 60.0, D, "gpu_user_annotation"),
        ev("rew.read", 50.0, 58.0, H, "user_annotation"),
        ev("cudaMemcpyAsync", 7.0, 8.0, H, "cuda_runtime", corr=101),
        ev("Memcpy HtoD (Pageable -> Device)", 8.0, 12.0, D, "gpu_memcpy", corr=101),
        ev("cudaGraphLaunch", 21.0, 22.0, H, "cuda_runtime", corr=102),
        mark("rew::merge", 22.0, 102),
        ev(EW, 23.0, 27.0, D, "kernel", corr=102),
        mark("rew::sweep", 27.0, 102),
        ev(RADIX, 28.0, 33.0, D, "kernel", corr=102),
        ev(CAT, 33.0, 40.0, D, "kernel", corr=102),
        mark("body::end", 40.0, 102),
        ev("cudaMemcpyAsync", 41.0, 41.5, H, "cuda_runtime", corr=104),
        ev("Memcpy DtoH (Device -> Pageable)", 42.0, 43.0, D, "gpu_memcpy", corr=104),
        ev("cudaLaunchKernel", 62.0, 63.0, H, "cuda_runtime", corr=103),
        ev(EW, 63.0, 70.0, D, "kernel", corr=103),
        ev("Memset (Device)", 80.0, 85.0, D, "gpu_memset", linked=55),
        ev(EW, 86.0, 88.0, D, "kernel", corr=999),
    ]


def test_attribution_by_correlation_and_by_marker():
    r = spans.attribute(events())
    got = {k: v["device_ms"] for k, v in r["spans"].items()}
    assert got == pytest.approx({
        "rew.materialise": 0.007, "rew.upload": 0.009, "rew.round": 0.001,
        "rew.read": 0.0, "rew.merge": 0.004, "rew.sweep": 0.012})
    assert r["unattributed_ms"] == pytest.approx(0.002)
    assert r["matched"] == dict(marker=3, runtime=3, linked=1, none=1)
    # the hand-written kernel (radix_pass: dedup_order) is not glue
    assert r["glue"] == pytest.approx({"rew.upload": 0.009, "rew.merge": 0.004,
                                       "rew.sweep": 0.007, "rew.round": 0.001,
                                       "rew.materialise": 0.007, "": 0.002})
    assert spans.leaf_share(r) == pytest.approx(100 * 20 / 30)


def test_host_self_times_and_idle_gaps():
    r = spans.attribute(events())
    t = r["spans"]
    assert {k: v["host_self_ms"] for k, v in t.items()} == pytest.approx({
        "rew.materialise": (91 - 4 - 40) / 1e3, "rew.upload": 0.004,
        "rew.round": 0.032, "rew.read": 0.008, "rew.merge": 0.0, "rew.sweep": 0.0})
    assert {k: v["count"] for k, v in t.items() if v["count"]} == {
        "rew.materialise": 1, "rew.upload": 1, "rew.round": 1, "rew.read": 1}
    # gaps: 2-8, 12-23, 70-80, 85-86, 88-98 under the call; 27-28 and 40-42
    # in the round; 43-63 in the read (the markers are not busy time)
    assert {k: v["idle_ms"] for k, v in t.items()} == pytest.approx({
        "rew.materialise": 0.038, "rew.round": 0.003, "rew.read": 0.020,
        "rew.upload": 0.0, "rew.merge": 0.0, "rew.sweep": 0.0})
    assert r["idle_outside_ms"] == 0.0


def test_stage_names():
    assert spans.stage_of("void span_mark_kernel<maint::od_step>()") == "maint.od_step"
    assert spans.stage_of("void span_mark_kernel<body::end>()") == spans.END
    assert spans.stage_of(EW) is None


def _plain(evs):
    return [(e.name, e.start, e.end, e.device) for e in evs]


def test_existing_readers_read_the_same_with_program_spans():
    """The harness's own records with the program's ranges (host and
    device side) and markers added read, once stripped, what they read
    without them."""
    base = synthetic()
    extra = [("rew.materialise", 5.0, 95.0, H), ("rew.materialise", 5.0, 95.0, D),
             ("maint.delete.split", 85.0, 99.0, H), ("maint.delete.split", 85.0, 99.0, D),
             ("void span_mark_kernel<rew::merge>()", 31.0, 31.5, D),
             ("void span_mark_kernel<body::end>()", 91.0, 91.5, D)]
    a, b = trace.summarise(base), trace.summarise(spans.strip(base + extra))
    assert (a.window_s, a.busy_s, a.glue_s, a.port_s, a.kept, a.device_ops) == \
        (b.window_s, b.busy_s, b.glue_s, b.port_s, b.kept, b.device_ops)
    for s in (a, b):
        ctx = Ctx(ops=[{}] * 2, sub=[{}] * 2, trace=s,
                  sub_launches={("dedup_order", ((1 << 10,),)): 2})
        assert readings.glue_ms(ctx) == readings.glue_ms(Ctx(ops=[{}] * 2, sub=[{}] * 2,
                                                             trace=a))
        assert readings.idle_pct(ctx) == pytest.approx(30.0)
        assert readings.kernels_roofline(ctx) == readings.kernels_roofline(
            Ctx(ops=[], sub=[], trace=a, sub_launches=ctx.sub_launches))
    # the program's ranges now label the gaps they span
    assert dict(b.idle_gaps)["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert dict(b.idle_gaps)["maint.delete.split"] == pytest.approx(10e-6)


def test_new_readers_read_none_without_program_spans():
    plain = [e for e in events() if not spans.is_program(e.name)
             and spans.MARKER not in e.name]
    r = spans.attribute(plain)
    assert r["spans"] == {}
    for stage in ("rew.join", "rew.sweep", "rew.dedup"):
        assert spans.stage_ms(r, stage, 3) is None
    assert spans.leaf_share(r) is None
    assert spans.pad_share([{"setup_s": 1.0}, {}]) is None
    ctx = Ctx(ops=[dict(split=dict(phases=[], wall_s=1.0)), dict(split={})])
    assert spans.split_ms(ctx, "wait") is None and spans.split_ms(ctx, "host") is None
    assert spans.phase_wait_ms(ctx.ops) is None


def test_split_and_pad_readers():
    ops = [dict(split=dict(call_s=0.050, wait_s=0.010)),
           dict(split=dict(call_s=0.070, wait_s=0.030)),
           dict(split=dict(call_s=1.0, wait_s=0.5), profiled=True)]
    ctx = Ctx(ops=ops)
    assert spans.split_ms(ctx, "wait") == pytest.approx(20.0)
    assert spans.split_ms(ctx, "host") == pytest.approx(40.0)
    assert spans.pad_share([dict(sort_keys=100, sort_pad_keys=60),
                            dict(sort_keys=300, sort_pad_keys=40), {}]) == 25.0
    r = spans.attribute(events())
    assert spans.stage_ms(r, "rew.sweep", 2) == pytest.approx(0.006)
    assert spans.stage_ms(r, "rew.join", 2) == 0.0


def test_phase_waits_by_tag():
    """Read waits by phase tag, a mean over the unprofiled change sets;
    the reads outside a phase (tag None) under ``"none"``; from
    ``ctx.ops`` or from a record's ``ops`` and ``splits``."""
    splits = [dict(phase_wait_s={"delete:wave": 0.004, None: 0.001}),
              dict(phase_wait_s={"delete:wave": 0.002, "delete:rederive": 0.010}),
              dict(phase_wait_s={"delete:wave": 1.0})]
    ops = [{}, {}, dict(profiled=True)]
    want = {"delete:rederive": 5.0, "delete:wave": 3.0, "none": 0.5}
    got = spans.phase_wait_ms(ops, splits)
    assert got == pytest.approx(want) and list(got) == list(want)
    ctx = Ctx(ops=[dict(o, split=s) for o, s in zip(ops, splits)])
    assert spans.phase_wait_ms(ctx.ops) == pytest.approx(want)
