"""The metric arithmetic: a percentile over all events, a window's rate,
the trace's busy and idle time, lost launches, the readers, and the frozen
bounds, which stay under the kernels' measured times at the main path's
shapes."""

import math

import numpy as np
import pytest

from bench.lib import costs, readings, stats, trace
from bench.lib.harness import Ctx


def test_percentile_covers_every_value():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 9, 7], 50) == pytest.approx(6.0)


def test_rate():
    assert stats.rate(4096 * 10, 2.0) == 20480
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def synthetic():
    """A 100 us window: two kernels overlapping, one glue op, one memcpy;
    idle from 30 to 50 under a host call and from 90 to 100 outside any."""
    return [
        (trace.SPAN, 0.0, 100.0, False),
        (trace.SPAN, 0.0, 100.0, True),  # the span's own mark on the device
        ("bench.step.delete_b", 20.0, 100.0, False),
        ("bench.step.delete_b", 20.0, 100.0, True),
        ("aten::copy_", 25.0, 60.0, False),
        ("cudaStreamSynchronize", 28.0, 55.0, False),
        ("void (anonymous namespace)::radix_histogram(long long const*)", 0.0, 20.0, True),
        ("void (anonymous namespace)::radix_pass(PassArgs, int)", 10.0, 30.0, True),
        ("void at::native::elementwise_kernel<...>", 50.0, 80.0, True),
        ("Memcpy HtoD (Pageable -> Device)", 80.0, 90.0, True),
        ("before the window", -50.0, -10.0, True),
    ]


def test_trace_summary():
    s = trace.summarise(synthetic())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(70e-6)
    assert s.idle_share == pytest.approx(0.3)
    assert s.port_s == {"dedup_order": pytest.approx(40e-6)}
    assert s.glue_s == pytest.approx(40e-6)
    assert s.kept == {"dedup_order": 1}
    assert dict((n, t) for n, t in s.idle_gaps) == {
        "cudaStreamSynchronize": pytest.approx(20e-6),
        "bench.step.delete_b": pytest.approx(10e-6)}
    assert s.device_ops[0][1] == pytest.approx(30e-6)


def test_lost_launches():
    s = trace.summarise(synthetic())
    launches = {("dedup_order", ((100,),)): 1, ("search_bounds", ((0,), (5,))): 3}
    assert trace.lost_launches(s, launches) == {}
    launches[("dedup_order", ((7,),))] = 1
    launches[("uf_union", ((10,), (4, 2), (4,)))] = 2
    assert trace.lost_launches(s, launches) == {"dedup_order": 1, "uf_union": 2}


def test_readers():
    ops = [dict(latency_s=0.01 * (i + 1), rows=100, op="delete" if i % 2 else "add",
                split=dict(phases=[("seeded", 0.001), ("split", 0.004),
                                   ("rederive", 0.010)]))
           for i in range(20)]
    ops[1]["profiled"] = True
    s = trace.summarise(synthetic())
    ctx = Ctx(ops=ops, wall_s=2.0, setup_s=3.5, peak_bytes=2e9, sub=ops[:2], trace=s,
              sub_launches={("dedup_order", ((1 << 10,),)): 2},
              window_launches={("dedup_order", ((1 << 10,),)): 40,
                               ("search_bounds", ((5,), (9,))): 3})
    assert readings.per_op_ms(ctx) == pytest.approx(100.0)
    assert readings.p95_ms(ctx) == pytest.approx(1e3 * stats.percentile(
        [o["latency_s"] for o in ops], 95))
    assert readings.rows_per_s(ctx) == pytest.approx(1000.0)
    assert readings.peak_gb(ctx) == 2.0
    assert readings.glue_ms(ctx) == pytest.approx(0.02)
    assert readings.idle_pct(ctx) == pytest.approx(30.0)
    assert readings.sorted_keys(ctx) == 40 * 1024 / 20
    assert readings.phase_ms(ctx, "rederive", "delete") == pytest.approx(6.0)
    least = 2 * costs.bound_s("dedup_order", ((1 << 10,),))
    assert readings.kernels_roofline(ctx) == pytest.approx(100 * least / 40e-6)
    ctx.trace = None  # a trace that lost launches reads nothing
    assert readings.glue_ms(ctx) is None and readings.kernels_roofline(ctx) is None


# the main path's shapes and the kernels' times there (PERF.md, the table of
# the TPU kernels: CUDA-event medians, and the profiler's device time where
# given; one H100 80GB HBM3 at 700 W)
MAIN_PATH = [
    ("dedup_order", (((1 << 25) + 1,),), 3.4265),
    ("search_bounds", (((1 << 25) + 1,), ((1 << 22) + 1,)), 0.3298),
    ("rewrite_triples", (((1 << 22) + 1, 3), (971865,)), 0.1130),
    ("uf_compress", ((971865,),), 0.0083),
    ("uf_union", ((971865,), (1 << 22, 2), (1 << 22,)), 0.0985),
]


@pytest.mark.parametrize("entry,shapes,measured_ms", MAIN_PATH)
def test_frozen_bound_under_the_measured_time(entry, shapes, measured_ms):
    least_ms = 1e3 * costs.bound_s(entry, shapes)
    assert 0 < least_ms < measured_ms
    assert math.isfinite(least_ms)


def test_device_markers_bound_the_sub_window():
    """Two marker kernels inside the span set the window on the device's
    clock, from the first one's end to the second one's start; the markers
    are neither busy time nor glue."""
    recs = [(trace.SPAN, 0.0, 100.0, False),
            (trace.MARK, 1.0, 3.0, True),
            ("void (anonymous namespace)::union_kernel(int*)", 90.0, 99.0, True),
            (trace.MARK, 99.5, 100.0, True),
            ("void (anonymous namespace)::union_kernel(int*)", -9.0, -1.0, True)]
    s = trace.summarise(recs)
    assert s.window_s == pytest.approx(96.5e-6)
    assert s.busy_s == pytest.approx(9e-6)
    assert s.kept == {"uf_union": 1}
