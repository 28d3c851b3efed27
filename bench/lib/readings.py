"""The arithmetic the metric readers under ``bench/metrics/`` share.  Each
returns None where its run has nothing to read: a per-layer reading of the
trace in a run whose trace lost launches of a hand-written kernel, or one
that needs operations the window did not have."""

from __future__ import annotations

from . import costs, stats


def per_op_ms(ctx) -> float:
    """The window's wall over its operations, in ms."""
    return 1e3 * ctx.wall_s / len(ctx.ops)


def p95_ms(ctx) -> float:
    return 1e3 * stats.percentile([o["latency_s"] for o in ctx.ops], 95)


def rows_per_s(ctx) -> float:
    return stats.rate(sum(o["rows"] for o in ctx.ops), ctx.wall_s)


def peak_gb(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None


def glue_ms(ctx):
    """Device ms an operation of the traced sub-window in work other than
    the hand-written kernels."""
    if ctx.trace is None or not ctx.sub:
        return None
    return 1e3 * ctx.trace.glue_s / len(ctx.sub)


def kernels_roofline(ctx):
    """The hand-written kernels' frozen least time over their traced
    device time, in %, over the traced sub-window."""
    if ctx.trace is None:
        return None
    device_s = sum(ctx.trace.port_s.values())
    if device_s <= 0:
        return None
    least = sum(n * costs.bound_s(entry, shapes)
                for (entry, shapes), n in ctx.sub_launches.items())
    return 100.0 * least / device_s


def idle_pct(ctx):
    """The share of the traced sub-window in which no device operation ran."""
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share


def sorted_keys(ctx):
    """Keys handed to ``dedup_order`` an operation over the whole window
    (the census: eager launches, and a graph's times its replays)."""
    if not ctx.window_launches or not ctx.ops:
        return None
    keys = sum(n * shapes[0][0] for (entry, shapes), n in ctx.window_launches.items()
               if entry == "dedup_order")
    return keys / len(ctx.ops)


def phase_ms(ctx, label: str, op: str):
    """Host ms an ``op`` spends in the phase ending at ``label`` (from the
    engine's ``last_split``), mean over the window's unprofiled ones."""
    spans = []
    for o in ctx.ops:
        if o.get("op") != op or o.get("profiled"):
            continue
        marks = o["split"]["phases"]
        for k, (name, t) in enumerate(marks):
            if name == label:
                spans.append(t - (marks[k - 1][1] if k else 0.0))
    return 1e3 * sum(spans) / len(spans) if spans else None


def setup_s_of(ctx) -> float:
    return ctx.setup_s
