"""The 95th percentile of every change set's latency in the window (host clock)."""

from bench.lib.readings import p95_ms as read  # noqa: F401
