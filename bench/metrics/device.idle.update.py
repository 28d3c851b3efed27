"""Share of the traced change sets with no device operation running (profiler)."""

from bench.lib.readings import idle_pct as read  # noqa: F401
