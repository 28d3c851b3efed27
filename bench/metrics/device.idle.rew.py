"""Share of the traced materialisations with no device operation running (profiler)."""

from bench.lib.readings import idle_pct as read  # noqa: F401
