"""Device ms a change set outside the hand-written kernels (profiler)."""

from bench.lib.readings import glue_ms as read  # noqa: F401
