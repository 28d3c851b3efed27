"""Device ms a materialisation outside the hand-written kernels (profiler)."""

from bench.lib.readings import glue_ms as read  # noqa: F401
