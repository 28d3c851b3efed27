"""The hand-written kernels' share of their frozen least time, materialisations (profiler)."""

from bench.lib.readings import kernels_roofline as read  # noqa: F401
