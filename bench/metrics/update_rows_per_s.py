"""Rows of every change set completed in the window over its wall (host clock)."""

from bench.lib.readings import rows_per_s as read  # noqa: F401
