"""From the process's start to the window's start (host clock)."""

from bench.lib.readings import setup_s_of as read  # noqa: F401
