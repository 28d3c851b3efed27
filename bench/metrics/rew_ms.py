"""The window's wall over the materialisations completed in it (host clock)."""

from bench.lib.readings import per_op_ms as read  # noqa: F401
