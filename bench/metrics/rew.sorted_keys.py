"""Keys handed to dedup_order a materialisation (launch census)."""

from bench.lib.readings import sorted_keys as read  # noqa: F401
