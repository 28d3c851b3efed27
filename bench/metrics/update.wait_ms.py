"""Host ms a change set blocked in the program's reads (the engine's last_split)."""

from bench.lib.spans import split_ms


def read(ctx):
    return split_ms(ctx, "wait")
