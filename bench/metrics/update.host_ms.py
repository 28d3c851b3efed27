"""Host ms a change set inside the call less its reads (the engine's last_split)."""

from bench.lib.spans import split_ms


def read(ctx):
    return split_ms(ctx, "host")
