"""Host ms a delete spends in its rederive phase (the engine's last_split)."""

from bench.lib.readings import phase_ms


def read(ctx):
    return phase_ms(ctx, "rederive", "delete")
