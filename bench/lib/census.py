"""The launch census, frozen here with the benchmark (a copy, extended
with operand shapes, of the bring-up check's ``LaunchCensus``).

``ops.traced`` hands it each launch of a hand-written kernel with its
operands: eager launches count where they happen, and the launches
recorded into a CUDA graph's capture count once for each replay of that
graph.  :meth:`LaunchCensus.mark` takes a snapshot (eager counts and each
graph's replays) so that a span's launches are the difference of two.
"""

from __future__ import annotations

import contextlib


class LaunchCensus:
    def __init__(self) -> None:
        self.live: dict = {}       # (entry, shapes) -> eager launches
        self.captured: dict = {}   # id(capture's dict of calls) -> {(entry, shapes): n}
        self.plain_calls = 0       # plain versions run (the CPU's path)

    def launch(self, fn, operands, capture) -> None:
        key = (fn, tuple(tuple(int(d) for d in t.shape) for t in operands))
        into = self.live if capture is None else self.captured.setdefault(
            id(capture), {})
        into[key] = into.get(key, 0) + 1

    def plain(self, fn):
        self.plain_calls += 1
        return contextlib.nullcontext()

    def mark(self, graphs) -> dict:
        """A snapshot: eager launches so far and each graph's replays
        (``graphs``: the engine's captured graphs, each with ``calls``, the
        capture's dict, and ``replays``)."""
        return dict(live=dict(self.live),
                    replays={id(g.calls): (g.calls, g.replays) for g in graphs})

    def between(self, start: dict, end: dict) -> dict:
        """Launches by ``(entry, shapes)`` from snapshot ``start`` to ``end``."""
        out = {k: n - start["live"].get(k, 0) for k, n in end["live"].items()}
        for key, (calls, replays) in end["replays"].items():
            before = start["replays"].get(key, (calls, 0))[1]
            for k, n in self.captured.get(key, {}).items():
                out[k] = out.get(k, 0) + n * (replays - before)
        return {k: n for k, n in out.items() if n}
