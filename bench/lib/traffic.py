"""The one general traffic generator: a mix is a data file
(``bench/traffic/<mix>.json``) whose ``kind`` names one of the closed
loops below and whose other keys are its parameters.

* ``rew_repeat``: one client materialises the explicit facts back to back
  (``TorchEngine.materialise_state``), each run from the facts on the host,
  the last run's state dropped when the next starts.
* ``changeset_cycle``: one writer applies change sets of ``rows`` rows to
  the store ``materialise_state`` made (``add_facts`` / ``delete_facts``),
  entry ``i`` of a pool of ``pool`` sets at a time, in the four-event cycle
  of :mod:`bench.lib.changesets`; ``merge_share`` comes from the
  configuration's ``update_feed``.  Every cycle leaves the explicit set and
  the store as they were, but the program never reuses an arena row (a
  deleted or rewritten fact's row stays marked), so its arena fills with
  every event.  Before a cycle whose growth could take the arena past the
  engine's capacity (the largest growth of a cycle so far, times
  ``HEADROOM``), the writer therefore puts back the store as the base
  materialisation left it, from a copy kept on the host, off the window's
  clock: the window runs the arena from its base to as full as the caps
  allow, and no event overflows them.

A driver warms the shapes of its traffic in :meth:`setup`, runs one
operation a :meth:`step` (timed from the call to its synchronised return)
and, after the window, hands :meth:`outputs`: what the program produced at
the states the check compares, read to the host.  A step that the check
samples reads its state right after it returns, on a clock that
:meth:`step` reports as ``paused_s`` so the window leaves it out.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np

from . import changesets
from .keys import pack


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


HEADROOM = 1.25  # a cycle may grow the arena by this much over the largest growth seen


def placed(state, device):
    """A copy of the program's state with every tensor on ``device``, its
    ``stats`` copied and the rest shared, as ``TorchEngine.cloned`` copies."""
    import torch

    moved = {f.name: v.to(device, copy=True) for f in dataclasses.fields(state)
             if isinstance(v := getattr(state, f.name), torch.Tensor)}
    out = dataclasses.replace(state, **moved)
    out.stats = copy.copy(state.stats)
    return out


def read_state(engine, state) -> dict:
    """The program's store, rho and explicit set, copied to the host as
    they are (the check sorts them after the window)."""
    from repro_torch import TorchEngine

    return dict(triples=engine.state_triples(state), rho=engine.state_rep(state),
                explicit=TorchEngine.explicit_rows(state))


class RewRepeat:
    """Closed loop of whole materialisations."""

    def __init__(self, engine, kg, program, params: dict, config: dict, seed: int):
        self.engine, self.kg, self.program = engine, kg, program
        self.params = params
        self.expect = config["expect"]
        self.state = None
        self.first_total = None

    def setup(self) -> dict:
        """The first run captures the round graph; the second replays it."""
        out = {}
        for label in ("first_s", "second_s"):
            self.state = None
            t0 = time.perf_counter()
            self.state = self.engine.materialise_state(self.kg.facts, self.program)
            _sync(self.engine.device)
            out[label] = time.perf_counter() - t0
        self.first_total = self.state.stats.triples_total
        return out

    def next_kind(self) -> str:
        return "materialise"

    def step(self) -> dict:
        eng = self.engine
        captures = eng.captures
        self.state = None  # the last run's state goes before the next starts
        t0 = time.perf_counter()
        self.state = eng.materialise_state(self.kg.facts, self.program)
        _sync(eng.device)
        latency = time.perf_counter() - t0
        st = self.state.stats
        ok = (st.merged_resources == self.expect["merged"]
              and st.triples_total == self.first_total
              and st.capacity_retries == 0)
        return dict(kind="materialise", latency_s=latency, ok=bool(ok),
                    rows=int(self.kg.facts.shape[0]), rounds=st.rounds,
                    merged=st.merged_resources, triples_total=st.triples_total,
                    captures=eng.captures - captures, split=eng.last_split,
                    paused_s=0.0)

    def outputs(self) -> list:
        """The last run's store and rho, against the closure of the facts."""
        got = read_state(self.engine, self.state)
        self.state = None
        return [dict(label="last run", got=got, explicit=np.unique(pack(self.kg.facts)))]


class ChangesetCycle:
    """Closed loop of change sets through one writer."""

    def __init__(self, engine, kg, program, params: dict, config: dict, seed: int):
        self.engine, self.kg, self.program = engine, kg, program
        self.params = params
        self.expect = config["expect"]
        merge_share = config["update_feed"]["merge_share"]
        self.base, self.pool, _ = changesets.draw_pool(
            kg, seed, params["rows"], params["pool"], merge_share)
        self.state = self.snapshot = None
        self.capacity = engine.capacity if engine is not None else None  # the arena's rows
        self.growth = self.cycle_rows = 0  # the largest growth of a cycle; rows at its start
        self.restores: list = []  # seconds of each restore in the window
        self.n = 0  # events applied in the window
        # the events whose state the check reads: one add of an A_i and one
        # delete of a B_i in the second half of the window's first pass
        # through the pool (after the traced run's profiled cycles)
        rng = np.random.default_rng([seed, 0x5A3])
        half = params["pool"] // 2
        cycles = half + rng.integers(params["pool"] - half, size=2)
        self.sampled = {4 * int(cycles[0]), 4 * int(cycles[1]) + 2}
        self.taken: list = []

    def _event(self, n: int):
        i = (n // 4) % len(self.pool)
        return (i, *changesets.events(self.pool, i)[n % 4])

    def _apply(self, op: str, rows) -> None:
        (self.engine.add_facts if op == "add" else self.engine.delete_facts)(
            self.state, rows)

    def _restore(self) -> None:
        self.state = None
        self.state = placed(self.snapshot, self.engine.device)
        _sync(self.engine.device)

    def _cycle_start(self, n: int) -> float:
        """At a cycle's first event: puts the base back if the cycle could
        pass the engine's capacity, notes the arena's rows; the restore's
        seconds."""
        if n % 4:
            return 0.0
        t0 = time.perf_counter()
        total = self.state.stats.triples_total
        restored = total + HEADROOM * self.growth > self.engine.capacity
        if restored:
            self._restore()
            total = self.state.stats.triples_total
        self.cycle_rows = total
        return (time.perf_counter() - t0) if restored else 0.0

    def _cycle_end(self, n: int) -> None:
        if n % 4 == 3:
            self.growth = max(self.growth, self.state.stats.triples_total - self.cycle_rows)

    def setup(self) -> dict:
        """The base materialisation, kept on the host, then every pool
        entry's cycle once: every width the window's change sets need is
        captured here, and each cycle's growth of the arena measured."""
        t0 = time.perf_counter()
        self.state = self.engine.materialise_state(self.kg.facts, self.program)
        self.snapshot = placed(self.state, "cpu")
        _sync(self.engine.device)
        out = dict(base_s=time.perf_counter() - t0, base_rows=self.state.stats.triples_total)
        t0 = time.perf_counter()
        restores = 0
        for n in range(4 * len(self.pool)):
            restores += self._cycle_start(n) > 0
            _, _, op, rows = self._event(n)
            self._apply(op, rows)
            self._cycle_end(n)
        if self.engine.capacity != self.capacity:
            raise RuntimeError(
                f"a change-set cycle of up to {self.growth} rows overflowed the arena's "
                f"{self.capacity} rows: the configuration's caps are too small")
        self._restore()
        out.update(warm_cycles_s=time.perf_counter() - t0, cycle_growth=self.growth,
                   warm_restores=restores, capacity=self.engine.capacity)
        return out

    def next_kind(self) -> str:
        return self._event(self.n)[1]

    def step(self) -> dict:
        eng = self.engine
        paused = self._cycle_start(self.n)
        if paused:
            self.restores.append(paused)
        i, kind, op, rows = self._event(self.n)
        captures, retries = eng.captures, self.state.stats.capacity_retries
        t0 = time.perf_counter()
        self._apply(op, rows)
        _sync(eng.device)
        latency = time.perf_counter() - t0
        self._cycle_end(self.n)
        st = self.state.stats
        want = changesets.expected_count(self.base, self.pool, kind)
        ok = st.triples_explicit == want and eng.capacity == self.capacity and (
            kind not in ("delete_a", "add_b") or st.merged_resources == self.expect["merged"])
        rec = dict(kind=kind, op=op, entry=i, latency_s=latency, ok=bool(ok),
                   rows=int(rows.shape[0]), explicit=st.triples_explicit,
                   merged=st.merged_resources, triples_total=st.triples_total,
                   captures=eng.captures - captures, retries=st.capacity_retries - retries,
                   split=eng.last_split, restored=bool(paused), paused_s=paused)
        if self.n in self.sampled:
            t1 = time.perf_counter()
            self.taken.append(dict(label=f"event {self.n} ({kind} of entry {i})",
                                   got=read_state(eng, self.state), entry=i, kind=kind))
            rec["paused_s"] += time.perf_counter() - t1
        self.n += 1
        return rec

    def outputs(self) -> list:
        """The sampled events' states and the last event's, each against
        the closure of the explicit set it should hold."""
        last = self.n - 1
        i, kind, _, _ = self._event(last)
        taken = self.taken + [dict(label=f"last event {last} ({kind} of entry {i})",
                                   got=read_state(self.engine, self.state),
                                   entry=i, kind=kind)]
        self.state = self.snapshot = None
        for t in taken:
            t["explicit"] = changesets.expected_explicit(self.base, self.pool,
                                                         t.pop("entry"), t.pop("kind"))
        return taken


KINDS = {"rew_repeat": RewRepeat, "changeset_cycle": ChangesetCycle}
