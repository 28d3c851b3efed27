"""Live SPARQL serving over incremental maintenance (epoch-snapshot reads).

The port of ``repro.serve.triple_store``.  A :class:`TripleStore` owns a
materialised :class:`~repro_torch.core.engine.EngineState` on the device and
admits two workloads against it: add/delete batches, maintained through the
phase generators of :mod:`repro_torch.core.incremental_spmd`, and SPARQL
queries, answered against published snapshots (in shape groups on the
device by :mod:`repro_torch.sparql.batched`, one at a time on the host by
:mod:`repro_torch.sparql.executor`).

**Epoch-snapshot consistency.**  Every query is answered against the
fixpoint of some completed maintenance epoch, never a mid-round state, and
its answers are expanded through that epoch's rho:

  * maintenance advances through the generators' resumable phases (adds:
    ``prepared``; deletes: ``seeded`` / ``wave`` / ``overdeleted`` /
    ``split`` / ``rederive``);
  * a :class:`~repro_torch.core.engine.StoreSnapshot` is published eagerly
    at every epoch barrier
    (:meth:`~repro_torch.core.engine.TorchEngine.publish_snapshot`): the
    device views are new tensors, rho is refreshed incrementally
    (:meth:`~repro_torch.core.uf.FrozenRho.refreshed`), and the host copy
    and the clique tables are built there too, so the whole cost is the
    barrier's (``publish_ms``), never a first reader's;
  * queries, whenever admitted, read the published snapshot;
  * each answer carries ``epoch``.

**Two schedulers**, as the reference's: the cooperative ``step()`` loop
(``threaded=False``: drain queued reads, then advance the update in flight
by one phase) and a :class:`~repro_torch.serve.scheduler.MaintenanceWorker`
thread (``threaded=True``), with readers on the caller's threads.  A
:class:`~repro_torch.core.engine.CapacityError` rolls the state back to the
update's snapshot, grows the exhausted buffer and restarts the update;
readers keep the published snapshot throughout.

**Streams on the card.**  The store's state is made and maintained on a
stream of its own (the base run included, so the allocator keeps the
state's memory on that stream), and each reading thread matches on a
stream of its own.  Graphs are captured in the thread-local error mode
(:class:`repro_torch.core.fused._Captured`), so readers may launch, copy
and synchronise while the worker captures.  A snapshot carries an event
recorded after its last write; a reader's stream waits for it and records
its use of the snapshot's tensors (:meth:`StoreSnapshot.device_views`).

Two ledgers.  ``dispatch_counts`` is the reference's: the engine's units of
work (:class:`~repro_torch.core.stats.DispatchCounter`) by family and by
the phase the generators, the engine (``"publish"``, ``"retry"``) and the
store's query drains (``"query"``) tag; :meth:`TripleStore.audit`
reconciles it with the static phase profile.  ``launch_counts`` is the
port's: kernel launches by C entry point, tallied per thread
(:func:`repro_torch.kernels.ops.tally`) around every phase step
(``"<op>:<label it reached>"``, the last step ``"<op>:forward"``), every
rollback (``"retry"``), every publication (``"publish"``) and every query
drain (``"query"``).  Both count graph captures under
``compiles_by_family``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.engine import (
    CapacityError,
    EngineState,
    RoundLog,
    StoreSnapshot,
    TorchEngine,
)
from repro_torch.core.incremental_spmd import spmd_add_phases, spmd_delete_phases
from repro_torch.core.rules import Program
from repro_torch.kernels import ops
from repro_torch.sparql.algebra import Query
from repro_torch.sparql.batched import BatchedExecutor
from repro_torch.sparql.executor import evaluate_at

from .scheduler import MaintenanceWorker

__all__ = ["TripleStore", "UpdateTicket", "QueryTicket"]


@dataclass
class UpdateTicket:
    """An admitted add/delete batch.

    ``epoch`` is assigned at the epoch barrier: the first snapshot whose
    fixpoint includes this batch.  ``wall_s`` is admission-to-barrier
    latency (in cooperative mode it includes any reads interleaved between
    the phases).  ``publish_ms`` is the snapshot publication cost paid at
    this ticket's barrier, apart from query latency.
    """

    uid: int
    op: str  # "add" | "delete"
    delta: np.ndarray
    status: str = "queued"  # queued | running | done | failed
    epoch: int | None = None
    wall_s: float = 0.0
    publish_ms: float = 0.0


@dataclass
class QueryTicket:
    """An admitted SPARQL query; ``epoch`` is the completed maintenance
    epoch whose snapshot the ``answer`` bag was evaluated against."""

    uid: int
    query: Query
    status: str = "queued"  # queued | done
    epoch: int | None = None
    answer: Counter | None = None
    wall_s: float = 0.0


class TripleStore:
    """A standing triple store serving SPARQL against a mutating store.

    Parameters
    ----------
    facts, program, dic:
        The explicit fact set, Datalog+sameAs program and dictionary,
        materialised to the base fixpoint (epoch 0) at construction.
    engine:
        A :class:`~repro_torch.core.engine.TorchEngine`.  When omitted one
        is sized as the reference sizes it (about 4x the explicit set) on
        ``device``.
    device:
        Where the store's own engine runs: the card unless ``"cpu"`` is
        asked.  With an explicit engine it must be that engine's device or
        None.
    threaded:
        False (default): cooperative deterministic scheduler
        (``step``/``drain`` on the caller's thread).  True: maintenance
        runs on a background :class:`~repro_torch.serve.scheduler.MaintenanceWorker`;
        ``step()`` is disabled, ``drain()`` waits for the worker while
        answering queued reads, and admission/reads never block on
        maintenance.
    batch_queries:
        Drain queued queries through the batched matcher
        (:class:`repro_torch.sparql.batched.BatchedExecutor`); ``False``
        forces the scalar host path.  ``query_width`` / ``min_batch`` are
        the matcher's knobs.

    The public surface is ``submit_update`` / ``submit_query`` /
    ``query_now`` (admission), ``step`` / ``drain`` (the scheduler),
    ``snapshot`` / ``epoch`` (the published read view) and ``close`` (stop
    the worker; also a context manager).
    """

    def __init__(
        self,
        facts: np.ndarray,
        program: Program,
        dic,
        engine: TorchEngine | None = None,
        max_rounds: int = 10_000,
        threaded: bool = False,
        batch_queries: bool = True,
        query_width: int = 4096,
        min_batch: int = 2,
        device: str | torch.device | None = None,
        **engine_kw,
    ) -> None:
        facts = np.asarray(facts, np.int32).reshape(-1, 3)
        if engine is not None and engine_kw:
            raise TypeError(
                "engine_kw only applies when the store builds its own "
                f"engine; got an explicit engine AND {sorted(engine_kw)}"
            )
        if engine is None:
            cap = 1 << max(12, int(np.ceil(np.log2(max(4 * facts.shape[0], 2)))))
            kw = dict(
                capacity=cap, bind_cap=cap // 2, out_cap=cap // 2,
                rewrite_cap=cap // 4, seed_chunk=2048,
            )
            kw.update(engine_kw)
            engine = TorchEngine(dic.n_resources, device=device or "cuda", **kw)
        elif device is not None and torch.device(device) != engine.device:
            raise ValueError(f"device {device} but the engine runs on {engine.device}")
        self.engine = engine
        self.dic = dic
        self.max_rounds = max_rounds
        on_card = engine.device.type == "cuda"
        self._stream = torch.cuda.Stream(engine.device) if on_card else None
        self._readers = threading.local()  # each reading thread's stream
        self._ledger_lock = threading.Lock()
        self._by_family: Counter = Counter()
        self._by_phase: Counter = Counter()  # keyed (phase, entry point)
        with self._maintaining(), ops.tally() as calls:
            self.state: EngineState = engine.materialise_state(
                facts, program, max_rounds
            )
        self._book(None, calls)
        self.inflight_phase: str | None = None
        self._uids = itertools.count()
        self._uqueue: deque[UpdateTicket] = deque()
        self._qqueue: deque[QueryTicket] = deque()
        self._inflight: UpdateTicket | None = None
        self._gen = None
        self._snap: dict | None = None
        self._t_start = 0.0
        # one lock guards admission/queues/pending; the condition on it is
        # the worker's wakeup.  Published-snapshot reads are lock-free
        # (atomic reference load); publication swaps the reference at the
        # barrier.
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._batched = (
            BatchedExecutor(width=query_width, min_batch=min_batch,
                            dispatches=engine.dispatches)
            if batch_queries else None
        )
        self.publish_ms: list[float] = []
        self.publish_split: list[dict] = []  # each publication's stages, ms
        with self._maintaining():
            self._published: StoreSnapshot = self._publish()
        self.threaded = bool(threaded)
        self._worker = MaintenanceWorker(self) if threaded else None

    # -- read view -----------------------------------------------------------
    @property
    def epoch(self) -> int:
        """The published (last completed) maintenance epoch."""
        return self._published.epoch

    @property
    def snapshot(self) -> StoreSnapshot:
        """The published read view, built at each epoch barrier; while an
        update is mid-phase it is still the previous barrier's snapshot.
        Safe to read from any thread: publication replaces the reference
        and never writes a published snapshot."""
        return self._published

    @property
    def inflight(self) -> UpdateTicket | None:
        return self._inflight

    @property
    def dispatch_counts(self) -> dict:
        """The serving engine's units of work since it was made, as the
        reference reports them.

        ``by_phase`` attributes dispatches to the phase that issued them
        (``"<phase>/<family>"``: the generators' tags, ``"retry"``,
        ``"publish"`` and ``"query"``; a retried phase counts twice, the
        real cost); the base run counts in ``total`` and ``by_family``
        only.  Graph captures count under ``compiles_by_family``.  The
        static half is
        :func:`repro_torch.core.incremental_spmd.static_dispatch_profile`.
        """
        d = self.engine.dispatches
        return {
            "total": d.total,
            "by_family": dict(d.by_family),
            "by_phase": {
                f"{ph}/{fam}": n
                for (ph, fam), n in d.by_phase.items()
                if ph is not None
            },
            "compiles_by_family": dict(d.compiles),
        }

    @property
    def launch_counts(self) -> dict:
        """Kernel launches of the store by C entry point since it was made.

        ``by_phase`` keys are ``"<phase>/<entry point>"``: a maintenance
        step by the label it reached (``"add:prepared"``, ...,
        ``"<op>:forward"`` for the step that ends the update), ``"retry"``
        for a rolled-back attempt and its recovery, ``"publish"`` and
        ``"query"``; the base run counts in ``total`` and ``by_family``
        only.  A retried phase counts twice (the real cost).  Graph
        captures (each a first run of a fused round or wave) count under
        ``compiles_by_family``.
        """
        with self._ledger_lock:
            return {
                "total": sum(self._by_family.values()),
                "by_family": dict(self._by_family),
                "by_phase": {f"{ph}/{fn}": n
                             for (ph, fn), n in self._by_phase.items()},
                "compiles_by_family": dict(self.engine.dispatches.compiles),
            }

    def audit(self) -> list[str]:
        """Cross-check this store's observed dispatches against the static
        per-phase profile (the serving half of ``repro_torch.analysis``'s
        dispatch auditor).  Returns problem strings; empty means every
        (phase, family) dispatch pair was declared."""
        from repro_torch.analysis import dispatch_crosscheck  # lazy: serving core

        return dispatch_crosscheck(
            self.engine.dispatches, self.state.base_program
        )

    def pending(self) -> int:
        """Queued + in-flight work items (0 means ``drain`` would be a no-op).

        Safe to call concurrently with the worker thread: the queues are
        read under the admission lock, and an update the worker has popped
        but not finished still counts via the worker's busy flag.
        """
        with self._lock:
            n = len(self._uqueue) + len(self._qqueue)
            busy = self._worker is not None and self._worker.busy
            if self._inflight is not None or busy:
                n += 1
            return n

    # -- admission -----------------------------------------------------------
    def submit_update(self, op: str, delta) -> UpdateTicket:
        if op == "del":
            op = "delete"
        if op not in ("add", "delete"):
            raise ValueError(f"unknown update op {op!r}")
        t = UpdateTicket(
            next(self._uids), op, np.asarray(delta, np.int32).reshape(-1, 3)
        )
        with self._work:
            self._uqueue.append(t)
            self._work.notify()
        return t

    def submit_query(self, q: Query) -> QueryTicket:
        t = QueryTicket(next(self._uids), q)
        with self._lock:
            self._qqueue.append(t)
        return t

    def query_now(self, q: Query) -> QueryTicket:
        """Admit and answer immediately against the published snapshot;
        safe while an update is mid-phase on the worker thread."""
        t = self.submit_query(q)
        self._drain_queries()
        return t

    # -- scheduler -----------------------------------------------------------
    def step(self) -> bool:
        """One cooperative scheduler tick: answer queued reads at the
        published snapshot, then advance the in-flight maintenance operation
        by one phase (admitting the next queued update if none is in
        flight).  Returns True iff any work was done.  Disabled in threaded
        mode: the worker owns maintenance there."""
        if self.threaded:
            raise RuntimeError(
                "step() is the cooperative scheduler; this store runs "
                "threaded=True — use drain() / query_now()"
            )
        progressed = bool(self._qqueue)
        self._drain_queries()
        if self._inflight is None and self._uqueue:
            with self._lock:
                t = self._uqueue.popleft()
            self._begin(t)
        if self._inflight is not None:
            self._advance()
            progressed = True
        return progressed

    def drain(self, max_ticks: int = 100_000) -> "TripleStore":
        """Run until all queues are empty and no update is in flight; the
        published snapshot is then the newest epoch's.  Cooperative mode
        ticks the scheduler; threaded mode answers queued reads on this
        thread while waiting for the worker to reach its barrier(s), and
        re-raises any exception a background update died with."""
        if self.threaded:
            ticks = 0
            while True:
                self._drain_queries()
                self._worker.check()
                if self._worker.wait_idle(timeout=0.05):
                    self._drain_queries()
                    self._worker.check()
                    if not self.pending():
                        return self
                ticks += 1
                if ticks > max_ticks:
                    raise RuntimeError("drain did not converge")
        ticks = 0
        while self.pending():
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("drain did not converge")
        return self

    def close(self) -> None:
        """Stop the worker thread (threaded mode); idempotent."""
        if self._worker is not None:
            self._worker.stop()
            self._worker.check()
            self._worker = None
            self.threaded = False

    def __enter__(self) -> "TripleStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------
    def _maintaining(self):
        """The store's stream (on the card) for everything that touches the
        live state."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _reading(self):
        """This thread's reader stream (on the card)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stream = getattr(self._readers, "stream", None)
        if stream is None:
            stream = self._readers.stream = torch.cuda.Stream(self.engine.device)
        return torch.cuda.stream(stream)

    def _book(self, phase: str | None, calls: dict) -> None:
        with self._ledger_lock:
            for fn, n in calls.items():
                self._by_family[fn] += n
                if phase is not None:
                    self._by_phase[(phase, fn)] += n

    def _publish(self) -> StoreSnapshot:
        """Publish the current barrier's snapshot (timed), on the store's
        stream.  The host ``triples`` copy and rho's clique tables are built
        here too, so no reader pays a lazy build: the whole cost is the
        barrier's (``publish_ms``; the stages in ``publish_split``)."""
        t0 = time.perf_counter()
        with ops.tally() as calls:
            snap = self.engine.publish_snapshot(
                self.state, prev=getattr(self, "_published", None)
            )
        t1 = time.perf_counter()
        snap.triples  # noqa: B018  — eager host copy, charged to the barrier
        t2 = time.perf_counter()
        snap.rho.members, snap.rho.sizes, snap.rho._csr()  # expansion tables too
        t3 = time.perf_counter()
        self._book("publish", calls)
        ms = (t3 - t0) * 1e3
        self.publish_ms.append(ms)
        self.publish_split.append(dict(
            self.engine.last_publish, publish_snapshot_ms=(t1 - t0) * 1e3,
            host_copy_ms=(t2 - t1) * 1e3, tables_ms=(t3 - t2) * 1e3,
            total_ms=ms))
        return snap

    def _drain_queries(self) -> None:
        """Answer every queued query against one consistent snapshot.

        Grabs the whole queue in one locked pop, then evaluates the batch
        (in shape groups on the snapshot's device) outside the lock, on
        this thread's reader stream.  Concurrent callers pop disjoint
        batches, so this is safe from any thread.
        """
        while True:
            with self._lock:
                batch = list(self._qqueue)
                self._qqueue.clear()
            if not batch:
                return
            snap = self.snapshot
            with self._reading(), ops.tally() as calls:
                if self._batched is not None:
                    t0 = time.perf_counter()
                    res = self._query_phase(self._batched.run,
                                            [t.query for t in batch], snap, self.dic)
                    per = (time.perf_counter() - t0) / len(batch)
                    for t, (ans, ep) in zip(batch, res):
                        t.answer, t.epoch = ans, ep
                        t.wall_s, t.status = per, "done"
                else:
                    for t in batch:
                        t0 = time.perf_counter()
                        t.answer, t.epoch = evaluate_at(t.query, snap, self.dic)
                        t.wall_s = time.perf_counter() - t0
                        t.status = "done"
            self._book("query", calls)

    def _query_phase(self, fn, *args):
        """``fn(*args)`` with this thread's dispatches tagged ``"query"``."""
        dispatches = self.engine.dispatches
        prev_phase, dispatches.phase = dispatches.phase, "query"
        try:
            return fn(*args)
        finally:
            dispatches.phase = prev_phase

    def _run_one_update(self, t: UpdateTicket) -> None:
        """Begin an admitted update and advance it to its epoch barrier:
        the worker thread's unit of work (threaded mode only).

        A failed update must not wedge the scheduler: the state rolls back
        to the pre-update snapshot (readers were on the published snapshot
        all along) and the in-flight slot clears before the exception is
        parked for the caller's ``drain()``.
        """
        try:
            self._begin(t)
            while self._inflight is not None:
                self._advance()
        except BaseException:
            if self._snap is not None:
                self.engine._restore(self.state, self._snap)
            self._inflight, self._gen, self._snap = None, None, None
            self.inflight_phase = None
            raise

    def _make_gen(self, t: UpdateTicket):
        """The update's phase generator, with a fresh round log (made on
        the store's stream: it synchronises the stream it was made on)."""
        self.engine._log = RoundLog(self.engine.device)
        fn = spmd_add_phases if t.op == "add" else spmd_delete_phases
        return fn(self.engine, self.state, t.delta, self.max_rounds)

    def _begin(self, t: UpdateTicket) -> None:
        self._inflight = t
        t.status = "running"
        self._t_start = time.perf_counter()
        with self._maintaining():
            self.engine._maybe_reset_fallback(self.state)
            self._snap = self.engine._snapshot(self.state)
            self._gen = self._make_gen(t)
        self.inflight_phase = "admitted"

    def _advance(self) -> None:
        """Advance the in-flight operation by one phase, with capacity retry.

        On :class:`CapacityError` the state rolls back to the pre-update
        snapshot, the exhausted capacity grows, and the operation restarts
        from its first phase in the same tick; the published snapshot, and
        hence every reader, is unaffected.  ``stats.wall_seconds``
        accumulates only the time spent in here.
        """
        eng, t = self.engine, self._inflight
        t0 = time.perf_counter()
        try:
            with self._maintaining():
                while True:
                    eng._set_update_buffers(True)
                    err = None
                    with ops.tally() as calls:
                        try:
                            label = next(self._gen, None)
                        except CapacityError as e:
                            err = e
                    if err is None:
                        self._book(f"{t.op}:{label or 'forward'}", calls)
                        if label is None:
                            self._finish()
                        else:
                            self.inflight_phase = label
                        return
                    with ops.tally() as more:
                        eng._recover_capacity(self.state, self._snap, err)
                        self._snap = eng._snapshot(self.state)
                    self._book("retry", calls)
                    self._book("retry", more)
                    self._gen = self._make_gen(t)
                    self.inflight_phase = "admitted"
        finally:
            self.state.stats.wall_seconds += time.perf_counter() - t0

    def _finish(self) -> None:
        """Cross the epoch barrier and publish the new epoch's snapshot,
        eagerly: the build cost lands on the update that caused it
        (``ticket.publish_ms``), never on the first read."""
        t = self._inflight
        self.engine._barrier(self.state)
        self._published = self._publish()
        t.publish_ms = self.publish_ms[-1]
        t.epoch = self.state.update_epoch
        t.status = "done"
        t.wall_s = time.perf_counter() - self._t_start
        self._inflight, self._gen, self._snap = None, None, None
        self.inflight_phase = None
