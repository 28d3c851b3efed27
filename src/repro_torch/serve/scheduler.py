"""Maintenance worker thread: updates off the query path.

A copy of ``repro.serve.scheduler``.  :class:`MaintenanceWorker` is the
threaded half of the serving scheduler
(:mod:`repro_torch.serve.triple_store`).  It owns NO state of its own beyond the
thread and two flags — the update queue, the in-flight ticket and the
engine state all live on the :class:`~repro_torch.serve.triple_store.TripleStore`
— and consumes the store's update queue under the store's condition
variable, running each admitted operation's maintenance phases to its epoch
barrier (capacity retries included) exactly like the cooperative
``step()`` loop does, just on this thread instead of the caller's.

Why this is safe (the reference's thread-safety argument):

  * the worker is the ONLY thread that touches the live
    :class:`~repro_torch.core.engine.EngineState` — readers never do;
  * readers see the store exclusively through the *published*
    :class:`~repro_torch.core.engine.StoreSnapshot`, whose publication is a
    single reference assignment (atomic under the GIL) at the epoch
    barrier; snapshots are immutable after publication and the swap
    retires the previous buffers by dropping the reference, so a lagging
    reader holding an old snapshot keeps it alive — buffers are never
    donated or mutated out from under anyone;
  * admission (queue appends) and ``pending()`` take the store's lock;
  * kernel launches are tallied per thread
    (:func:`repro_torch.kernels.ops.tally`), so the worker's maintenance
    phases and concurrent readers' ``"query"`` launches cannot
    mis-attribute each other;
  * on the card the store's maintenance runs on a stream of its own and
    captures its graphs in the thread-local error mode, so a reader's
    launches, copies and synchronisations never enter or break a capture
    (:mod:`repro_torch.serve.triple_store`).

A failed update parks its exception on :attr:`error` (and the ticket's
status becomes ``"failed"``); the store's ``drain()`` re-raises it on the
caller's thread rather than letting it die silently on this one.
"""

from __future__ import annotations

import threading

__all__ = ["MaintenanceWorker"]


class MaintenanceWorker:
    """Daemon thread draining a TripleStore's update queue to epoch barriers."""

    def __init__(self, store, name: str = "repro-torch-maintenance") -> None:
        self._store = store
        self._stop = False
        self._busy = False
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    @property
    def busy(self) -> bool:
        """True while an update is being advanced (popped but not finished)."""
        return self._busy

    def _loop(self) -> None:
        store = self._store
        cond = store._work
        while True:
            with cond:
                while not store._uqueue and not self._stop:
                    cond.wait()
                if self._stop and not store._uqueue:
                    return
                ticket = store._uqueue.popleft()
                self._busy = True
            try:
                store._run_one_update(ticket)
            except BaseException as e:  # surface on the caller's thread
                ticket.status = "failed"
                self.error = e
            finally:
                with cond:
                    self._busy = False
                    cond.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the update queue is empty and no update is in flight.

        Returns False on timeout.  Queries are NOT waited on — they drain
        on reader threads against the published snapshot.
        """
        with self._store._work:
            return self._store._work.wait_for(
                lambda: not self._store._uqueue and not self._busy, timeout
            )

    def check(self) -> None:
        """Re-raise (once) an exception a background update died with."""
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def stop(self, timeout: float | None = 30.0) -> None:
        """Graceful shutdown: finish queued updates, then exit the thread."""
        with self._store._work:
            self._stop = True
            self._store._work.notify_all()
        self._thread.join(timeout)
