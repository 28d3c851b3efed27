"""The port's spans: where a profiler's trace puts the program's host work
and the device work of its captured graphs.  Off by default.

``enable(True)`` turns them on for the whole process; off, each site costs
one test of a boolean (:func:`span` then hands back one shared null
context).  On:

* :func:`span` opens a ``torch.profiler.record_function`` range while a
  profiler session records this thread, so the session holds it in the
  same trace, on the same clock, as the device operations; ranges on one
  thread nest, each inside the one open when it began.  With no session
  recording it opens nothing: a range would record nothing there, and
  making one costs the host several microseconds.
* :func:`phase` gives each maintenance phase tag its range
  (``DispatchCounter.phase`` calls it): setting a tag closes the previous
  phase's range on this thread and opens the next one.
* :func:`stage` marks a stage of a round or wave body: it closes the
  previous stage's range and opens this one's, and on the card launches a
  no-op marker kernel named after the stage (``span_mark<rew::sweep>``,
  ``kernels/marks/span_mark.cu``).  A graph captured with tracing on
  records the markers, so every replay carries them and the device clock
  splits a replay by stage: a device operation belongs to the stage of the
  last marker before it.  :func:`stage_end` marks a body's end.  The marker
  is no hand-written kernel of :mod:`repro_torch.kernels.ops`: it is booked
  in neither ``ops.LAUNCHES`` nor a capture's recording and never reaches
  an ``ops.traced`` tracer.  A graph captured with tracing off holds none.
* :func:`count_sorted` adds the keys handed to ``dedup_order`` at a call
  site, and how many of them are valid (the rest are the stream's KEY_MAX
  padding), into the device-resident counter that the engine call running
  on this thread hands to :func:`counting_sorts` (the engine's own static
  buffer, so a capture records the add into it); the engine reads it in
  the read it makes anyway at the call's end.

Every range a thread opens sits on that thread's stack: closing a range
closes the ranges opened after it and left open (a round that raised
before its end), so the ranges always nest.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = [
    "MARKS",
    "close_span",
    "count_sorted",
    "counting_sorts",
    "enable",
    "enabled",
    "marks_recorded",
    "open_span",
    "phase",
    "phase_span",
    "span",
    "stage",
    "stage_end",
]

# the marker kernel's instances, in the order of its C entry point's switch
# (``kernels/marks/span_mark.cu``): the round stages by ``process_static``'s
# numbering and ``forward_round``'s tail, the wave stages, a body's end
MARKS = ("rew.merge", "rew.sweep", "rew.dedup", "rew.join", "rew.flags",
         "maint.tomb_join", "maint.od_step", "body.end")
_END = MARKS.index("body.end")
# the phase tags that get a range: the maintenance phases and the capacity
# retry (the serving tier's "publish" and "query" tags close the range open
# on their thread and open none)
_MAINT = ("add:", "delete:", "retry")

_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()  # .stack, .phase, .stage, .marks, .sorts
_mark_fn = None  # the marker's C entry point, loaded at its first launch


def enable(on: bool = True) -> None:
    """Turn the spans, stage markers and the sort counter on or off for the
    process.  Graphs keep what they were captured with."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _recording() -> bool:
    """A profiler session records this thread."""
    return torch.autograd._profiler_enabled()


def _open(name: str):
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    _stack().append(rf)
    return rf


def _close(rf) -> None:
    """Close ``rf`` and every range this thread opened after it; nothing
    when it is closed already."""
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is rf:
            for r in reversed(stack[i:]):
                r.__exit__(None, None, None)
            del stack[i:]
            return


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.rf = _open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        _close(self.rf)


def span(name: str):
    """A context manager: the host range ``name`` while the spans are on
    and a profiler session records this thread, else a shared null
    context."""
    return _Span(name) if _on and _recording() else _NULL


def open_span(name: str):
    """Open the range ``name`` (spans on, a session recording) and return
    its handle for :func:`close_span`; else None."""
    return _open(name) if _on and _recording() else None


def close_span(rf) -> None:
    if rf is not None:
        _close(rf)


def phase_span(tag: str) -> str | None:
    """The range name of a maintenance phase tag: ``"delete:wave"`` ->
    ``"maint.delete.wave"``, ``"retry"`` -> ``"maint.retry"``; None for
    another tag (``"query"``)."""
    return f"maint.{tag.replace(':', '.')}" if tag.startswith(_MAINT) else None


def phase(tag: str | None) -> None:
    """Close this thread's phase range and open ``tag``'s (none for None or
    a tag that is no maintenance phase)."""
    prev = getattr(_local, "phase", None)
    _local.phase = None
    if prev is not None:
        _close(prev)
    name = phase_span(tag) if tag is not None else None
    if name is not None and _on and _recording():
        _local.phase = _open(name)


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _launch_mark(index: int, device: torch.device) -> None:
    global _mark_fn
    if _mark_fn is None:
        import ctypes

        from repro_torch.kernels._build import library

        fn = library("span_mark").span_mark
        fn.argtypes = (ctypes.c_int, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        _mark_fn = fn
    err = _mark_fn(index, torch._C._cuda_getCurrentRawStream(_indexed(device).index))
    if err != 0:
        raise RuntimeError(f"span marker failed to launch: error {err}")


def _mark(index: int, device: torch.device) -> None:
    prev = getattr(_local, "stage", None)
    _local.stage = None
    if prev is not None:
        _close(prev)
    if device.type == "cuda":
        _launch_mark(index, device)
    marks = getattr(_local, "marks", None)
    if marks is not None:
        marks.append(MARKS[index])
    if index != _END and _recording():
        _local.stage = _open(MARKS[index])


def stage(name: str, device: torch.device) -> None:
    """Stage ``name`` (one of :data:`MARKS`) of a round or wave body begins:
    its range opens in place of the previous stage's (a session
    recording), and on the card its marker kernel runs on the current
    stream, recorded or not (a capture keeps it).  Nothing while the spans
    are off."""
    if _on:
        _mark(MARKS.index(name), device)


def stage_end(device: torch.device) -> None:
    """A round or wave body ends: the last stage's range closes and, on the
    card, the ``body.end`` marker runs."""
    if _on:
        _mark(_END, device)


@contextlib.contextmanager
def marks_recorded():
    """A list of the stage markers this thread launches inside the block,
    in order (a capture's stages)."""
    prev = getattr(_local, "marks", None)
    _local.marks = marks = []
    try:
        yield marks
    finally:
        _local.marks = prev


class _Counting:
    __slots__ = ("buf", "prev")

    def __init__(self, buf: torch.Tensor) -> None:
        self.buf = buf

    def __enter__(self):
        self.prev = getattr(_local, "sorts", None)
        _local.sorts = self.buf
        return self

    def __exit__(self, *exc) -> None:
        _local.sorts = self.prev


def counting_sorts(buf: torch.Tensor | None):
    """A context manager: inside it, :func:`count_sorted` on this thread
    adds into ``buf``, the caller's ``int64 [keys, valid keys]`` on its
    device; for None (the spans off) the shared null context."""
    return _Counting(buf) if buf is not None else _NULL


def count_sorted(valid: torch.Tensor) -> None:
    """Count the keys a call site hands to ``dedup_order``: ``valid`` is
    its mask of real keys, the rest being KEY_MAX padding (spans on, inside
    :func:`counting_sorts`)."""
    if _on:
        buf = getattr(_local, "sorts", None)
        if buf is not None:
            buf[0].add_(valid.shape[0])
            buf[1].add_(valid.sum())
