"""The program's spans in a traced sub-window: which span of the program
each device operation and each idle gap belongs to.

The program (``repro_torch.core.spans``, on only when a run turns it on)
opens host ranges named ``rew.*`` and ``maint.*`` and, inside
its round and wave bodies, launches a no-op marker kernel at each stage's
entry (``span_mark_kernel<rew::sweep>``) and one at the body's end
(``span_mark_kernel<body::end>``).  A captured graph replays the markers
with the rest of its body.

Attribution, over events with the profiler's correlation ids
(:func:`events`):

* an operation launched by ``cudaGraphLaunch`` belongs to the stage of the
  last marker before it on the device clock (none after a ``body::end``);
* any other operation belongs to the innermost program span that encloses
  the runtime call that launched it (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...), found by the correlation id the two share, or
  where the trace has no such call, by the CPU operation its
  ``linked`` id names;
* the rest is left unattributed.

:func:`strip` leaves the program's markers and the device side of its
ranges out of a trace's plain records, as the harness's summary leaves out
its own spans and spin kernel: what the existing readers read is then the
same with the program's spans on as off.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

from . import costs
from .trace import MARK, SPAN

PROGRAM = ("rew.", "maint.")  # the program's span names
MARKER = "span_mark_kernel"
END = "body.end"
# the stages that split device work with nothing inside them: the round
# and wave stages and the call's own leaves
LEAVES = ("rew.merge", "rew.sweep", "rew.dedup", "rew.join", "rew.flags",
          "maint.tomb_join", "maint.od_step", "rew.upload", "rew.distinct",
          "rew.stats")
_STAGE = re.compile(r"span_mark_kernel<(\w+)::(\w+)>")


@dataclass(frozen=True)
class Ev:
    """One profiler event: times in us; ``device`` for the card's own;
    ``kind`` the profiler's activity type (``kernel``, ``gpu_memcpy``,
    ``cuda_runtime``, ``user_annotation``, ``cpu_op``, ...); ``corr`` its
    correlation id, ``linked`` the id of the event it is linked to."""

    name: str
    start: float
    end: float
    device: bool
    kind: str = ""
    thread: int = 0
    corr: int = 0
    linked: int = 0


def _kind(e, name: str, on_device: bool) -> str:
    """The profiler's activity type of a kineto event, or where this
    version of torch does not give it, the same read from its name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    if name.startswith("bench.") or is_program(name):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "gpu_memcpy" if name.startswith("Memcpy") else (
            "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def events(prof) -> list:
    """:class:`Ev` of every event of a finished ``torch.profiler`` session
    (times from the trace's start)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns() if hasattr(results, "trace_start_ns") else 0
    out = []
    for e in results.events():
        name = e.name()
        on_device = e.device_type() == DeviceType.CUDA
        start = (e.start_ns() - base) / 1e3
        out.append(Ev(name, start, start + e.duration_ns() / 1e3, on_device,
                      _kind(e, name, on_device), int(e.start_thread_id()),
                      int(e.correlation_id()), int(e.linked_correlation_id())))
    return out


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def stage_of(name: str) -> str | None:
    """``span_mark_kernel<rew::sweep>`` -> ``rew.sweep``; None for another
    operation."""
    m = _STAGE.search(name) if MARKER in name else None
    return f"{m.group(1)}.{m.group(2)}" if m else None


def strip(recs: list) -> list:
    """Plain records (``trace.records``) without the program's markers and
    the device side of its ranges; its host ranges stay (they label the
    idle gaps)."""
    return [r for r in recs
            if not (r[3] and (MARKER in r[0] or is_program(r[0])))]


def window(evs: list) -> tuple:
    """The traced sub-window in us, bounded as ``trace.summarise`` bounds
    it: the harness's spin kernels inside its ``bench.window`` span, else
    the span."""
    spans = [(e.start, e.end) for e in evs if not e.device and e.name == SPAN]
    if len(spans) != 1:
        raise ValueError(f"want one {SPAN!r} span in the trace, found {len(spans)}")
    t0, t1 = spans[0]
    marks = sorted((e.start, e.end) for e in evs
                   if e.device and MARK in e.name and t0 <= e.start <= t1)
    if len(marks) == 2:
        t0, t1 = marks[0][1], marks[1][0]
    return t0, t1


class _Innermost:
    """The innermost program span open at a time on a thread (the ranges
    nest: the latest begun among those that enclose it)."""

    def __init__(self, spans: list) -> None:
        self.by_thread: dict = {}
        for e in spans:
            self.by_thread.setdefault(e.thread, []).append(e)
        for v in self.by_thread.values():
            v.sort(key=lambda e: e.start)
        self.starts = {t: [e.start for e in v] for t, v in self.by_thread.items()}

    def at(self, thread: int, t: float):
        v = self.by_thread.get(thread)
        if not v:
            return None
        i = bisect.bisect_right(self.starts[thread], t) - 1
        while i >= 0:  # back from the latest begun: the first still open
            if v[i].end >= t:
                return v[i]
            i -= 1
        return None


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_self(spans: list, clip) -> dict:
    """Each span name's time in the window less its child spans' (a
    thread's spans in start order, the enclosing ones on a stack)."""
    out: dict = {}
    by_thread: dict = {}
    for e in spans:
        by_thread.setdefault(e.thread, []).append(e)
    for v in by_thread.values():
        stack: list = []
        for e in sorted(v, key=lambda e: (e.start, -e.end)):
            while stack and (stack[-1].end <= e.start or stack[-1].end < e.end):
                stack.pop()
            took = clip(e.start, e.end) / 1e3
            out[e.name] = out.get(e.name, 0.0) + took
            if stack:
                out[stack[-1].name] -= took
            stack.append(e)
    return out


def attribute(evs: list, t0: float | None = None, t1: float | None = None) -> dict:
    """The per-span table of the window ``[t0, t1]`` (default: the traced
    sub-window): ``spans`` maps each program span name to ``count``
    (spans begun in it), ``host_self_ms`` (their time in it less their
    child program spans'), ``device_ms`` (the operations attributed to it)
    and ``idle_ms`` (the device's idle gaps whose middle it spans, on the
    thread of the harness's window span); ``unattributed_ms`` is the device
    time attributed to no span and ``idle_outside_ms`` the idle time under
    none, ``glue`` splits the time of operations other than the
    hand-written kernels by span (``""`` for none), and ``matched`` counts
    operations by how they were attributed."""
    if t0 is None:
        t0, t1 = window(evs)

    def clip(a: float, b: float) -> float:
        return max(0.0, min(b, t1) - max(a, t0))

    spans = [e for e in evs if not e.device and is_program(e.name)]
    inner = _Innermost(spans)
    host = {}  # (a runtime call?, correlation id) -> the host event
    for e in evs:
        if not e.device and e.corr:
            host.setdefault((e.kind in ("cuda_runtime", "cuda_driver"), e.corr), e)
    table = {name: dict(count=0, host_self_ms=ms, device_ms=0.0, idle_ms=0.0)
             for name, ms in _host_self(spans, clip).items()}
    for e in spans:
        if t0 <= e.start <= t1:
            table[e.name]["count"] += 1

    def span_at(ev):
        span = inner.at(ev.thread, ev.start)
        return span.name if span is not None else None

    ops = sorted((e for e in evs if e.device and "annotation" not in e.kind
                  and MARK not in e.name), key=lambda e: e.start)
    stage = None
    unattributed = 0.0
    glue: dict = {}
    matched = dict(marker=0, runtime=0, linked=0, none=0)
    busy = []
    for e in ops:
        s = stage_of(e.name)
        if s is not None:
            stage = None if s == END else s
            continue
        took = clip(e.start, e.end)
        if took <= 0:
            continue
        busy.append([max(e.start, t0), min(e.end, t1)])
        call = host.get((True, e.corr)) if e.corr else None
        op = host.get((False, e.linked)) if e.linked else None
        if call is not None and "GraphLaunch" in call.name and stage is not None:
            name, how = stage, "marker"
        elif call is not None:
            name, how = span_at(call), "runtime"
        elif op is not None:
            name, how = span_at(op), "linked"
        else:
            name, how = stage, "marker"
        matched[how if name is not None else "none"] += 1
        if name is None:
            unattributed += took / 1e3
        else:
            table.setdefault(name, dict(count=0, host_self_ms=0.0, device_ms=0.0,
                                        idle_ms=0.0))["device_ms"] += took / 1e3
        if costs.kernel_of(e.name) is None:
            glue[name or ""] = glue.get(name or "", 0.0) + took / 1e3

    # the idle gaps, each labelled by the program span open at its middle
    # on the harness's thread
    main = next(e.thread for e in evs if not e.device and e.name == SPAN)
    edges = [t0] + [x for iv in _union(busy) for x in iv] + [t1]
    outside = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        span = inner.at(main, (a + b) / 2)
        if span is None:
            outside += (b - a) / 1e3
        else:
            table[span.name]["idle_ms"] += (b - a) / 1e3
    return dict(spans=table, unattributed_ms=unattributed, glue=glue,
                idle_outside_ms=outside, matched=matched)


def stage_ms(report: dict, stage: str, n_ops: int):
    """Device ms an operation in ``stage`` (None where the trace has no
    program span, as on a program without them)."""
    if not report["spans"] or not n_ops:
        return None
    return report["spans"].get(stage, {}).get("device_ms", 0.0) / n_ops


def leaf_share(report: dict):
    """The share (%) of the glue's device time that falls into a leaf
    (:data:`LEAVES`); None without glue or without program spans."""
    total = sum(report["glue"].values())
    if not report["spans"] or total <= 0:
        return None
    return 100.0 * sum(v for k, v in report["glue"].items() if k in LEAVES) / total


def pad_share(splits: list):
    """Padding keys over the keys handed to ``dedup_order`` (%), summed over
    the calls whose ``last_split`` counts them; None where none does."""
    keys = sum(s.get("sort_keys", 0) for s in splits)
    pad = sum(s.get("sort_pad_keys", 0) for s in splits)
    return 100.0 * pad / keys if keys else None


def _unprofiled(ops: list, splits: list | None = None) -> list:
    """The ``last_split`` of each change set run outside the traced
    sub-window: ``ops`` as ``ctx.ops`` (each holding its ``split``), or the
    record's ``ops`` with its ``splits`` beside them."""
    if splits is None:
        splits = [o.get("split") or {} for o in ops]
    return [s for o, s in zip(ops, splits) if not o.get("profiled")]


def split_ms(ctx, key: str):
    """Mean host ms a change set of the window's unprofiled ones spends in
    ``key`` of its ``last_split``: ``"wait"`` its reads over every attempt
    (``wait_s``), ``"host"`` the call less its reads (``call_s -
    wait_s``); None where the program's split has no such keys."""
    vals = [s["wait_s"] if key == "wait" else s["call_s"] - s["wait_s"]
            for s in _unprofiled(ctx.ops) if "wait_s" in s and "call_s" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None


def phase_wait_ms(ops: list, splits: list | None = None):
    """Mean host ms a change set of the unprofiled ones blocks in reads
    under each phase tag (``last_split["phase_wait_s"]``; ``"none"`` for
    the reads outside a phase, the barrier's), by tag; None where no split
    has them."""
    got = [s["phase_wait_s"] for s in _unprofiled(ops, splits) if "phase_wait_s" in s]
    if not got:
        return None
    out: dict = {}
    for waits in got:
        for tag, sec in waits.items():
            key = "none" if tag is None else tag
            out[key] = out.get(key, 0.0) + 1e3 * sec / len(got)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
