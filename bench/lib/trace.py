"""What the profiler's trace of the traced sub-window says: device busy
time, device time by operation, the port's kernels apart from the rest
(glue), the idle gaps labelled by what the host was doing, and how many
launches of each hand-written kernel the trace kept.

It works on plain records, ``(name, start_us, end_us, on_device)``, so the
arithmetic is tested on synthetic traces; :func:`records` makes them from
a ``torch.profiler`` session.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from . import costs

SPAN = "bench.window"  # the host span that bounds the traced sub-window
OURS = "bench."  # the harness's spans (the profiler marks them on the device too)
MARK = "spin_kernel"  # torch.cuda._sleep's kernel: the sub-window's ends on the device
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float
    port_s: dict = field(default_factory=dict)     # kernel -> device seconds
    glue_s: float = 0.0                            # other device operations
    kept: dict = field(default_factory=dict)       # kernel -> marker events
    device_ops: list = field(default_factory=list)  # [[name, seconds]], top
    idle_gaps: list = field(default_factory=list)   # [[host label, seconds]], top

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def records(prof) -> list:
    """``(name, start_us, end_us, on_device)`` of every event of a
    finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        out.append((e.name, float(e.time_range.start), float(e.time_range.end),
                    on_device))
    return out


def short(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters (copies and sets keep theirs)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut]


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarise(recs: list, span: str = SPAN) -> Summary:
    """The sub-window runs from the end of the first device marker to the
    start of the second (``MARK``: the harness launches one at each end of
    the span, so the device's own clock bounds it), or is the host span
    named ``span`` where the trace has no two markers; device events are
    clipped to it."""
    spans = [(a, b) for name, a, b, dev in recs if not dev and name == span]
    if len(spans) != 1:
        raise ValueError(f"want one {span!r} span in the trace, found {len(spans)}")
    t0, t1 = spans[0]
    marks = sorted((a, b) for name, a, b, dev in recs if dev and MARK in name
                   and t0 <= a <= t1)
    if len(marks) == 2:
        t0, t1 = marks[0][1], marks[1][0]
    device, host = [], []
    for name, a, b, dev in recs:
        a, b = max(a, t0), min(b, t1)
        if b <= a or (dev and (name.startswith(OURS) or MARK in name)):
            continue
        (device if dev else host).append((name, a, b))
    busy = _union([[a, b] for _, a, b in device])
    s = Summary(window_s=(t1 - t0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6)
    by_name: dict = {}
    for name, a, b in device:
        by_name[short(name)] = by_name.get(short(name), 0.0) + (b - a) / 1e6
        kernel = costs.kernel_of(name)
        if kernel is None:
            s.glue_s += (b - a) / 1e6
        else:
            s.port_s[kernel] = s.port_s.get(kernel, 0.0) + (b - a) / 1e6
            if costs.MARKER[kernel] in name:
                s.kept[kernel] = s.kept.get(kernel, 0) + 1
    s.device_ops = [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    # the gaps between busy intervals, each labelled by the innermost host
    # event (other than the span) under its middle: a sweep over the gaps
    # in time order with a heap of the host events begun, shortest first
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    inner = sorted((a, b, name) for name, a, b in host if name != span)
    gaps: dict = {}
    heap: list = []
    nxt = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while nxt < len(inner) and inner[nxt][0] <= mid:
            ha, hb, name = inner[nxt]
            heapq.heappush(heap, (hb - ha, hb, name))
            nxt += 1
        while heap and heap[0][1] < mid:  # ended: never under a later gap
            heapq.heappop(heap)
        label = heap[0][2] if heap else "host, outside any traced call"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    s.idle_gaps = [[n, t] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]
    return s


def lost_launches(summary: Summary, launches: dict) -> dict:
    """Per hand-written kernel, the launches with work the census counted
    in the sub-window that the trace did not keep (non-zero: the trace is
    not whole, and no share of it may be read)."""
    want: dict = {}
    for (entry, shapes), n in launches.items():
        if costs.has_work(entry, shapes):
            k = costs.KERNEL_OF_ENTRY[entry]
            want[k] = want.get(k, 0) + n
    return {k: n - summary.kept.get(k, 0) for k, n in want.items()
            if n != summary.kept.get(k, 0)}
