"""The recorder and the invariant passes of the trace audit.

The reference checks its hot-path contracts over jaxprs, what its compiled
functions bind.  The port runs eagerly, so it checks them over *recorded
traces*, what a unit of work did when it ran once (:func:`record`):

  * every aten op, by a ``TorchDispatchMode``: its name, and each tensor
    operand's and result's storage, shape, dtype and device.  On the CPU
    this sees the kernels' plain versions at work (their sorts and
    scatters), inside a ``plain:<entry point>`` scope;
  * every hand-written kernel launch (:func:`repro_torch.kernels.ops.traced`),
    with its operands' shapes: on the card the kernels are ctypes calls
    that the dispatch mode never sees;
  * every ``Tensor.tolist`` and ``Tensor.numpy``, which read a tensor to
    the host without an aten op on the CPU.

The passes keep the reference's names and :class:`Violation` fields.  A
trace records the ops that ran, not every branch a program could take, and
nesting is the plain-version scopes, not ``cond`` branches; each pass's
docstring says where it differs from the reference's.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.compat import pytree
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorMeta:
    """One tensor operand or result of a recorded event."""

    key: int          # its storage, numbered within the trace (views share it)
    shape: tuple
    dtype: torch.dtype
    device: str       # "cpu" | "cuda"

    @property
    def rows(self) -> int:
        return int(self.shape[0]) if self.shape else 0


@dataclass(frozen=True)
class Event:
    """One recorded step: an aten op, a kernel launch or a host read."""

    op: str           # "aten.sort.stable", a C entry point, "Tensor.tolist"
    kind: str         # "aten" | "launch" | "host"
    ins: tuple        # TensorMeta of the tensor operands, in argument order
    outs: tuple       # TensorMeta of the tensor results
    path: str         # "<top>", or the plain-version scopes it ran in
    note: str = ""    # "bool index" for an index op with a mask index

    @property
    def base(self) -> str:
        """The op without its overload: ``aten.sort.stable`` -> ``aten.sort``."""
        return ".".join(self.op.split(".")[:2]) if self.kind == "aten" else self.op


_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})


class _Recorder(TorchDispatchMode):
    """Records one thread's events (use through :func:`record`).  Every
    tensor it sees stays alive until the recorder goes, so storage numbers
    are never reused within a trace."""

    def __init__(self) -> None:
        super().__init__()
        self.events: list[Event] = []
        self._scopes: list[str] = []
        self._keep: list[torch.Tensor] = []
        self._keys: dict[int, int] = {}

    def _meta(self, t: torch.Tensor) -> TensorMeta:
        self._keep.append(t)
        cdata = t.untyped_storage()._cdata
        key = self._keys.setdefault(cdata, len(self._keys))
        return TensorMeta(key, tuple(t.shape), t.dtype, t.device.type)

    def _path(self, leaf: str | None = None) -> str:
        parts = self._scopes + ([leaf] if leaf else [])
        return "/".join(parts) if parts else "<top>"

    def _add(self, op, kind, ins, outs, note="", leaf=None) -> None:
        self.events.append(Event(
            op, kind, tuple(self._meta(t) for t in ins),
            tuple(self._meta(t) for t in outs), self._path(leaf), note))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = pytree.tree_flatten((args, kwargs))[0]
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        note = ""
        if ".".join(str(func).split(".")[:2]) in _INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            note = "bool index"
        self._add(str(func), "aten", ins, outs, note)
        return out

    # -- the kernel wrappers' tracer interface (ops.traced) -----------------
    def launch(self, fn: str, operands, capture) -> None:
        self._add(fn, "launch", operands, (), leaf="launch")

    @contextlib.contextmanager
    def plain(self, fn: str):
        self._scopes.append(f"plain:{fn}")
        try:
            yield
        finally:
            self._scopes.pop()

    def host(self, name: str, t: torch.Tensor) -> None:
        self._add(f"Tensor.{name}", "host", (t,), ())


# Tensor.tolist / Tensor.numpy report to this thread's recorder while one is
# recording: patched in while any recorder runs, restored after the last
_host = threading.local()
_patch_lock = threading.Lock()
_patch_users = 0
_HOST_METHODS = ("tolist", "numpy")
_originals: dict = {}


def _reporting(name: str, orig):
    def method(self, *args, **kwargs):
        rec = getattr(_host, "recorder", None)
        if rec is not None:
            rec.host(name, self)
        return orig(self, *args, **kwargs)

    method.__name__ = name
    return method


@contextlib.contextmanager
def _host_reads(rec: _Recorder):
    global _patch_users
    with _patch_lock:
        if _patch_users == 0:
            for name in _HOST_METHODS:
                # the class's own attribute, if any (None: inherited)
                _originals[name] = torch.Tensor.__dict__.get(name)
                setattr(torch.Tensor, name,
                        _reporting(name, getattr(torch.Tensor, name)))
        _patch_users += 1
    prev = getattr(_host, "recorder", None)
    _host.recorder = rec
    try:
        yield
    finally:
        _host.recorder = prev
        with _patch_lock:
            _patch_users -= 1
            if _patch_users == 0:
                for name in _HOST_METHODS:
                    orig = _originals.pop(name)
                    if orig is None:
                        delattr(torch.Tensor, name)
                    else:
                        setattr(torch.Tensor, name, orig)


def record(fn) -> tuple[Event, ...]:
    """Run ``fn()`` once on this thread and return what it did, in order."""
    rec = _Recorder()
    with _host_reads(rec), ops.traced(rec), rec:
        fn()
    return tuple(rec.events)


def _is_sort(ev: Event) -> bool:
    return (ev.kind == "aten" and ev.base in _SORT_OPS) or (
        ev.kind == "launch" and ev.op in _SORT_LAUNCHES)


def count_sorts_at_least(trace, n_rows: int) -> int:
    """Sorts in ``trace`` (aten sorts and ``dedup_order`` launches) with an
    operand of at least ``n_rows`` rows."""
    return sum(1 for ev in trace
               if _is_sort(ev) and any(m.rows >= n_rows for m in ev.ins))


# ---------------------------------------------------------------------------
# pass framework
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Violation:
    """One invariant violation found in a recorded unit."""

    pass_name: str
    fn: str          # label of the audited unit (registry name + variant)
    primitive: str   # offending op or kernel entry point
    path: str        # where it ran ("<top>", "plain:<entry>", ".../launch")
    detail: str      # human-readable explanation with the relevant shapes

    def as_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:  # the CLI's one-line form
        return (
            f"[{self.pass_name}] {self.fn}: {self.primitive} at {self.path}"
            f" — {self.detail}"
        )


class AnalysisPass:
    """Base class: subclasses set ``name`` and implement :meth:`run`.

    ``run(fn_label, trace, arena_rows)`` returns the violations found;
    ``arena_rows`` is the probe state's arena length, the threshold the
    length-sensitive passes compare leading dimensions against (the probe
    geometry keeps it strictly larger than every other buffer).
    """

    name: str = "base"

    def run(self, fn: str, trace, arena_rows: int) -> list[Violation]:
        raise NotImplementedError

    def _v(self, fn, ev: Event, detail: str) -> Violation:
        return Violation(self.name, fn, ev.op, ev.path, detail)


_SORT_OPS = frozenset({"aten.sort", "aten.argsort", "aten.msort"})
_SORT_LAUNCHES = frozenset({"dedup_order"})


class NoArenaSort(AnalysisPass):
    """No sort of arena-length operands in delta-path units.

    The persistent sorted index exists so that membership probes and joins
    never sort the arena; the allowed arena sorts are the index rebuild's
    and the publication's (registered with this pass skipped).  Sorts are
    aten sorts (``argsort`` records as ``aten.sort``; on the CPU the plain
    ``dedup_order`` is one) and ``dedup_order`` launches on the card.
    """

    name = "NoArenaSort"

    def run(self, fn, trace, arena_rows):
        out = []
        for ev in trace:
            if not _is_sort(ev):
                continue
            dims = [m.rows for m in ev.ins]
            if any(d >= arena_rows for d in dims):
                out.append(self._v(
                    fn, ev,
                    f"sort over {max(dims)} rows >= arena ({arena_rows}) — "
                    "hot-path joins must sort binding tables, never the arena",
                ))
        return out


_SCATTER_OPS = frozenset({
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
    "aten.scatter", "aten.scatter_", "aten.scatter_add", "aten.scatter_add_",
    "aten.scatter_reduce", "aten.scatter_reduce_", "aten.index_add",
    "aten.index_add_", "aten.index_copy", "aten.index_copy_",
    "aten.index_fill", "aten.index_fill_", "aten.index_reduce",
    "aten.index_reduce_",
})
# the union kernel hooks roots by pair: a scatter of its pair stream
_SCATTER_LAUNCHES = frozenset({"uf_union"})


class NoArenaScatter(AnalysisPass):
    """No scatter with an arena-length index or update stream in delta-path
    units.

    The stream side (every tensor operand after the destination: indices
    and values) must scale with the update stream; an arena-length
    destination updated in place is fine, as in the reference.  The
    per-resource mask reductions of the DRed wave units scatter
    arena-length index streams by design and register with this pass
    skipped.
    """

    name = "NoArenaScatter"

    def run(self, fn, trace, arena_rows):
        out = []
        for ev in trace:
            if not ((ev.kind == "aten" and ev.base in _SCATTER_OPS) or (
                    ev.kind == "launch" and ev.op in _SCATTER_LAUNCHES)):
                continue
            dims = [m.rows for m in ev.ins[1:]]
            if any(d >= arena_rows for d in dims):
                out.append(self._v(
                    fn, ev,
                    f"scatter updates {max(dims)} rows >= arena "
                    f"({arena_rows}) — delta-path scatters must scale with "
                    "the update stream",
                ))
        return out


class DtypeSafety(AnalysisPass):
    """Packed int64 keys must never be truncated to a narrower dtype.

    A taint analysis over the trace, per storage: an int64 left shift
    seeds it (the packing idiom), value-preserving ops carry it (bitwise
    or/and/xor, add, sub, max/min, clamp, where, views and slices, cat,
    stack, copies; gathers only from a tainted source; a sort only to its
    sorted values), and a cast (``_to_copy``) or a copy into a narrower
    dtype of a tainted tensor is flagged.  Unlike the reference's
    per-jaxpr analysis, one trace is one flow: a key packed in a helper
    stays tainted in its caller, and an in-place write taints its whole
    storage.  A kernel launch carries no taint: each wrapper checks its
    dtypes.
    """

    name = "DtypeSafety"

    _SEEDS = frozenset({"aten.__lshift__", "aten.__ilshift__",
                        "aten.bitwise_left_shift", "aten.bitwise_left_shift_"})
    _PROPAGATE = frozenset({
        "aten.bitwise_or", "aten.bitwise_or_", "aten.__or__", "aten.__ior__",
        "aten.bitwise_and", "aten.bitwise_and_", "aten.__and__", "aten.__iand__",
        "aten.bitwise_xor", "aten.bitwise_xor_", "aten.__xor__", "aten.__ixor__",
        "aten.add", "aten.add_", "aten.sub", "aten.sub_", "aten.maximum",
        "aten.minimum", "aten.max", "aten.min", "aten.clamp", "aten.clamp_",
        "aten.where", "aten.slice", "aten.select", "aten.narrow", "aten.view",
        "aten._unsafe_view", "aten.reshape", "aten._reshape_alias",
        "aten.expand", "aten.squeeze", "aten.unsqueeze", "aten.cat",
        "aten.stack", "aten.clone", "aten.alias", "aten.detach", "aten.flip",
        "aten.t", "aten.permute", "aten.transpose", "aten.constant_pad_nd",
        "aten.lift_fresh",
    })
    _GATHERS = frozenset({"aten.index", "aten.gather", "aten.index_select",
                          "aten.take"})

    def run(self, fn, trace, arena_rows):
        out = []
        taint: set[int] = set()

        def tainted(m: TensorMeta) -> bool:
            return m.key in taint

        for ev in trace:
            if ev.kind != "aten":
                continue
            op = ev.base
            if op in self._SEEDS and any(m.dtype == torch.int64 for m in ev.outs):
                taint.update(m.key for m in ev.outs)
            elif op == "aten._to_copy" and ev.ins and tainted(ev.ins[0]):
                src, dst = ev.ins[0], ev.outs[0]
                if dst.dtype.itemsize < src.dtype.itemsize:
                    out.append(self._narrowed(fn, ev, src, dst))
                else:
                    taint.add(dst.key)
            elif op == "aten.copy_" and len(ev.ins) >= 2 and tainted(ev.ins[1]):
                dst, src = ev.ins[0], ev.ins[1]
                if dst.dtype.itemsize < src.dtype.itemsize:
                    out.append(self._narrowed(fn, ev, src, dst))
                else:
                    taint.add(dst.key)
            elif op == "aten.sort" and ev.ins and tainted(ev.ins[0]):
                taint.add(ev.outs[0].key)  # the values, not the indices
            elif op in self._GATHERS and ev.ins and tainted(ev.ins[0]):
                taint.update(m.key for m in ev.outs)
            elif op in self._PROPAGATE and any(map(tainted, ev.ins)):
                taint.update(m.key for m in ev.outs)
        return out

    def _narrowed(self, fn, ev, src, dst) -> Violation:
        return self._v(
            fn, ev,
            f"packed {src.dtype} key truncated to {dst.dtype} — 63-bit "
            "packed triple keys must stay int64 end to end",
        )


_HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.equal", "aten.is_nonzero",
    "aten.nonzero", "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.unique_dim_consecutive",
})


def host_read(ev: Event) -> bool:
    """Does the event wait for the device and read its data on the host?
    A scalar read (``.item()``, ``int()``, ``bool()``), a data-sized
    result (``nonzero``, a mask index, ``unique``...), a copy from the card
    to the CPU, or ``tolist``/``numpy``."""
    if ev.kind == "host":
        return True
    if ev.kind != "aten":
        return False
    return (ev.base in _HOST_READ_OPS or ev.note == "bool index"
            or (any(m.device == "cuda" for m in ev.ins)
                and any(m.device == "cpu" for m in ev.outs)))


class NoHostCallback(AnalysisPass):
    """No host read inside a unit's body.

    The reference forbids host callbacks in compiled code: a device-to-host
    round trip per dispatch.  The port's counterpart is any event that waits
    for the device and reads its data on the host (:func:`host_read`).
    Reads inside a kernel's plain version (a ``plain:`` scope, on the CPU
    only) are not the unit's: on the card the same call is one launch that
    reads nothing back (the union-find's plain loop tests convergence on
    the host; its kernel does not).
    """

    name = "NoHostCallback"

    def run(self, fn, trace, arena_rows):
        return [
            self._v(fn, ev, "host read inside a unit's body — one "
                            "device-to-host round trip per dispatch")
            for ev in trace
            if host_read(ev) and not ev.path.startswith("plain:")
        ]


ALL_PASSES: tuple[AnalysisPass, ...] = (
    NoArenaSort(),
    NoArenaScatter(),
    DtypeSafety(),
    NoHostCallback(),
)
