"""Per-rank counts of one step of a cell: FLOPs, bytes, collective bytes
and memory.  The counterpart of ``repro.launch.hlo_costs`` and
``repro.launch.hlo_stats``.

The reference lowers a cell and reads the partitioned HLO text of one
device.  PyTorch has no HLO, so the port counts what one rank's eager
step dispatches, on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
data) under a ``TorchDispatchMode`` (:class:`StepCounter`):

* **FLOPs** by ``torch.utils.flop_counter``: the total from
  ``FlopCounterMode``, split by the dtype of each product's operands with
  the same formulas (``flop_registry``), since the H100's peak differs
  by dtype.
* **Bytes**: each aten op's operand bytes plus its result bytes, a result
  that is an operand (an in-place op) counted once; views and
  allocations of uninitialised memory are free.  The collectives' own ops
  are left to the collective count.
* **Hand-written kernels.** On CPU tensors each wrapper of
  :mod:`repro_torch.kernels.ops` runs its plain version; under the counter
  (a tracer of ``ops.traced`` with ``card_path`` set) it takes its card
  branch instead: it allocates what it allocates on the card (outputs and
  scratch, sized by :data:`CARD_SIZES` where the card's library would be
  asked) and, in place of the launch, books the kernel's own bytes and
  operations by the formula of PERF.md's Bound column for that kernel
  (:data:`KERNEL_COUNTS`, which ``chip_smoke.py`` computes its bounds
  with).  The counts are then those of the card's path.  Where a formula
  needs values (the union-find's hooked roots, the embedding bag's
  distinct sectors) the static form counts every row valid, no root moved
  and every lookup's row read.
* **Collectives**: the mesh's own counters (``Mesh.calls``/``Mesh.bytes``,
  keyed ``"<axes>:<op>"``, the bytes each rank sends), which the
  collectives of :mod:`repro_torch.core.collectives` keep on a ``fake``
  process group as on a real one.
* **Memory**: live bytes by storage: a storage is added when an op first
  returns it and taken away when it dies (a weak reference on the
  storage).  The peak counts the step's inputs; a donated input's storage
  stops counting once the step has made the output that replaces it (the
  reference aliases donated arguments the same way).  :meth:`StepCounter.memory`
  also lists the largest storages live at the peak, with the op that
  made each.

What the reference's HLO-only parts become:

* ``hlo_costs``' loop multipliers: none.  Eager execution dispatches every
  layer, chunk and remat recompute that it runs, so each op is counted as
  often as it runs.
* ``hlo_stats.collective_stats``: the mesh counters above.
* ``hlo_stats.duplicate_op_histogram`` (fusion roots by name): the top
  aten ops by count (:attr:`StepCounter.ops`), which still shows a remat
  recompute as doubled forward ops.
* ``dryrun._bf16_dup_bytes`` (XLA-CPU's f32 twins of bf16 stacks): no
  counterpart; eager PyTorch keeps no such twin.
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.compat import pytree

__all__ = ["CARD_SIZES", "HW", "KERNEL_COUNTS", "RATE", "StepCounter", "bound"]

SECTOR = 32  # bytes: the least a random read moves from device memory
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_", "_unsafe_view"}

# One H100 SXM at 700 W.  From NVIDIA's datasheet (dense rates): 989
# TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them (FFMA: the
# port runs f32 products with TF32 off), 3.35 TB/s and 80 GB of HBM.  The
# datasheet gives no INT32 rate; "int" is derived: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost (the clock at which 132 x 128 FP32 lanes x 2
# give the 67 T).  Links: a DGX H100 node holds 8 cards joined by NVLink 4
# (450 GB/s a direction); across nodes each card has one 400 Gb/s NDR port
# (50 GB/s).  None of these is a measurement.
HW = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "peak_ops_int": 132 * 64 * 1.98e9,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
    "cards_per_node": 8,
    "nvlink_bytes_per_s": 450e9,
    "network_bytes_per_s": 50e9,
}
RATE = {"bf16": HW["peak_flops_bf16"], "f32": HW["peak_flops_f32"],
        "int": HW["peak_ops_int"]}


def bound(n_bytes: float, ops: dict) -> tuple[float, str]:
    """The least time (seconds) the card takes to move ``n_bytes`` and do
    ``ops`` (kind -> operations, each kind at its peak), and which of the
    two sets it: ``"bytes"`` or ``"operations"``."""
    t_bytes = n_bytes / HW["hbm_bytes_per_s"]
    t_ops = sum(n / RATE[k] for k, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _log2c(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# -- the hand-written kernels: (bytes, {kind: operations}) of one launch, each
# input read once and each output written once; keyed by C entry point, called
# with the plain version's arguments and, where the work depends on values,
# what this launch's data needs (else the static form)
# kinds: "bf16" (tensor-core FLOPs), "f32" (FP32 FLOPs), "int" (integer ops)

def _dedup(keys):
    n = keys.shape[0]
    return 12 * n, {"int": n * _log2c(n)}


def _search(queries, keys, sides=2):
    """``sides``: the bounds written, 1 for ``searchsorted``."""
    n, v = queries.shape[0], keys.shape[0]
    return 8 * n + 8 * v + 4 * sides * n, {"int": sides * n * _log2c(v + 1)}


def _prefix(prefix_cols, keys):
    n, k = prefix_cols.shape
    v = keys.shape[0]
    return 4 * k * n + 8 * v + 8 * n, {"int": 2 * n * _log2c(v + 1)}


def _rewrite(spo, rho, valid=None, epoch=None, marked=None):
    n = spo.shape[0]
    masks = (n if valid is not None else 0) + (5 * n if epoch is not None else 0)
    return 12 * n + 4 * rho.shape[0] + masks + 12 * n + n, {"int": 4 * n}


def _compress(rep, n_moved=0):
    """``n_moved``: the entries that move (written)."""
    v = rep.shape[0]
    return 4 * v + 4 * n_moved, {"int": v}


def _union(rep, pairs, valid, n_valid=None, n_ends=None, n_hooked=0):
    """Every flag, the pair of each valid row and ``rep`` at each distinct
    endpoint read, the hooked roots written (static: every row valid,
    both ends distinct, none hooked)."""
    m = pairs.shape[0]
    k = m if n_valid is None else n_valid
    ends = 2 * k if n_ends is None else n_ends
    return m + 8 * k + 4 * ends + 4 * n_hooked, {"int": 2 * k}


def _flash(q, k, v, causal=True, q_offset=0):
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if causal:
        # admitted keys a query: min(t, q_offset + i + 1)
        full = max(0, min(s, t - q_offset))  # queries admitting fewer than t keys
        keys = sum(q_offset + i + 1 for i in range(full)) + (s - full) * t
        need = min(t, q_offset + s)
    else:
        keys, need = s * t, t
    size = q.element_size()
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return size * (2 * b * s * h * d + 2 * b * need * kv * d), {kind: 4 * d * h * b * keys}


def _fm(x):
    b, f, k = x.shape
    return x.element_size() * (b * f * k + b), {"f32": 3 * b * f * k}


def _segment(x, seg, n_segments):
    e, k = x.shape
    size = x.element_size()
    return size * e * k + 4 * e + size * n_segments * k, {"f32": e * k}


def _bag(ids, table, sectors=None):
    """``sectors``: the distinct 32-byte sectors of the table the lookups
    touch (static: every lookup reads its row's sectors)."""
    b, f = ids.shape
    k = table.shape[1]
    if sectors is None:
        sectors = -(-table.element_size() * k // SECTOR) * b * f
    return 4 * b * f + SECTOR * sectors + table.element_size() * b * k, {"f32": b * f * k}


KERNEL_COUNTS = {
    "dedup_order": _dedup, "search_bounds": _search, "prefix_range_bounds": _prefix,
    "rewrite_triples": _rewrite, "uf_compress": _compress, "uf_union": _union,
    "flash_attention": _flash, "fm_interact": _fm, "segment_sum": _segment,
    "embedding_bag": _bag,
}

# What the card's library answers when a wrapper sizes its scratch, as the
# sources compute it on an H100 SXM (132 SMs): the radix sort's scratch
# words (csrc/dedup_order.cu: 4,112 words of counts, bases and plans, and a
# status word pair a bucket a tile of 4,096 keys) and the segment sum's
# first-pass blocks (csrc/segment_sum.cu: 2,048 threads an SM, 256 a
# block).  chip_smoke.py holds both to the library's answers on the card.
CARD_SIZES = {
    "dedup_order_scratch_words": lambda n: 4112 + 2 * 256 * -(-n // 4096),
    "segment_sum_max_blocks": lambda: 132 * (2048 // 256),
}


class StepCounter(TorchDispatchMode):
    """Counts one rank's step (see the module's docstring).  Use as a
    dispatch mode above a ``FakeTensorMode`` and as the tracer of
    ``ops.traced``.  After the step: ``bytes``, ``flops_by_dtype``,
    ``kernel`` (bytes and operations of the hand-written kernels, and
    ``launches`` by C entry point), ``ops`` (aten ops by count) and
    :meth:`memory`."""

    card_path = True  # ops: each wrapper's card branch, its launch booked here

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.flops_by_dtype: Counter = Counter()
        self.kernel = {"bytes": 0, "ops": Counter(), "launches": Counter()}
        self.ops: Counter = Counter()
        self._live: dict = {}  # a live storage's address -> its serial
        self._meta: list = []  # serial -> (bytes, shape, dtype, op)
        self._events: list = []  # ("+", serial) / ("-", serial) in order
        self.marks: dict = {}  # name -> event index

    # -- memory ------------------------------------------------------------------------
    def _free(self, addr: int, serial: int) -> None:
        if self._live.get(addr) == serial:
            del self._live[addr]
            self._events.append(("-", serial))

    def track(self, t: torch.Tensor, op: str) -> None:
        """Count ``t``'s storage live (once)."""
        st = t.untyped_storage()
        addr = st._cdata
        serial = self._live.get(addr)
        if serial is None:
            serial = len(self._meta)
            self._live[addr] = serial
            self._meta.append((st.nbytes(), tuple(t.shape), str(t.dtype), op))
            self._events.append(("+", serial))
            weakref.finalize(st, self._free, addr, serial)

    def mark(self, name: str) -> None:
        self.marks[name] = len(self._events)

    def key_of(self, t: torch.Tensor) -> int:
        """The serial of ``t``'s live storage."""
        return self._live[t.untyped_storage()._cdata]

    def memory(self, donated: tuple = (), keep: int = 0) -> dict:
        """Replay the allocations: ``peak_bytes`` with each ``(old, new)``
        storage pair of ``donated`` aliased (``old`` stops counting when
        ``new`` is made), ``argument_bytes`` live at the mark ``"inputs"``
        and the ``keep`` largest storages live at the peak."""
        alias = {new: old for old, new in donated}
        live: dict = {}
        dropped: set = set()
        peak, at_peak = 0, {}
        total = 0
        args_end = self.marks.get("inputs", 0)
        argument_bytes = 0
        for i, (sign, key) in enumerate(self._events):
            nbytes = self._meta[key][0]
            if sign == "+":
                live[key] = nbytes
                total += nbytes
                old = alias.get(key)
                if old in live and old not in dropped:
                    total -= live[old]
                    dropped.add(old)
            elif key in live:
                if key not in dropped:
                    total -= live[key]
                del live[key]
                dropped.discard(key)
            if i + 1 == args_end:
                argument_bytes = total
            if total > peak:
                peak = total
                if keep:
                    at_peak = {k: v for k, v in live.items() if k not in dropped}
        top = sorted(at_peak, key=lambda k: -at_peak[k])[:keep]
        return {"peak_bytes": peak, "argument_bytes": argument_bytes,
                "peak_tensors": [dict(zip(("bytes", "shape", "dtype", "op"), self._meta[k]))
                                 for k in top]}

    # -- the dispatch ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = [o for o in pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]
        for o in outs:
            self.track(o, name)
        if func.namespace in ("c10d", "prim") or func.is_view or name in _FREE:
            return out
        ins = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        seen = {id(a) for a in ins}
        self.bytes += sum(_nbytes(a) for a in ins)
        self.bytes += sum(_nbytes(o) for o in outs if id(o) not in seen)
        self.ops[name] += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            dtype = ins[0].dtype if ins else torch.float32
            kind = "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"
            self.flops_by_dtype[kind] += flop_registry[packet](*args, **kwargs, out_val=out)
        return out

    # -- the kernel wrappers' tracer interface (ops.traced, card_path) -----------------
    def kernel_call(self, entry: str, args: tuple) -> None:
        """Book one launch of C entry point ``entry`` on the plain
        version's ``args``: :data:`KERNEL_COUNTS`' static form."""
        nbytes, n_ops = KERNEL_COUNTS[entry](*args)
        self.kernel["bytes"] += nbytes
        self.kernel["ops"].update(n_ops)
        self.kernel["launches"][entry] += 1

    def card_size(self, query: str, *args) -> int:
        return CARD_SIZES[query](*args)

    def flops(self) -> dict:
        """FLOPs and operations by kind: the aten products' by dtype plus
        the kernels'."""
        out = Counter(self.flops_by_dtype)
        out.update(self.kernel["ops"])
        return dict(out)
