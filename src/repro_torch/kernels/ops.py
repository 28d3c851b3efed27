"""Dispatchers for the hand-written kernels.

Every function checks its tensors (device, dtype, shape, contiguity or
strides) and then runs the CUDA kernel for tensors on the card or the plain
version (:mod:`repro_torch.kernels.ref`) for tensors on the CPU.  There is
no other route: a CUDA tensor gets the kernel or an exception, never the
plain version.  ``LAUNCHES`` counts, per kernel, the calls that launched it
on the card — the proof that a run went through the kernels — and
:func:`tally` counts one thread's launches by C entry point (the prefix
form of the search apart from its point form), for the serving tier's
per-phase ledger.  The kernels
serve four paths: REW materialisation (dedup, search, rewrite, union-find),
LM serving (flash attention), FM serving (the FM interaction and the
embedding bag) and GNN inference (the segment sum, with its plan built by
dedup and search, and the graph's sameAs dedup by rewrite and dedup).

Kernel launches use PyTorch's current stream, allocate nothing inside the
kernel (outputs and scratch come from ``torch.empty`` here) and never
synchronise; a non-zero ``cudaGetLastError`` after a launch raises.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import dataclasses
import functools
import threading

import torch

from . import ref
from ._build import library

KERNELS = ("dedup_order", "search_bounds", "rewrite_triples",
           "uf_compress", "uf_union", "flash_attention", "fm_interact",
           "segment_sum", "embedding_bag")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_N = ctypes.c_longlong
# C entry point -> (source in csrc/, launch counter, argument types without
# the trailing stream)
_ENTRIES = {
    "dedup_order": ("dedup_order", "dedup_order",
                    (_P, _N, _P, _P, _P, _P, _P, _N, _P)),
    "search_bounds": ("search_bounds", "search_bounds", (_P, _N, _P, _N, _P, _P)),
    "prefix_range_bounds": ("search_bounds", "search_bounds",
                            (_P, _N, ctypes.c_int, _P, _N, _P, _P)),
    "rewrite_triples": ("rewrite_triples", "rewrite_triples",
                        (_P, _N, _P, _N, _P, _P, _P, _P, _P)),
    "uf_compress": ("union_find", "uf_compress", (_P, _N)),
    "uf_union": ("union_find", "uf_union", (_P, _N, _P, _P, _N)),
    "flash_attention": ("flash_attention", "flash_attention",
                        (_P, ctypes.c_float)),  # 22 int64 arguments packed
    "fm_interact": ("fm_interact", "fm_interact",
                    (_P, _P, _N, ctypes.c_int, ctypes.c_int, ctypes.c_int)),
    "segment_sum": ("segment_sum", "segment_sum",
                    (_P, _P, _P, _P, _N, _N, ctypes.c_int, _P, _P, _N,
                     ctypes.c_int)),
    "embedding_bag": ("embedding_bag", "embedding_bag",
                      (_P, _P, _N, ctypes.c_int, _N, ctypes.c_int, _P,
                       ctypes.c_int)),
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (all paths)."""
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# launches are counted from any thread (the serving tier's maintenance
# worker and its readers launch at once): ``LAUNCHES`` under a lock, the
# per-thread tallies and the capture's recording in thread-local state
_count_lock = threading.Lock()
_local = threading.local()


def book(calls: dict[str, int]) -> None:
    """Count ``calls`` (C entry point -> launches): into ``LAUNCHES`` by
    kernel and into this thread's open :func:`tally` dicts, or, while this
    thread records a capture (:func:`recording`), into the recording
    alone.  A graph replay books its capture's calls."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        for fn, n in calls.items():
            rec[fn] = rec.get(fn, 0) + n
        return
    with _count_lock:
        for fn, n in calls.items():
            LAUNCHES[_ENTRIES[fn][1]] += n
    for t in getattr(_local, "tallies", ()):
        for fn, n in calls.items():
            t[fn] = t.get(fn, 0) + n


@contextlib.contextmanager
def tally():
    """A dict that counts this thread's launches inside the block, by C
    entry point (``prefix_range_bounds`` apart from ``search_bounds``);
    blocks nest, and each open tally counts."""
    counts: dict[str, int] = {}
    stack = getattr(_local, "tallies", ())
    _local.tallies = (*stack, counts)
    try:
        yield counts
    finally:
        _local.tallies = stack


@contextlib.contextmanager
def recording():
    """A dict that takes this thread's launches inside the block by C entry
    point, counted nowhere else: a graph capture records what a replay
    launches without running it."""
    counts: dict[str, int] = {}
    prev = getattr(_local, "recording", None)
    _local.recording = counts
    try:
        yield counts
    finally:
        _local.recording = prev


def by_kernel(calls: dict[str, int]) -> dict[str, int]:
    """Launches by C entry point summed by kernel (``LAUNCHES``'s keys)."""
    out: dict[str, int] = {}
    for fn, n in calls.items():
        k = _ENTRIES[fn][1]
        out[k] = out.get(k, 0) + n
    return out


_entry_points: dict = {}


def _entry(fn: str):
    """The typed ctypes function of one C entry point, loaded once."""
    entry = _entry_points.get(fn)
    if entry is None:
        source, _, argtypes = _ENTRIES[fn]
        entry = getattr(library(source), fn)
        entry.argtypes = (*argtypes, _P)
        entry.restype = ctypes.c_int
        _entry_points[fn] = entry
    return entry


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream, raise on a
    non-zero ``cudaGetLastError``, and count the launch.  The host work per
    call is kept small (a cached entry point, the raw stream handle, the
    device switched only when it is not the current one): a small kernel's
    call time is mostly this."""
    entry = _entry(fn)
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        err = entry(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err}")
    book({fn: 1})


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           width: int | None = None) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(
            f"{name}: want {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}"
        )
    if width is not None and t.shape[1] != width:
        raise ValueError(f"{name}: want {width} columns, got {t.shape[1]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dedup_order_scratch_words(n: int) -> int:
    """32-bit scratch words the dedup_order kernel needs for ``n`` keys, as
    its source lays them out (digit counts, plans, tile status words)."""
    entry = library("dedup_order").dedup_order_scratch_words
    entry.argtypes = (_N,)
    entry.restype = _N
    return entry(n)


def dedup_order(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation (int32) of int64 ``keys``."""
    _check(keys, "keys", torch.int64, 1)
    if not _on_card(keys):
        return ref.dedup_order(keys)
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"dedup_order kernel: {n} keys, want < 2^31")
    dev = keys.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    kbuf = torch.empty((2, n), dtype=torch.int64, device=dev)
    ibuf = torch.empty((2, n), dtype=torch.int32, device=dev)
    scratch = torch.zeros(dedup_order_scratch_words(n), dtype=torch.int32,
                          device=dev)
    _launch("dedup_order", dev, keys.data_ptr(), n, kbuf[0].data_ptr(),
            kbuf[1].data_ptr(), ibuf[0].data_ptr(), ibuf[1].data_ptr(),
            scratch.data_ptr(), scratch.numel(), out.data_ptr())
    return out


def _search(queries, keys, lo: bool, hi: bool):
    _check(queries, "queries", torch.int64, 1)
    _check(keys, "keys", torch.int64, 1)
    if not _on_card(queries, keys):
        lo_t, hi_t = ref.search_bounds(queries, keys)
        return lo_t if lo else None, hi_t if hi else None
    n = queries.shape[0]
    outs = [torch.empty(n, dtype=torch.int32, device=keys.device) if want
            else None for want in (lo, hi)]
    if n:
        _launch("search_bounds", keys.device, queries.data_ptr(), n,
                keys.data_ptr(), keys.shape[0], _ptr(outs[0]), _ptr(outs[1]))
    return outs[0], outs[1]


def search_bounds(queries: torch.Tensor, keys: torch.Tensor):
    """``(#{keys < q}, #{keys <= q})`` (int32) of int64 queries in sorted
    int64 ``keys``."""
    return _search(queries, keys, True, True)


def searchsorted(keys: torch.Tensor, queries: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """One side of :func:`search_bounds`: ``torch.searchsorted``'s result
    (as int32) through the search kernel."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    lo, hi = _search(queries, keys, side == "left", side == "right")
    return lo if side == "left" else hi


def prefix_range_bounds(prefix_cols: torch.Tensor, keys: torch.Tensor):
    """Half-open ``[start, end)`` (int32) of the sorted packed keys whose
    leading k 21-bit fields equal each row of the (n, k) int32 prefix."""
    _check(prefix_cols, "prefix_cols", torch.int32, 2)
    _check(keys, "keys", torch.int64, 1)
    k = prefix_cols.shape[1]
    if not 1 <= k <= 3:
        raise ValueError(f"prefix length must be 1..3, got {k}")
    if not _on_card(prefix_cols, keys):
        return ref.prefix_range_bounds(prefix_cols, keys)
    n = prefix_cols.shape[0]
    start = torch.empty(n, dtype=torch.int32, device=keys.device)
    end = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        _launch("prefix_range_bounds", keys.device, prefix_cols.data_ptr(), n, k,
                keys.data_ptr(), keys.shape[0], start.data_ptr(), end.data_ptr())
    return start, end


def rewrite_triples(spo: torch.Tensor, rho: torch.Tensor, *,
                    valid: torch.Tensor | None = None,
                    epoch: torch.Tensor | None = None,
                    marked: torch.Tensor | None = None):
    """``(rho[spo], changed)`` for (n, 3) int32 triples.

    ``valid`` (n,) bool zeroes excluded rows (candidate normalisation);
    ``epoch`` (n,) int32 with ``marked`` (n,) bool limits ``changed`` to
    live rows (the store sweep).
    """
    _check(spo, "spo", torch.int32, 2, width=3)
    _check(rho, "rho", torch.int32, 1)
    if rho.shape[0] == 0:
        raise ValueError("rho is empty")
    n = spo.shape[0]
    masks = [("valid", valid, torch.bool), ("epoch", epoch, torch.int32),
             ("marked", marked, torch.bool)]
    for name, t, dtype in masks:
        if t is not None:
            _check(t, name, dtype, 1)
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, spo {n}")
    if (epoch is None) != (marked is None):
        raise ValueError("epoch and marked go together")
    present = [t for _, t, _ in masks if t is not None]
    if not _on_card(spo, rho, *present):
        return ref.rewrite_triples(spo, rho, valid, epoch, marked)
    out = torch.empty_like(spo)
    changed = torch.empty(n, dtype=torch.bool, device=spo.device)
    _launch("rewrite_triples", spo.device, spo.data_ptr(), n, rho.data_ptr(),
            rho.shape[0], _ptr(valid), _ptr(epoch), _ptr(marked),
            out.data_ptr(), changed.data_ptr())
    return out, changed


def rewrite_owner(spo: torch.Tensor, rho: torch.Tensor, n_shards: int):
    """``(rho[spo], owner)`` for (n, 3) int32 triples, ``owner`` the
    subject's representative mod ``n_shards`` (int32): the routing key of
    the delete path's tombstone seed queries.  The rewrite is
    :func:`rewrite_triples` (the kernel on the card); the modulus is taken
    outside it, as the reference's wrapper takes it."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    out, _changed = rewrite_triples(spo, rho)
    return out, torch.remainder(out[:, 0], n_shards).to(torch.int32)


def uf_compress_(rep: torch.Tensor) -> None:
    """Compress the union-find forest ``rep`` (int32) in place: every entry
    ends on its root, the fixpoint of ``rep = rep[rep]``."""
    _check(rep, "rep", torch.int32, 1)
    if not _on_card(rep):
        ref.uf_compress_(rep)
        return
    _launch("uf_compress", rep.device, rep.data_ptr(), rep.shape[0])


def uf_union_(rep: torch.Tensor, pairs: torch.Tensor, valid: torch.Tensor) -> None:
    """Join the trees of every valid (a, b) row of the (m, 2) int32
    ``pairs`` in the forest ``rep`` (int32, ``rep[x] <= x``), in place: each
    joined component's least root becomes its root.  ``rep`` is left a
    forest, not compressed (:func:`uf_compress_` finishes it); ids are
    clamped into ``rep``.  No host read."""
    _check(rep, "rep", torch.int32, 1)
    _check(pairs, "pairs", torch.int32, 2, width=2)
    _check(valid, "valid", torch.bool, 1)
    if valid.shape[0] != pairs.shape[0]:
        raise ValueError(f"valid has {valid.shape[0]} rows, pairs {pairs.shape[0]}")
    if rep.shape[0] == 0 and pairs.shape[0]:
        raise ValueError("pairs into an empty rep")
    if not _on_card(rep, pairs, valid):
        ref.uf_union_(rep, pairs, valid)
        return
    _launch("uf_union", rep.device, rep.data_ptr(), rep.shape[0],
            pairs.data_ptr(), valid.data_ptr(), pairs.shape[0])


FLASH_HEAD_DIMS = (64, 128)
_FLOATS = (torch.float32, torch.bfloat16)


def _check_float(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dim() != ndim or t.dtype not in _FLOATS:
        raise TypeError(f"{name}: want a {ndim}-d float32 or bfloat16 tensor, "
                        f"got {t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """GQA attention forward: q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D) in
    q's dtype (f32 or bf16), f32 math; query head h reads KV head
    h // (H/KV); causal masks key j for query i where q_offset + i < j.

    The kernel reads the tensors in place through their strides (a layer
    of the KV arena needs no copy); it wants the last dimension contiguous,
    16-byte aligned rows and D in ``FLASH_HEAD_DIMS``.
    """
    # every tensor attribute is read once: at the server's prefill shapes
    # the host work of this call costs more than the kernel
    shapes = (q.shape, k.shape, v.shape)
    dtype = q.dtype
    for name, x, shape in zip("qkv", (q, k, v), shapes):
        if len(shape) != 4 or x.dtype not in _FLOATS:
            raise TypeError(f"{name}: want a 4-d float32 or bfloat16 tensor, "
                            f"got {len(shape)}-d {x.dtype}")
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = shapes[0]
    _, t, kv, _ = shapes[1]
    if shapes[1] != shapes[2] or shapes[1][0] != b or shapes[1][3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not divide into {kv} KV heads")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if not _on_card(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not in {FLASH_HEAD_DIMS}")
    vec = 16 // q.element_size()
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    for name, st, ptr in zip("qkv", (qst, kst, vst), ptrs):
        if st[3] != 1 or st[0] % vec or st[1] % vec or st[2] % vec or ptr % 16:
            raise ValueError(f"flash kernel: {name} needs a contiguous last "
                             "dimension and 16-byte aligned rows")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    args = array.array("q", (*ptrs, out.data_ptr(), b, s, t, h, kv, qst[0], qst[1],
                             qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
                             int(causal), q_offset, d, dtype == torch.bfloat16))
    _launch("flash_attention", q.device, args.buffer_info()[0], 1.0 / d**0.5)
    return out


def fm_interact(x: torch.Tensor) -> torch.Tensor:
    """FM second-order term: (B, F, K) field embeddings -> (B,) as
    ``0.5 * sum_k((sum_f x)^2 - sum_f x^2)``, f32 math, x's dtype."""
    _check_float(x, "x", 3)
    if not _on_card(x):
        return ref.fm_interact(x)
    b, f, k = x.shape
    out = torch.empty(b, dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    _launch("fm_interact", x.device, x.data_ptr(), out.data_ptr(), b, f, k,
            int(x.dtype == torch.bfloat16))
    return out



@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The order in which :func:`segment_sum` visits the rows of one
    segment-id array, built once per graph by :func:`segment_plan`."""

    perm: torch.Tensor     # (E,) int32: a stable ascending sort of seg
    seg: torch.Tensor      # (E,) int32: seg[perm]
    offsets: torch.Tensor  # (n_segments + 1,) int32: #{seg < s}
    n_segments: int


def segment_plan(seg: torch.Tensor, n_segments: int) -> SegmentPlan:
    """The plan of (E,) int32 segment ids: their stable sort (the
    ``dedup_order`` kernel) and each segment's first sorted position (the
    ``search_bounds`` kernel).  Rows outside [0, n_segments) sort before
    ``offsets[0]`` or from ``offsets[n_segments]`` on."""
    _check(seg, "seg", torch.int32, 1)
    if n_segments < 0:
        raise ValueError(f"n_segments must be >= 0, got {n_segments}")
    keys = seg.to(torch.int64)
    perm = dedup_order(keys)
    sorted_keys = keys[perm.to(torch.int64)]
    bounds = torch.arange(n_segments + 1, dtype=torch.int64, device=seg.device)
    offsets = searchsorted(sorted_keys, bounds, side="left")
    return SegmentPlan(perm, sorted_keys.to(torch.int32), offsets, n_segments)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n_segments: int,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """(E, K) rows summed by (E,) int32 segment id into (n_segments, K):
    rows whose id lies outside [0, n_segments) are dropped, empty segments
    are zero; f32 sums, x's dtype (f32 or bf16).

    On the card the kernel visits the rows in ``plan``'s order
    (:func:`segment_plan` of ``seg``; built here when it is not given), and
    two calls on the same inputs give the same bits."""
    _check_float(x, "x", 2)
    _check(seg, "seg", torch.int32, 1)
    e, k = x.shape
    if seg.shape[0] != e:
        raise ValueError(f"seg has {seg.shape[0]} rows, x {e}")
    if n_segments < 0:
        raise ValueError(f"n_segments must be >= 0, got {n_segments}")
    if plan is not None and (plan.n_segments != n_segments
                             or plan.perm.shape[0] != e):
        raise ValueError(f"plan of {plan.perm.shape[0]} rows and "
                         f"{plan.n_segments} segments for {e} rows and "
                         f"{n_segments} segments")
    if not _on_card(x, seg):
        return ref.segment_sum(x, seg, n_segments)
    if e >= 1 << 31:
        raise ValueError(f"segment_sum kernel: {e} rows, want < 2^31")
    if plan is None:
        plan = segment_plan(seg, n_segments)
    if plan.perm.device != x.device:
        raise ValueError(f"plan on {plan.perm.device}, x on {x.device}")
    out = torch.empty((n_segments, k), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    blocks = segment_sum_max_blocks()
    carry = torch.empty(blocks * 2 * k, dtype=torch.float32, device=x.device)
    _launch("segment_sum", x.device, x.data_ptr(), plan.perm.data_ptr(),
            plan.seg.data_ptr(), plan.offsets.data_ptr(), e, n_segments, k,
            out.data_ptr(), carry.data_ptr(), blocks,
            int(x.dtype == torch.bfloat16))
    return out


@functools.cache
def segment_sum_max_blocks() -> int:
    """The most blocks the segment-sum kernel's first pass runs on this
    card (each leaves two partial rows in the f32 scratch), asked once."""
    entry = library("segment_sum").segment_sum_max_blocks
    entry.argtypes = ()
    entry.restype = _N
    return entry()


def embedding_bag(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) int32 ids into a (V, K) table -> (B, K): ``out[b] = sum_f
    table[ids[b, f]]``; an id outside [0, V) adds zero.  f32 sums, the
    table's dtype (f32 or bf16)."""
    _check(ids, "ids", torch.int32, 2)
    _check_float(table, "table", 2)
    v, k = table.shape
    if v == 0:
        raise ValueError("table is empty")
    if not _on_card(ids, table):
        return ref.embedding_bag(ids, table)
    b, f = ids.shape
    out = torch.empty((b, k), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    _launch("embedding_bag", table.device, ids.data_ptr(), table.data_ptr(),
            b, f, v, k, out.data_ptr(), int(table.dtype == torch.bfloat16))
    return out
