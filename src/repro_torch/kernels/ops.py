"""Dispatchers for the hand-written kernels.

Every function checks its tensors (device, dtype, shape, contiguity) and
then runs the CUDA kernel for tensors on the card or the plain version
(:mod:`repro_torch.kernels.ref`) for tensors on the CPU.  There is no other
route: a CUDA tensor gets the kernel or an exception, never the plain
version.  ``LAUNCHES`` counts, per kernel, the calls that launched it on the
card — the proof that a run went through the kernels.

Kernel launches use PyTorch's current stream, allocate nothing inside the
kernel (outputs and scratch come from ``torch.empty`` here) and never
synchronise; a non-zero ``cudaGetLastError`` after a launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import library

KERNELS = ("dedup_order", "search_bounds", "rewrite_triples",
           "uf_compress", "uf_hook")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_N = ctypes.c_longlong
# C entry point -> (source in csrc/, launch counter, argument types without
# the trailing stream)
_ENTRIES = {
    "dedup_order": ("dedup_order", "dedup_order", (_P, _N, _P, _P, _P, _P)),
    "search_bounds": ("search_bounds", "search_bounds", (_P, _N, _P, _N, _P, _P)),
    "prefix_range_bounds": ("search_bounds", "search_bounds",
                            (_P, _N, ctypes.c_int, _P, _N, _P, _P)),
    "rewrite_triples": ("rewrite_triples", "rewrite_triples",
                        (_P, _N, _P, _N, _P, _P, _P, _P, _P)),
    "uf_compress": ("union_find", "uf_compress", (_P, _N)),
    "uf_hook": ("union_find", "uf_hook", (_P, _N, _P, _P, _P, _N, _P)),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream, raise on a
    non-zero ``cudaGetLastError``, and count the launch."""
    source, counter, argtypes = _ENTRIES[fn]
    entry = getattr(library(source), fn)
    if entry.argtypes is None:
        entry.argtypes = (*argtypes, _P)
        entry.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err}")
    LAUNCHES[counter] += 1


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


def dedup_order(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation (int32) of int64 ``keys``."""
    _check(keys, "keys", torch.int64, 1)
    if not _on_card(keys):
        return ref.dedup_order(keys)
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    kbuf = torch.empty((2, n), dtype=torch.int64, device=keys.device)
    ibuf = torch.empty(n, dtype=torch.int32, device=keys.device)
    _launch("dedup_order", keys.device, keys.data_ptr(), n, kbuf[0].data_ptr(),
            kbuf[1].data_ptr(), ibuf.data_ptr(), out.data_ptr())
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


def uf_compress_(rep: torch.Tensor) -> None:
    """Compress the union-find forest ``rep`` (int32) in place: every entry
    ends on its root, the fixpoint of ``rep = rep[rep]``."""
    _check(rep, "rep", torch.int32, 1)
    if not _on_card(rep):
        ref.uf_compress_(rep)
        return
    _launch("uf_compress", rep.device, rep.data_ptr(), rep.shape[0])


def uf_hook_(rep: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """One merge step on a compressed ``rep``: replace the pair endpoints
    ``a``/``b`` by their roots, then hook every valid pair still apart with
    ``rep[max] = min(rep[max], min)``.  Returns a (1,) int32 flag, 1 iff a
    pair was hooked."""
    _check(rep, "rep", torch.int32, 1)
    for name, t, dtype in (("a", a, torch.int32), ("b", b, torch.int32),
                           ("valid", valid, torch.bool)):
        _check(t, name, dtype, 1)
        if t.shape[0] != a.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} rows, a {a.shape[0]}")
    if not _on_card(rep, a, b, valid):
        return ref.uf_hook_(rep, a, b, valid)
    flag = torch.empty(1, dtype=torch.int32, device=rep.device)
    _launch("uf_hook", rep.device, rep.data_ptr(), rep.shape[0], a.data_ptr(),
            b.data_ptr(), valid.data_ptr(), a.shape[0], flag.data_ptr())
    return flag
