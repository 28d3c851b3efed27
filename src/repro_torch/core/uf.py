"""Representative map rho as a union-find.

The port of ``repro.core.uf``'s merge machinery.  All sameAs pairs of a
round are applied at once: min-hooking (``rep[hi] = min(rep[hi], lo)`` for
pairs whose roots differ) alternates with compression until no pair
straddles two roots.  The representative of a clique is its minimum ID, so
the result is unique whatever the order of hooks.

* ``compress_np`` / ``merge_pairs_np`` — numpy copies of the reference's
  host versions,
* ``compress`` / ``merge_pairs`` — the torch counterparts of
  ``_compress_jax`` / ``merge_pairs_jax``; on the card, compression and
  hooking run as the union-find kernels (:func:`repro_torch.kernels.ops.uf_compress_`,
  :func:`repro_torch.kernels.ops.uf_hook_`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def compress_np(rep: np.ndarray) -> np.ndarray:
    """Full path compression by pointer doubling (O(log depth) sweeps)."""
    rep = rep.copy()
    while True:
        nxt = rep[rep]
        if np.array_equal(nxt, rep):
            return rep
        rep = nxt


def merge_pairs_np(rep: np.ndarray, pairs: np.ndarray) -> tuple[np.ndarray, int]:
    """Merge (a, b) rows of ``pairs`` into ``rep``; returns (rep', n_merged)."""
    if pairs.size == 0:
        return rep, 0
    rep = compress_np(rep)
    before_roots = int((rep == np.arange(rep.shape[0])).sum())
    a = rep[pairs[:, 0]]
    b = rep[pairs[:, 1]]
    while True:
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        active = lo != hi
        if not active.any():
            break
        np.minimum.at(rep, hi[active], lo[active])
        rep = compress_np(rep)
        a = rep[a]
        b = rep[b]
    after_roots = int((rep == np.arange(rep.shape[0])).sum())
    return rep, before_roots - after_roots


def compress(rep: torch.Tensor) -> torch.Tensor:
    """Fully compressed copy of the int32 forest ``rep``."""
    out = rep.clone()
    ops.uf_compress_(out)
    return out


def merge_pairs(rep: torch.Tensor, pairs: torch.Tensor,
                pair_valid: torch.Tensor) -> torch.Tensor:
    """Merge the valid (a, b) rows of the (m, 2) int32 ``pairs`` into a copy
    of ``rep``; returns the compressed result.

    Each pass of the loop refreshes every pair to its roots and hooks the
    ones still apart (one kernel call), then compresses; the host reads one
    flag per pass to stop.
    """
    rep = compress(rep)
    a = torch.where(pair_valid, pairs[:, 0], 0).contiguous()
    b = torch.where(pair_valid, pairs[:, 1], 0).contiguous()
    valid = pair_valid.contiguous()
    while bool(ops.uf_hook_(rep, a, b, valid).item()):
        ops.uf_compress_(rep)
    return rep
