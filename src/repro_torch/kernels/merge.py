"""Rank-merge of two sorted key/value columns — the index-maintenance op.

The port of ``repro.kernels.merge``: each element's position in the merge
is its own index plus its rank in the other column,

    pos_a[i] = i + #{j : b[j] <  a[i]}      (ties: a-side first)
    pos_b[j] = j + #{i : a[i] <= b[j]}

so merging is binary searches plus gathers, no sort.  Every rank goes
through the search kernel (:func:`repro_torch.kernels.ops.searchsorted`).
KEY_MAX padding sorts above every real key, so truncating the merge to the
index capacity only ever drops padding.
"""

from __future__ import annotations

import torch

from . import ops


def merge_ranks(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Positions (int64) of each element of two sorted columns in their
    merge; ties place ``a`` elements before equal ``b`` elements."""
    pos_a = torch.arange(a_keys.shape[0], device=a_keys.device) + ops.searchsorted(
        b_keys, a_keys, side="left"
    )
    pos_b = torch.arange(b_keys.shape[0], device=b_keys.device) + ops.searchsorted(
        a_keys, b_keys, side="right"
    )
    return pos_a, pos_b


def merge_sorted(a_keys, a_vals, b_keys, b_vals, out_len: int | None = None):
    """Merge sorted ``(keys, vals)`` columns, truncated to ``out_len`` rows.

    Output position ``p`` holds the ``b`` element whose merge position
    equals ``p``, else the ``a`` element at index ``p - #{b placed before
    p}`` — both found by binary search over the monotone ``pos_b``.
    """
    A, B = a_keys.shape[0], b_keys.shape[0]
    out_len = A if out_len is None else out_len
    if B == 0:
        return a_keys[:out_len], a_vals[:out_len]
    dev = a_keys.device
    pos_b = torch.arange(B, device=dev) + ops.searchsorted(
        a_keys, b_keys, side="right"
    )
    p = torch.arange(out_len, device=dev)
    ib = ops.searchsorted(pos_b, p, side="left").to(torch.int64)
    jb = ib.clamp(0, B - 1)
    from_b = pos_b[jb] == p
    ja = (p - ib).clamp(0, A - 1)
    keys = torch.where(from_b, b_keys[jb], a_keys[ja])
    vals = torch.where(from_b, b_vals[jb], a_vals[ja])
    return keys, vals
