"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel computes, on the same
arguments, with the same in-place contract.  :mod:`repro_torch.kernels.ops`
runs these for tensors on the CPU; ``chip_smoke.py`` holds every kernel
against them on the card.
"""

from __future__ import annotations

import torch

MAX_ID = (1 << 21) - 1
NEG_INF = -1e30


def dedup_order(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation of int64 ``keys`` as int32."""
    return torch.argsort(keys, stable=True).to(torch.int32)


def search_bounds(queries: torch.Tensor, keys: torch.Tensor):
    """``(#{keys < q}, #{keys <= q})`` per int64 query, as int32."""
    lo = torch.searchsorted(keys, queries, side="left")
    hi = torch.searchsorted(keys, queries, side="right")
    return lo.to(torch.int32), hi.to(torch.int32)


def prefix_range_bounds(prefix_cols: torch.Tensor, keys: torch.Tensor):
    """Half-open ``[start, end)`` of the keys carrying each (n, k) prefix:
    the lower bound of the prefix packed with zeros and the upper bound of
    the prefix packed with the maximal 21-bit ID."""
    pc = prefix_cols.to(torch.int64)
    k = pc.shape[1]
    lo = torch.zeros(pc.shape[0], dtype=torch.int64, device=pc.device)
    hi = torch.zeros_like(lo)
    for j in range(3):
        lo = (lo << 21) | (pc[:, j] if j < k else 0)
        hi = (hi << 21) | (pc[:, j] if j < k else MAX_ID)
    start = torch.searchsorted(keys, lo, side="left")
    end = torch.searchsorted(keys, hi, side="right")
    return start.to(torch.int32), end.to(torch.int32)


def rewrite_triples(spo, rho, valid=None, epoch=None, marked=None):
    """``(rho[spo], changed)`` with the kernel's clamping and optional masks.

    ``valid`` zeroes the rows it excludes and clears their flag; ``epoch``
    and ``marked`` restrict the flag to live rows (the store sweep).
    """
    idx = spo.to(torch.int64).clamp_(0, rho.shape[0] - 1)
    out = rho[idx]
    if valid is not None:
        out = torch.where(valid[:, None], out, 0)
    changed = (out != spo).any(dim=1)
    if valid is not None:
        changed &= valid
    if epoch is not None:
        changed &= (epoch >= 0) & ~marked
    return out.to(torch.int32), changed


def rewrite_owner(spo, rho, n_shards: int):
    """``(rho[spo], rho[s] mod n_shards)``: :func:`rewrite_triples` and the
    owner shard of each row."""
    out, _changed = rewrite_triples(spo, rho)
    return out, torch.remainder(out[:, 0], n_shards).to(torch.int32)


def uf_compress_(rep: torch.Tensor) -> None:
    """Compress ``rep`` in place to the fixpoint of ``rep = rep[rep]``."""
    while True:
        nxt = rep[rep.to(torch.int64)]
        if torch.equal(nxt, rep):
            return
        rep.copy_(nxt)


def uf_union_(rep, pairs, valid) -> None:
    """Join the trees of the valid pairs in place: compress, then hook each
    pair still apart with ``rep[max] = min(rep[max], min)`` of its roots,
    and compress again, to the fixpoint.  Leaves ``rep`` compressed."""
    idx = pairs.to(torch.int64).clamp_(0, rep.shape[0] - 1)
    uf_compress_(rep)
    while True:
        a = rep[idx[:, 0]]
        b = rep[idx[:, 1]]
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        active = valid & (lo != hi)
        if not bool(active.any()):
            return
        # inactive rows scatter rep[0] into slot 0: a no-op under amin
        tgt = torch.where(active, hi, 0).to(torch.int64)
        val = torch.where(active, lo, rep[0])
        rep.scatter_reduce_(0, tgt, val, "amin", include_self=True)
        uf_compress_(rep)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """GQA attention forward, q (B,S,H,D) and k/v (B,T,KV,D) -> (B,S,H,D).

    Query head h reads KV head h // (H/KV).  Scores in f32 from the inputs
    cast to f32, scaled by 1/sqrt(D), masked with -1e30 where causal and
    q_offset + i < j; the softmax in f32, ``acc / max(l, 1e-30)``, cast to
    q's dtype.  Query rows go in blocks of about 2^26 scores, so a 32k
    prefill never holds its whole (S, T) score matrix.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / d**0.5
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(t, device=q.device)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    step = max(1, (1 << 26) // (b * h * t))
    for s0 in range(0, s, step):
        qf = q[:, s0:s0 + step].float()
        n = qf.shape[1]
        scores = torch.einsum("bskgd,btkd->bkgst", qf.reshape(b, n, kv, g, d), kf)
        scores = scores * scale
        if causal:
            q_pos = q_offset + s0 + torch.arange(n, device=q.device)
            scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, NEG_INF)
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # (b, kv, g, n, 1)
        o = torch.einsum("bkgst,btkd->bskgd", p, vf) / l.permute(0, 3, 1, 2, 4)
        out[:, s0:s0 + n] = o.reshape(b, n, h, d).to(q.dtype)
    return out


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(E, K) rows summed by segment id into (n_segments, K): ``out[s]`` is
    the sum of the rows whose ``seg`` is s.  Rows whose id lies outside
    [0, n_segments) are dropped; empty segments are zero.  f32 sums, cast
    to x's dtype.  Every shape is static (the dry run's fake tensors allow
    no mask by value): a dropped row adds into a spare last row, which is
    cut off, so each kept segment takes the same sums in the same order."""
    keep = (seg >= 0) & (seg < n_segments)
    out = torch.zeros((n_segments + 1, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, torch.where(keep, seg, n_segments).to(torch.int64), x.float())
    return out[:n_segments].to(x.dtype)


def embedding_bag(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) ids into a (V, K) table -> (B, K): ``out[b] = sum_f
    table[ids[b, f]]``, where an id outside [0, V) adds zero (it is neither
    clamped nor wrapped).  f32 sums, cast to the table's dtype."""
    v = table.shape[0]
    on_table = (ids >= 0) & (ids < v)
    rows = table[ids.to(torch.int64).clamp(0, v - 1)].float()
    rows = torch.where(on_table[..., None], rows, 0.0)
    return rows.sum(dim=1).to(table.dtype)


def fm_interact(x: torch.Tensor) -> torch.Tensor:
    """(B, F, K) -> (B,): ``0.5 * sum_k((sum_f x)^2 - sum_f x^2)`` in f32,
    cast to x's dtype."""
    xf = x.float()
    s = xf.sum(dim=1)
    sq = (xf * xf).sum(dim=1)
    return (0.5 * (s * s - sq).sum(dim=1)).to(x.dtype)
