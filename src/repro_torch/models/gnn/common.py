"""Shared GNN machinery: segment-op message passing over an edge index.

The port of ``repro.models.gnn.common``.  The sum reductions (``seg_sum``
and everything built on it: ``seg_mean``, ``seg_std``, ``degrees``, the
empty-segment count) go through the ``segment_sum`` kernel on the card;
``seg_max``/``seg_min`` are PyTorch's ``scatter_reduce`` (the reference's
``jax.ops.segment_max``/``segment_min`` are no Pallas kernels).

Each reduction takes an optional :class:`repro_torch.kernels.ops.SegmentPlan`
of its segment ids, which a forward builds once per graph (from ``dst``)
and passes to every layer; without one the kernel builds its own.
Segment ids of ``seg_max``/``seg_min`` must lie in [0, n).

Training differentiates through the same kernel: the gradient of a sum is
a row gather, and every row gather of a node or edge table by an index
array (``gather``, :func:`repro_torch.kernels.ops.gather_rows`) has as its
gradient the segment sum by that array, through that array's plan.  So the
backward of the sums and gathers is deterministic on the card; that of
``seg_max``/``seg_min`` is PyTorch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def seg_sum(x, seg, n, plan=None):
    return ops.segment_sum(x, seg, n, plan=plan)


def gather(x, idx, plan=None):
    """``x[idx]`` for int32 ``idx``; ``plan`` (of ``idx`` and ``len(x)``)
    serves its backward."""
    return ops.gather_rows(x, idx, plan)


def _counts(seg, n, dtype, plan=None):
    ones = torch.ones((seg.shape[0], 1), dtype=dtype, device=seg.device)
    return seg_sum(ones, seg, n, plan)


def seg_mean(x, seg, n, eps=1e-6, plan=None):
    return seg_sum(x, seg, n, plan) / (_counts(seg, n, x.dtype, plan) + eps)


def _mask_empty(agg, seg, n, plan=None):
    """Zero out segments with no contributing edges."""
    return torch.where(_counts(seg, n, agg.dtype, plan) > 0, agg, 0.0)


def _scatter(x, seg, n, reduce):
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    index = seg.to(torch.int64).reshape(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce_(0, index, x, reduce, include_self=False)


def seg_max(x, seg, n, plan=None):
    return _mask_empty(_scatter(x, seg, n, "amax"), seg, n, plan)


def seg_min(x, seg, n, plan=None):
    return _mask_empty(_scatter(x, seg, n, "amin"), seg, n, plan)


def seg_std(x, seg, n, eps=1e-6, plan=None):
    m = seg_mean(x, seg, n, plan=plan)
    m2 = seg_mean(x * x, seg, n, plan=plan)
    return torch.sqrt(torch.clamp(m2 - m * m, min=0.0) + eps)


def seg_softmax(logits, seg, n, plan=None):
    """Edge softmax grouped by destination node."""
    mx = seg_max(logits, seg, n, plan)
    ex = torch.exp(logits - gather(mx, seg, plan))
    den = seg_sum(ex, seg, n, plan)
    return ex / (gather(den, seg, plan) + 1e-9)


def degrees(dst, n, plan=None):
    return _counts(dst, n, torch.float32, plan)[:, 0]


def masked_nll(logits, batch: dict):
    """Node classification loss: the mean negative log-likelihood of
    ``batch["labels"]`` over the nodes of ``batch["train_mask"]`` (all
    nodes without one), in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, batch["labels"].to(torch.int64)[:, None])[:, 0]
    mask = batch.get("train_mask")
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def mlp(params: list, x, act=F.silu):
    for i, (w, b) in enumerate(params):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < len(params) - 1:
            x = act(x)
    return x


def init_mlp(gen: torch.Generator, dims, *, device: str | torch.device,
             dtype=torch.float32) -> list:
    """``[(w, b), ...]``: w normal * fan_in^-0.5 drawn from ``gen`` (on its
    own device), b zero."""
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=gen.device) * a**-0.5
        out.append((w.to(device=device, dtype=dtype),
                    torch.zeros((b,), dtype=dtype, device=device)))
    return out


def layer_norm(x, eps=1e-5):
    """Normalise the last axis with its biased variance (as ``jnp.var``)."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - m) * torch.rsqrt(v + eps)).to(x.dtype)
