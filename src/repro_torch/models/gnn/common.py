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

Edge parallelism (the reference's GNN cells, ``workloads.py:188-199``):
with an :class:`EdgeShard` (``ax``), this rank holds its block of the
edges along the data axes and the nodes and parameters whole.  A segment
reduction of edge rows into nodes runs the kernel on the rank's edges and
then reduces the node rows over the data axes (sum, max or min); its
backward passes the (whole) node gradient through.  A gather of node
rows onto the rank's edges (``gather``) has as its backward the kernel's
segment sum of the rank's edges followed by a sum over the data axes, so
node gradients stay whole.  Parameters that act on edge rows
(:func:`edge_side`) get the same sum in their backward; those that act on
node rows are whole already.  Without ``ax`` nothing changes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.compat import pytree
from repro_torch.core import collectives as coll
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_axes


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """This rank's block of the edges along the data ``axes`` of ``mesh``."""

    mesh: object
    axes: tuple

    @property
    def size(self) -> int:
        return self.mesh.axis(self.axes).size


def edge_shard(mesh) -> EdgeShard | None:
    """The edge split of ``mesh`` over its data axes; None without a mesh
    or with one data rank (nothing is split)."""
    if mesh is None:
        return None
    axes = data_axes(mesh)
    return None if coll.is_trivial(mesh, axes) else EdgeShard(mesh, axes)


def edge_side(tree, ax: EdgeShard | None):
    """Parameters that act on this rank's edge rows: unchanged, their
    gradient summed over the data axes in the backward."""
    if ax is None:
        return tree
    return pytree.tree_map(lambda p: coll.grad_all_reduce(p, ax.mesh, ax.axes), tree)


def seg_sum(x, seg, n, plan=None, ax=None):
    out = ops.segment_sum(x, seg, n, plan=plan)
    return out if ax is None else coll.all_reduce(out, ax.mesh, ax.axes)


def gather(x, idx, plan=None, ax=None):
    """``x[idx]`` for int32 ``idx``; ``plan`` (of ``idx`` and ``len(x)``)
    serves its backward (with ``ax``, then summed over the data axes)."""
    if ax is not None:
        x = coll.grad_all_reduce(x, ax.mesh, ax.axes)
    return ops.gather_rows(x, idx, plan)


def _counts(seg, n, dtype, plan=None, ax=None):
    ones = torch.ones((seg.shape[0], 1), dtype=dtype, device=seg.device)
    return seg_sum(ones, seg, n, plan, ax)


def seg_mean(x, seg, n, eps=1e-6, plan=None, ax=None):
    return seg_sum(x, seg, n, plan, ax) / (_counts(seg, n, x.dtype, plan, ax) + eps)


def _mask_empty(agg, seg, n, plan=None, ax=None):
    """Zero out segments with no contributing edges."""
    return torch.where(_counts(seg, n, agg.dtype, plan, ax) > 0, agg, 0.0)


def _index(seg, x):
    return seg.to(torch.int64).reshape(-1, *([1] * (x.dim() - 1))).expand_as(x)


def _scatter(x, seg, n, reduce):
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, _index(seg, x), x, reduce, include_self=False)


class _SegExtreme(torch.autograd.Function):
    """The max (or min) of each segment over every rank's edges: the
    rank's own (an empty segment at -inf, or +inf), reduced over the data
    axes.  The backward splits a segment's gradient evenly among the rows
    of every rank that reach its extreme, as PyTorch's ``scatter_reduce``
    does among its ties."""

    @staticmethod
    def forward(ctx, x, seg, n, reduce, ax):
        fill = -torch.inf if reduce == "amax" else torch.inf
        out = torch.full((n, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out.scatter_reduce_(0, _index(seg, x), x, reduce, include_self=False)
        out = coll.all_reduce_raw(out, ax.mesh, ax.axes, reduce[1:])
        ctx.save_for_backward(x, seg, out)
        ctx.ax = ax
        return out

    @staticmethod
    def backward(ctx, grad):
        x, seg, out = ctx.saved_tensors
        idx = _index(seg, x)
        hit = (x == out.gather(0, idx)).to(grad.dtype)
        ties = torch.zeros_like(out, dtype=grad.dtype).scatter_add_(0, idx, hit)
        ties = coll.all_reduce_raw(ties, ctx.ax.mesh, ctx.ax.axes)
        return hit * (grad / ties).gather(0, idx), None, None, None, None


def seg_max(x, seg, n, plan=None, ax=None):
    agg = _scatter(x, seg, n, "amax") if ax is None else _SegExtreme.apply(
        x, seg, n, "amax", ax)
    return _mask_empty(agg, seg, n, plan, ax)


def seg_min(x, seg, n, plan=None, ax=None):
    agg = _scatter(x, seg, n, "amin") if ax is None else _SegExtreme.apply(
        x, seg, n, "amin", ax)
    return _mask_empty(agg, seg, n, plan, ax)


def seg_std(x, seg, n, eps=1e-6, plan=None, ax=None):
    m = seg_mean(x, seg, n, plan=plan, ax=ax)
    m2 = seg_mean(x * x, seg, n, plan=plan, ax=ax)
    return torch.sqrt(torch.clamp(m2 - m * m, min=0.0) + eps)


def seg_softmax(logits, seg, n, plan=None, ax=None):
    """Edge softmax grouped by destination node."""
    mx = seg_max(logits, seg, n, plan, ax)
    ex = torch.exp(logits - gather(mx, seg, plan, ax))
    den = seg_sum(ex, seg, n, plan, ax)
    return ex / (gather(den, seg, plan, ax) + 1e-9)


def degrees(dst, n, plan=None, ax=None):
    return _counts(dst, n, torch.float32, plan, ax)[:, 0]


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
