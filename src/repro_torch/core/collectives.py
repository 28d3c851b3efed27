"""The sharded engine's collectives: the port's counterparts of the JAX ones.

Under ``shard_map`` the reference moves rows between shards with
``jax.lax.all_gather(tiled=True)``, ``jax.lax.all_to_all(split_axis=0,
concat_axis=0, tiled=True)`` and ``jax.lax.psum``, and reads its shard
number with ``jax.lax.axis_index``.  Here each is one ``torch.distributed``
call over the :class:`~repro_torch.launch.mesh.EngineMesh`'s group:

=====================  ==========================================
reference               port
=====================  ==========================================
``all_gather(tiled)``   :func:`all_gather` (``all_gather_into_tensor``)
``all_to_all(tiled)``   :func:`all_to_all` (``all_to_all_single``)
``psum``                :func:`psum` (``all_reduce``, SUM)
``psum(x) > 0``         :func:`pany`
``axis_index``          :func:`axis_index`
=====================  ==========================================

Both keep rank order, which is JAX's tiled order: a gather concatenates
the ranks' blocks in rank order, and an all-to-all sends block ``j`` of
every rank to rank ``j``, which concatenates what it gets by source rank.
Bools travel as uint8 in gathers and exchanges and as int32 in sums (gloo
has no bool reduction), and come back as bools.

Which device a backend carries: NCCL carries CUDA tensors only; gloo
carries CPU tensors and CUDA tensors (all three collectives, on int32,
int64 and uint8 CUDA tensors; two ranks on one card cannot share NCCL, so
they run on gloo).  Any other pairing raises: a mesh over CUDA tensors
never carries on on the CPU.  The ``fake`` backend
(:mod:`repro_torch.launch.dryrun`'s world of 256 or 512 ranks in one
process) takes any tensor, fake ones included, and moves nothing; the
counters count what a real group would carry.

Sharded training runs over a named :class:`~repro_torch.launch.mesh.Mesh`,
each collective over the ranks that differ along some of its axes (a name
or a tuple of names in mesh order, such as ``"model"`` or ``("pod",
"data")``); a group of one rank moves nothing and counts nothing.  The
raw forms (:func:`all_reduce_raw` with sum, max or min,
:func:`all_gather_raw` and :func:`reduce_scatter_raw` along any dimension,
:func:`all_to_all_raw` from one dimension into another) are not
differentiable; the autograd pairs are the conjugates that keep a
gradient whole:

=========================  ==============  =============================
function                    forward         backward
=========================  ==============  =============================
:func:`all_reduce`          all-reduce      identity
:func:`grad_all_reduce`     identity        all-reduce
:func:`all_gather_dim`      all-gather      reduce-scatter
:func:`reduce_scatter_dim`  reduce-scatter  all-gather
=========================  ==============  =============================

A mesh counts them by ``"<axes>:<op>"`` (``calls``, ``bytes`` each rank
sends), backward calls included.  A gloo group carries CUDA tensors
itself for all four (sum and max all-reduce, reduce-scatter, all-gather;
f32, bf16 and int32 checked on an H100 with torch 2.11): nothing is
staged through host memory by this module.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_gather_dim", "all_gather_raw", "all_reduce",
           "all_reduce_raw", "all_to_all", "all_to_all_raw", "axis_index", "grad_all_reduce", "is_trivial",
           "pany", "psum", "reduce_scatter_dim", "reduce_scatter_raw"]

I32 = torch.int32


def axis_index(mesh) -> int:
    """This rank's shard number (``jax.lax.axis_index``)."""
    return mesh.rank


def _check(op: str, x: torch.Tensor, mesh) -> None:
    """Raise where the mesh's backend cannot carry ``x``'s device (the
    ``fake`` backend of the dry run takes any: it moves nothing)."""
    dev = x.device.type
    if mesh.backend != "fake" and (mesh.backend, dev) not in (
            ("nccl", "cuda"), ("gloo", "cpu"), ("gloo", "cuda")):
        raise ValueError(f"{op}: a {mesh.backend} group does not carry {dev} tensors")


def _wire(op: str, x: torch.Tensor, dtype, mesh) -> torch.Tensor:
    """``x`` as it travels (a bool as ``dtype``), checked and counted."""
    wire = (x.to(dtype) if x.dtype == torch.bool else x).contiguous()
    _check(op, wire, mesh)
    mesh.calls[op] += 1
    mesh.bytes[op] += wire.numel() * wire.element_size()
    return wire


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order: ``jax.lax.all_gather(x, axis, tiled=True)``."""
    wire = _wire("all_gather", x, torch.uint8, mesh)
    out = torch.empty((mesh.world * wire.shape[0], *wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    with warnings.catch_warnings():  # renamed all_gather_single in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, wire, group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Block ``j`` of dim 0 (``world`` equal blocks) goes to rank ``j``;
    the result is the blocks received, in source-rank order:
    ``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``."""
    if x.shape[0] % mesh.world:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.world} ranks")
    wire = _wire("all_to_all", x, torch.uint8, mesh)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of the ranks' ``x`` (``jax.lax.psum``); a bool
    ``x`` sums as int32 and an int32 result stays int32."""
    buf = _wire("all_reduce", x, I32, mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def pany(x: torch.Tensor, mesh) -> torch.Tensor:
    """True where any rank's ``x`` is: the reference's ``psum(x) > 0``."""
    return psum(x.to(I32), mesh) > 0


# -- named-mesh collectives (sharded training) -----------------------------------

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}


def _run(op: str, x: torch.Tensor, mesh, ag, fn) -> torch.Tensor:
    """Count ``op`` over the group ``ag`` and run ``fn(wire) -> out`` on
    ``x`` (contiguous)."""
    _check(op, x, mesh)
    x = x.contiguous()
    mesh.calls[f"{ag.label}:{op}"] += 1
    mesh.bytes[f"{ag.label}:{op}"] += x.numel() * x.element_size()
    return fn(x)


def all_reduce_raw(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` (sum, max or min) of the ranks' ``x`` over
    ``axes``; a new tensor (``x`` itself over a group of one)."""
    ag = mesh.axis(axes)
    if ag.size == 1:
        return x

    def fn(wire):
        buf = wire.clone()
        dist.all_reduce(buf, op=_REDUCE[op], group=ag.group)
        return buf

    return _run(f"all_reduce_{op}" if op != "sum" else "all_reduce", x, mesh, ag, fn)


def all_gather_raw(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks ``x`` concatenated along ``dim`` in the group's
    order (row-major over ``axes``: JAX's tile order)."""
    ag = mesh.axis(axes)
    if ag.size == 1:
        return x
    front = x.movedim(dim, 0)

    def fn(wire):
        out = torch.empty((ag.size * wire.shape[0], *wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, wire, group=ag.group)
        return out

    return _run("all_gather", front, mesh, ag, fn).movedim(0, dim).contiguous()


def reduce_scatter_raw(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axes``, cut along ``dim`` into
    the group's blocks: this rank's block."""
    ag = mesh.axis(axes)
    if ag.size == 1:
        return x
    if x.shape[dim] % ag.size:
        raise ValueError(f"reduce_scatter: {x.shape[dim]} rows do not split "
                         f"over {ag.size} ranks")
    front = x.movedim(dim, 0)

    def fn(wire):
        out = torch.empty((wire.shape[0] // ag.size, *wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, wire, group=ag.group)
        return out

    return _run("reduce_scatter", front, mesh, ag, fn).movedim(0, dim).contiguous()


def all_to_all_raw(x: torch.Tensor, mesh, axes, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """``x`` cut along ``split_dim`` into the group's blocks, block ``j``
    sent to the group's rank ``j``, and the blocks received concatenated
    along ``concat_dim`` in the group's order:
    ``jax.lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)``."""
    ag = mesh.axis(axes)
    if ag.size == 1:
        return x
    if x.shape[split_dim] % ag.size:
        raise ValueError(f"all_to_all: {x.shape[split_dim]} rows do not split "
                         f"over {ag.size} ranks")
    blocks = x.unflatten(split_dim, (ag.size, -1)).movedim(split_dim, 0)

    def fn(wire):
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=ag.group)
        return out

    got = _run("all_to_all", blocks, mesh, ag, fn)  # (group, ...) by source
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_raw(grad, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_raw(grad, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_raw(grad, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def is_trivial(mesh, axes) -> bool:
    """True where ``axes`` name a group of one rank (or no axes at all)."""
    return mesh is None or not axes or mesh.axis(axes).size == 1


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes``; the backward passes the gradient through (each
    summand's gradient is the sum's): partial values made whole."""
    return x if is_trivial(mesh, axes) else _AllReduce.apply(x, mesh, axes)


def grad_all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` itself; the backward sums the gradient over ``axes``: a
    replicated value entering work that each rank does on its own part."""
    return x if is_trivial(mesh, axes) else _GradAllReduce.apply(x, mesh, axes)


def all_gather_dim(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks concatenated along ``dim``; the backward reduce-scatters
    the (partial) gradient back to this rank's block."""
    return x if is_trivial(mesh, axes) else _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum over ``axes``, this rank's block along ``dim``; the backward
    all-gathers the blocks' gradients."""
    return x if is_trivial(mesh, axes) else _ReduceScatter.apply(x, mesh, axes, dim)
