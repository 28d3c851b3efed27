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
never carries on on the CPU.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_to_all", "axis_index", "pany", "psum"]

I32 = torch.int32


def axis_index(mesh) -> int:
    """This rank's shard number (``jax.lax.axis_index``)."""
    return mesh.rank


def _check(op: str, x: torch.Tensor, mesh) -> None:
    """Raise where the mesh's backend cannot carry ``x``'s device."""
    dev = x.device.type
    if (mesh.backend, dev) not in (("nccl", "cuda"), ("gloo", "cpu"),
                                   ("gloo", "cuda")):
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
