"""Shardings of tensors over a named mesh: the port's ``NamedSharding`` and
``PartitionSpec``, and the placement and gathering of blocks.

A :class:`NamedSharding` pairs a mesh (:class:`repro_torch.launch.mesh.Mesh`,
live or abstract) with a :class:`PartitionSpec`: one entry a dimension,
None (replicated along it) or a mesh axis or a tuple of mesh axes (in mesh
order) that split it.  The blocks follow JAX's tile order: a dimension
split over ``("pod", "data")`` is cut into ``pod * data`` equal blocks,
pod-major, and the rank at a coordinate holds the block its coordinates
index; it holds the whole of every dimension no axis splits, and the same
block as every rank that differs from it only along axes the spec leaves
out.  A split dimension that the axes' size does not divide raises, as
JAX's ``jit`` does.

* :func:`local_block` is the port's ``jax.device_put`` onto one rank: the
  block of a global array (numpy or torch) that a coordinate holds;
* :func:`gather` is the port's ``np.asarray`` of a sharded array: every
  rank calls it with its block and gets the global tensor (all-gathers
  over the axes of each split dimension);
* :func:`place` and :func:`gather_tree` are their forms over pytrees
  (dicts, lists, tuples).  ``place`` is how weights carry across: the
  reference's numpy parameters become each rank's blocks.

The spec logic needs the mesh's shape and names alone, so specs and
blocks can be checked without a process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compat import pytree

__all__ = ["NamedSharding", "PartitionSpec", "block_index", "entries", "gather",
           "gather_tree", "local_block", "place", "replicated_axes",
           "ShapeDtype", "shard_shape", "spec_axes"]


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry a leading dimension (None, an
    axis name or a tuple of names); missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A tensor's layout over ``mesh``: ``spec`` splits its dimensions."""

    mesh: object
    spec: PartitionSpec

    def entries(self, ndim: int) -> tuple:
        return entries(self.spec, ndim, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"


def entries(spec, ndim: int, mesh=None) -> tuple:
    """``spec`` over ``ndim`` dimensions, each entry None or a tuple of axis
    names (a single name as a 1-tuple); the axes checked against ``mesh``:
    known, in mesh order, each used once."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dimensions")
    out = []
    for e in spec + (None,) * (ndim - len(spec)):
        if e is None or e == ():
            out.append(None)
        else:
            out.append((e,) if isinstance(e, str) else tuple(e))
    if mesh is not None:
        used = [a for e in out if e for a in e]
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} uses an axis twice")
        for e in out:
            if e and tuple(a for a in mesh.axis_names if a in e) != e:
                raise ValueError(f"spec entry {e}: axes unknown or out of mesh "
                                 f"order {mesh.axis_names}")
    return tuple(out)


def spec_axes(sharding: NamedSharding, ndim: int) -> set:
    """The mesh axes that split a tensor of ``ndim`` dimensions."""
    return {a for e in sharding.entries(ndim) if e for a in e}


def replicated_axes(sharding: NamedSharding, ndim: int) -> tuple:
    """The mesh axes a tensor is replicated along (mesh order)."""
    used = spec_axes(sharding, ndim)
    return tuple(a for a in sharding.mesh.axis_names if a not in used)


def _ways(mesh, e) -> int:
    n = 1
    for a in e:
        n *= mesh.shape[a]
    return n


def shard_shape(shape, sharding: NamedSharding) -> tuple:
    """The block shape each rank holds; raises where a split dimension does
    not divide."""
    shape = tuple(int(s) for s in shape)
    out = []
    for dim, e in zip(shape, sharding.entries(len(shape))):
        n = 1 if e is None else _ways(sharding.mesh, e)
        if dim % n:
            raise ValueError(f"dimension {dim} of {shape} does not split {n} ways "
                             f"({sharding!r})")
        out.append(dim // n)
    return tuple(out)


def block_index(sharding: NamedSharding, coords: dict, ndim: int) -> tuple:
    """Per dimension, the index of the block the rank at ``coords`` holds
    (row-major over the entry's axes: ``("pod", "data")`` pod-major)."""
    out = []
    for e in sharding.entries(ndim):
        i = 0
        for a in e or ():
            i = i * sharding.mesh.shape[a] + coords[a]
        out.append(i)
    return tuple(out)


def local_block(x, sharding: NamedSharding, coords: dict | None = None):
    """The block of the global array ``x`` (numpy or torch) that the rank
    at ``coords`` (this rank's by default) holds, as a contiguous copy of
    the same kind."""
    if coords is None:
        coords = sharding.mesh.coords
    shape = tuple(x.shape)
    block = shard_shape(shape, sharding)
    index = block_index(sharding, coords, len(shape))
    sl = tuple(slice(i * b, (i + 1) * b) for i, b in zip(index, block))
    part = x[sl]
    if isinstance(part, torch.Tensor):
        return part.contiguous().clone()
    return np.array(part)


def gather(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The global tensor of which every rank holds its block ``local``: a
    collective, every rank of the mesh calls it.  Not differentiable."""
    from repro_torch.core import collectives as coll

    out = local.detach()
    for dim, e in enumerate(sharding.entries(local.dim())):
        if e:
            out = coll.all_gather_raw(out, sharding.mesh, e, dim)
    return out


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def place(tree, shardings, device: str | torch.device, coords: dict | None = None):
    """Each leaf of ``tree`` (numpy arrays, bf16 from ml_dtypes included,
    or tensors) cut to the block its sharding in ``shardings`` (a tree of
    the same structure) gives this rank (or the rank at ``coords``), as a
    tensor on ``device``."""
    return pytree.tree_map(
        lambda a, s: _to_tensor(local_block(a, s, coords), device), tree, shardings)


def gather_tree(tree, shardings):
    """:func:`gather` of every leaf, in the tree's order (every rank calls
    it)."""
    return pytree.tree_map(gather, tree, shardings)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's global shape and dtype, without its data (the port's
    ``jax.ShapeDtypeStruct``): a pytree leaf."""

    shape: tuple
    dtype: torch.dtype

