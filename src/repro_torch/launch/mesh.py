"""Meshes on ``torch.distributed``: the sharded engine's and the named
multi-axis meshes of sharded training.

The port of ``repro.launch.mesh`` (its HLO tools are not ported).  The
reference's meshes are ``jax.sharding.Mesh``es over the devices of one
process; here each rank is a process.

* :class:`EngineMesh` (``make_engine_mesh``): the sharded engine's 1-D
  mesh: the process group the ranks of one engine talk over, this
  process's rank in it, the group's size (the engine's shard count) and
  its backend.  Each rank holds its shard of the arena on its own device
  (the caller's ``device=``).
* :class:`Mesh` (``make_mesh``, ``make_production_mesh``): a named mesh
  such as (data 2, model 2) for sharded training: rank ``r`` sits at the
  row-major coordinate of ``r``, and every set of axes has its process
  groups (the ranks that differ only along those axes), so a collective
  runs over ``model``, over ``("pod", "data")`` or over the whole mesh.
  ``abstract_mesh`` is the shape alone (no group), for the specs of
  :mod:`repro_torch.launch.sharding`.  ``data_axes`` and ``model_axis``
  name the batch-parallel and the tensor-parallel axes.

:func:`spawn` starts ``world`` processes (start method ``spawn``, so a
parent that has initialised CUDA can start them) that rendezvous through a
``FileStore``: no port is bound, so many groups can start at once on one
machine.  A rank that raises fails the whole run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "EngineMesh", "Mesh", "abstract_mesh", "data_axes",
           "init_process_group", "make_engine_mesh", "make_mesh",
           "make_production_mesh", "mesh_size", "model_axis", "spawn"]

# how long a rank waits in a collective before the group fails (a hang
# fails the run instead of eating its time limit)
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class EngineMesh:
    """One engine's ranks: ``group`` (a process group; ``None`` is the
    default group), this process's ``rank`` in it, its size ``world`` and
    its ``backend`` ("nccl" or "gloo"); the group stands for the
    reference's named mesh axis.

    The collectives of :mod:`repro_torch.core.collectives` count what they
    carry here: ``calls`` and ``bytes`` (the bytes each rank sends) by
    collective."""

    group: object
    rank: int
    world: int
    backend: str
    calls: Counter = dataclasses.field(default_factory=Counter)
    bytes: Counter = dataclasses.field(default_factory=Counter)

    def counts(self) -> dict:
        """The collectives' counts as plain dicts."""
        return dict(calls=dict(self.calls), bytes=dict(self.bytes))

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()


def init_process_group(backend: str, rank: int, world: int, store_path: str,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path`` (a file every rank can reach, absent or empty at the
    start)."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_engine_mesh(n_devices: int | None = None, *,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> EngineMesh | None:
    """The mesh of the sharded engine over the initialised default group,
    or over a new group of its first ``n_devices`` ranks (the reference
    builds a mesh over a prefix of its devices the same way), or over a new
    group of them on another ``backend`` (a gloo group beside an NCCL one
    carries CPU tensors).

    Every rank of the default group must call it (``new_group`` is
    collective); a rank outside the first ``n_devices`` gets ``None``."""
    if not dist.is_initialized():
        raise RuntimeError("make_engine_mesh: no process group; call "
                           "init_process_group (or spawn) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    if n == world and backend in (None, dist.get_backend()):
        group = None
    else:
        group = dist.new_group(list(range(n)), backend=backend,
                               timeout=datetime.timedelta(seconds=timeout_s))
    if rank >= n:
        return None
    backend = str(dist.get_backend(group))
    return EngineMesh(group=group, rank=rank, world=n, backend=backend)


def mesh_size(mesh) -> int:
    """The ranks of ``mesh``: an engine's shard count, or a named mesh's
    size (1 without one)."""
    if mesh is None:
        return 1
    return int(mesh.size) if isinstance(mesh, Mesh) else int(mesh.world)


def _run_rank(rank: int, fn, world: int, backend: str, store_path: str,
              timeout_s: float, threads: int | None, args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    init_process_group(backend, rank, world, store_path, timeout_s)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, backend: str = "gloo",
          store_path: str, timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int | None = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one default group (``backend``, rendezvous through a ``FileStore`` at
    ``store_path``).  ``fn`` must be importable by name (a module-level
    function).  ``threads`` sets each rank's intra-op thread count.
    Returns when every rank has finished; raises if any failed (the others
    then fail at their next collective, by its timeout at the latest)."""
    import torch.multiprocessing as mp

    if os.path.exists(store_path) and os.path.getsize(store_path):
        raise ValueError(f"store file {store_path} is in use")
    mp.start_processes(_run_rank, nprocs=world, join=True, start_method="spawn",
                       args=(fn, world, backend, store_path, timeout_s, threads,
                             tuple(args)))


# -- named multi-axis meshes (sharded training) ------------------------------

def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks of a mesh that differ only along ``axes`` (in mesh
    order): ``group`` (None for the mesh's default group; unused when
    ``size`` is 1), their count and this rank's place among them, which is
    the row-major index of its coordinates along ``axes``."""

    axes: tuple
    group: object
    size: int
    index: int

    @property
    def label(self) -> str:
        return "+".join(self.axes)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named mesh: ``axis_names`` and their ``sizes``, as
    ``jax.sharding.Mesh``.  Rank ``r`` of the mesh sits at the row-major
    coordinate of ``r`` (the first axis the slowest), as ``jax.make_mesh``
    lays devices out, so a block is held by the rank at the coordinate
    JAX's shard has.

    A mesh made by :func:`abstract_mesh` has only its shape (``rank`` is
    None): the sharding specs and block arithmetic of
    :mod:`repro_torch.launch.sharding` need no more.  One made by
    :func:`make_mesh` also holds this process's ``rank``, its ``backend``
    and a process group for every set of axes, and counts what the
    collectives of :mod:`repro_torch.core.collectives` carry over it:
    ``calls`` and ``bytes`` (the bytes each rank sends) keyed
    ``"<axes>:<op>"``, as :class:`EngineMesh` counts by op."""

    axis_names: tuple
    sizes: tuple
    rank: int | None = None
    backend: str | None = None
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    calls: Counter = dataclasses.field(default_factory=Counter)
    bytes: Counter = dataclasses.field(default_factory=Counter)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return _prod(self.sizes)

    @property
    def coords(self) -> dict:
        """This rank's coordinate along each axis."""
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank")
        return coords_of(self, self.rank)

    def axis(self, axes) -> AxisGroup:
        """The group of ``axes`` (a name or a tuple of names, in mesh
        order) that holds this rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key != axes:
            raise ValueError(f"axes {axes} are not in mesh order {self.axis_names}")
        if self.rank is None:
            raise ValueError("an abstract mesh has no process groups")
        c = self.coords
        size = _prod(self.shape[a] for a in axes)
        index = 0
        for a in axes:
            index = index * self.shape[a] + c[a]
        if size == 1:
            return AxisGroup(axes, None, 1, 0)
        return AxisGroup(axes, self.groups[axes], size, index)

    def counts(self) -> dict:
        return dict(calls=dict(self.calls), bytes=dict(self.bytes))

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()


def coords_of(mesh, rank: int) -> dict:
    """The row-major coordinate of ``rank`` on ``mesh``."""
    out = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[name] = rank % size
        rank //= size
    return {a: out[a] for a in mesh.axis_names}


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` named ``axes`` with no ranks: for specs and
    block arithmetic."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes}")
    return Mesh(axes, shape)


def make_mesh(shape, axes, *, backend: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh | None:
    """A named mesh over the first ``prod(shape)`` ranks of the
    initialised default group (``jax.make_mesh``), with a process group
    for every set of two or more ranks that differ only along some axes
    (``backend``: the default group's unless given).  Every rank of the
    default group must call it, with the same arguments (``new_group`` is
    collective); a rank outside the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_process_group (or spawn) first")
    mesh = abstract_mesh(shape, axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = mesh.size
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    names = mesh.axis_names
    for k in range(1, 1 << len(names)):
        sub = tuple(a for i, a in enumerate(names) if k >> i & 1)
        if _prod(mesh.shape[a] for a in sub) == 1:
            continue
        members: dict = {}
        for r in range(n):
            c = coords_of(mesh, r)
            members.setdefault(tuple(c[a] for a in names if a not in sub), []).append(r)
        for ranks in members.values():
            if (len(ranks) == world and world == n
                    and backend in (None, dist.get_backend())):
                group = None
            else:
                group = dist.new_group(ranks, backend=backend, timeout=timeout)
            if rank in ranks:
                groups[sub] = group
    if rank >= n:
        return None
    mesh.rank = rank
    mesh.groups = groups
    mesh.backend = str(dist.get_backend(groups.get(names)))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh | None:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``, over the default group (which
    must hold that many ranks).  A function, so importing this module
    touches no group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple:
    """All batch-parallel axes of a mesh (pod + data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None
