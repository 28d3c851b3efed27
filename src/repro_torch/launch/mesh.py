"""The sharded engine's mesh on ``torch.distributed``.

The port of ``repro.launch.mesh``'s ``make_engine_mesh`` and ``mesh_size``
(the reference's production meshes and its HLO tools are not ported).  The
reference's engine mesh is a 1-D ``jax.sharding.Mesh`` over the devices of
one process; here it is one process per rank: :class:`EngineMesh` names the
process group the ranks of one engine talk over, this process's rank in it,
the group's size (the engine's shard count) and its backend.  Each rank
holds its shard of the arena on its own device (the caller's ``device=``).

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

__all__ = ["EngineMesh", "init_process_group", "make_engine_mesh", "mesh_size",
           "spawn"]

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
    """The engine's shard count on ``mesh`` (1 without one)."""
    return 1 if mesh is None else int(mesh.world)


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
