"""Atomic, async checkpointing in the reference's layout.

The port of ``repro.ckpt.checkpoint``.  One directory per step:

    <dir>/step_000000042.tmp-<pid>/   — being written
        manifest.json                 — keys, shapes, dtypes, aux state
        arrays.npz                    — one entry per leaf
    <dir>/step_000000042/             — renamed when complete

  * **atomicity** — write into a ``.tmp-<pid>`` dir, fsync the manifest,
    ``os.rename``; a crashed writer never corrupts the latest checkpoint,
    and restore picks the newest complete step directory,
  * **async** — ``CheckpointManager(async_save=True)`` copies the tree to
    host memory synchronously and writes on a daemon thread,
  * **retention** — keeps the newest ``keep`` checkpoints, deleting older
    ones only after a successful save,
  * **sharded trees** — with ``shardings`` (a tree of
    :class:`~repro_torch.launch.sharding.NamedSharding`), a save gathers
    every leaf's global array on every rank (a collective: every rank of
    the mesh calls it), and only rank 0 keeps it on the host and writes;
    ``restore_checkpoint(..., shardings=)`` reads the global arrays and
    takes this rank's blocks, on whatever mesh the shardings name: the
    elastic re-mesh restore.

The leaves are stored in JAX's flatten order (dict keys sorted, lists and
tuples in order) under ``jax.tree_util.keystr`` keys, such as
``['layers'][0]['phi_e'][0][0]``, and bf16 as its 16-bit pattern with the
manifest dtype ``"bfloat16"``.  So a checkpoint written by either package
restores in the other: the two trees' keys must be equal, or restore
raises.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.sharding import gather, local_block

_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr, leaf) pairs in JAX's order: dict keys sorted, sequences in
    order; None is an empty node."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(target, leaves):
    """``target``'s structure with its leaves replaced, in ``_flatten``'s
    order, by the iterator ``leaves``."""
    if isinstance(target, dict):
        new = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: new[k] for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, leaves) for v in target)
    if target is None:
        return None
    return next(leaves)


def _to_numpy(v: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the array stored and its manifest dtype."""
    v = v.detach()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
    a = v.cpu().numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (0-d stays 0-d)
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _gathered(tree, shardings):
    """The global arrays of a sharded tree on the host of rank 0 (None
    elsewhere), gathered leaf by leaf (every rank calls it)."""
    flat_s = [s for _, s in _flatten(shardings)]
    flat = _flatten(tree)
    if len(flat_s) != len(flat):
        raise ValueError("tree and shardings differ in structure")
    writer = flat_s[0].mesh.rank == 0 if flat_s else True
    host = []
    for (_, v), sh in zip(flat, flat_s):
        g = gather(v, sh)
        host.append(g.to("cpu", copy=True) if writer else None)
        del g
    return _unflatten(tree, iter(host)) if writer else None


def save_checkpoint(directory: str, step: int, tree, aux: dict | None = None,
                    shardings=None) -> str:
    """Synchronous atomic save of a tree of tensors (with ``shardings``,
    of this rank's blocks: every rank calls it, rank 0 writes).  Returns
    the final checkpoint path."""
    final = os.path.join(directory, f"step_{step:09d}")
    if shardings is not None:
        tree = _gathered(tree, shardings)
        if tree is None:
            return final
    os.makedirs(directory, exist_ok=True)
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    stored = [_to_numpy(v) for _, v in flat]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(stored)})
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "shapes": [list(a.shape) for a, _ in stored],
        "dtypes": [dtype for _, dtype in stored],
        "aux": aux or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target, step: int | None = None,
                       device: str | torch.device | None = None, shardings=None):
    """Restore into the structure of ``target`` (a tree of tensors).  Each
    leaf takes its target's dtype and goes to ``device``, or where its
    target lies when ``device`` is None.  With ``shardings`` (a tree like
    ``target``), each leaf is this rank's block of the stored global
    array.  Returns (tree, aux, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _flatten(target)
    keys_t = [k for k, _ in flat_t]
    if keys_t != manifest["keys"]:
        raise ValueError(
            f"checkpoint structure mismatch: {set(manifest['keys']) ^ set(keys_t)}"
        )
    flat_s = [None] * len(flat_t) if shardings is None else [
        sh for _, sh in _flatten(shardings)]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        vals = [_to_tensor(data[f"a{i}"] if sh is None else local_block(data[f"a{i}"], sh),
                           dtype)
                for i, (dtype, sh) in enumerate(zip(manifest["dtypes"], flat_s))]
    vals = [v.to(device=t.device if device is None else device, dtype=t.dtype)
            for v, (_, t) in zip(vals, flat_t)]
    return _unflatten(target, iter(vals)), manifest["aux"], step


def _host_copy(tree):
    """The tree's tensors copied to host memory now: the card's copies
    are queued and then awaited, so later writes to the tensors (in place
    or on the card's stream) cannot reach the copy."""
    leaves = [v for _, v in _flatten(tree)]
    host = [v.detach().to("cpu", copy=True, non_blocking=True) for v in leaves]
    for dev in {v.device for v in leaves if v.is_cuda}:
        torch.cuda.synchronize(dev)
    return _unflatten(tree, iter(host))


class CheckpointManager:
    """Retention + optional async writer around ``save_checkpoint``.  With
    a ``mesh`` the trees saved are sharded (``save(..., shardings=)``): the
    gather runs on every rank, the write and retention on rank 0, and
    ``wait`` returns on every rank once rank 0's writes are done."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False,
                 mesh=None):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self._q: queue.Queue = queue.Queue()
        self._err: list[Exception] = []
        self._thread = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, aux = item
            try:
                save_checkpoint(self.directory, step, tree, aux)
                self._gc()
            except Exception as e:  # surfaced on the next save()/wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n[5:])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"))

    def save(self, step: int, tree, aux: dict | None = None, shardings=None):
        if self._err:
            raise self._err.pop()
        if shardings is not None:
            tree = _gathered(tree, shardings)  # every rank; the host copy on rank 0
            if tree is None:
                return
            if not self.async_save:
                save_checkpoint(self.directory, step, tree, aux)
                self._gc()
                return
            self._q.put((step, tree, aux))
        elif self.async_save:
            # the host snapshot now; the disk write on the worker thread
            self._q.put((step, _host_copy(tree), aux))
        else:
            save_checkpoint(self.directory, step, tree, aux)
            self._gc()

    def wait(self):
        if self.async_save:
            self._q.join()
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier(group=self.mesh.axis(self.mesh.axis_names).group)
        if self._err:
            raise self._err.pop()

    def close(self):
        if self.async_save and self._thread is not None:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=60)
            self._thread = None
