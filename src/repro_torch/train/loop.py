"""Fault-tolerant training loop.

The port of ``repro.train.loop``:

  * **checkpoint/restart** — ``Trainer.run`` checkpoints every
    ``ckpt_every`` steps (async writer, atomic rename) and ``resume()``s
    from the newest complete step after a crash; the data pipeline is
    deterministic per step, so only the step counter is stored, and a
    resumed run repeats the uninterrupted one's losses and parameters bit
    for bit where the step itself is deterministic (on the card: the GNNs,
    whose gathers and sums go through the segment-sum kernel),
  * **straggler mitigation** — per-step wall times feed an EWMA; a step
    longer than ``straggler_factor`` x the EWMA fires ``on_straggler``,
  * **heartbeat** — a liveness file updated every step lets an external
    supervisor tell slow from dead (``heartbeat_path``),
  * **NaN guard** — a non-finite loss keeps the old parameters and
    optimiser state (a ``torch.where`` on every leaf, no host read inside
    the step), counts the skip and goes on with the next batch; more than
    ``max_nan_skips`` in a row abort.

A step is ``torch.autograd.grad`` of ``loss_fn(params, batch)`` over the
flattened parameter leaves, then :func:`repro_torch.optim.adamw_update`;
the loop reads the loss once a step.

Sharded training (``mesh=``, ``cell=``): every rank of the mesh runs
the Trainer on its blocks of a train cell
(:class:`repro_torch.launch.workloads.Workload`) built on that mesh.
``init_params`` are this rank's blocks of the cell's parameter shardings,
the moments start as the cell's ``init_opt`` blocks, ``loss_fn`` is the
sharded loss (the cell's ``loss``) and ``batch_fn`` gives this rank's
batch; the update is the cell's own (ZeRO-1 for the LM and FM, the plain
update for a GNN, whose gradients are whole on every rank), so the step
is the cell's ``step``.  ``Trainer.shardings`` (the reference's
``shardings=``) are the cell's ``{"params", "opt"}`` layouts.
Checkpoints gather the global arrays and rank 0 writes them, in the
layout either package reads; ``resume()`` takes this rank's blocks of
them onto ``shardings``, whatever mesh wrote them (the elastic re-mesh
restore).
Like the reference's, the Trainer exchanges no compressed gradients
(:mod:`repro_torch.optim.compression` is a separate exchange over a
process group).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.compat import pytree
from repro_torch.optim import adamw_init, adamw_update


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    keep: int = 3
    async_ckpt: bool = True
    lr: float = 3e-4
    straggler_factor: float = 3.0
    heartbeat_path: str | None = None
    max_nan_skips: int = 5
    log_every: int = 10


class Trainer:
    """Drives (loss_fn, params, batches) to ``n_steps`` with the FT machinery.

    ``loss_fn(params, batch) -> scalar tensor``; ``batch_fn(step) -> batch``
    (a dict of numpy arrays or tensors) must be deterministic in ``step``
    (the restart contract).  Numpy arrays go to the parameters' device.
    ``step_walls`` keeps each step's host wall (seconds, ending in the
    loss's read).
    """

    def __init__(
        self,
        loss_fn: Callable,
        init_params,
        batch_fn: Callable[[int], dict],
        cfg: TrainConfig,
        mesh=None,
        cell=None,
        on_straggler: Callable[[int, float], None] | None = None,
    ):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self.on_straggler = on_straggler
        self.mesh = mesh
        self.params = init_params
        self.device = pytree.tree_leaves(init_params)[0].device
        if mesh is None:
            self.shardings = None
            self.opt = adamw_init(init_params)
            self._update = adamw_update
        else:
            if cell is None:
                raise ValueError("a sharded Trainer needs the train cell (cell=) it runs")
            self.shardings = {"params": cell.in_shardings[0], "opt": cell.in_shardings[1]}
            self.opt = cell.init_opt(self.device)
            self._update = cell.update
        self.step = 0
        self.nan_skips = 0
        self.straggler_events: list[tuple[int, float]] = []
        self.losses: list[float] = []
        self.step_walls: list[float] = []
        self._mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, async_save=cfg.async_ckpt,
                                      mesh=mesh)

    def _train_step(self, batch):
        flat, spec = pytree.tree_flatten(self.params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = self.loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        with torch.no_grad():
            new_params, new_opt, gn = self._update(
                self.params, pytree.tree_unflatten(grads, spec), self.opt, lr=self.cfg.lr)
            # NaN guard: keep the old state when the loss is non-finite
            ok = torch.isfinite(loss.detach())
            self.params = pytree.tree_map(lambda n, o: torch.where(ok, n, o),
                                          new_params, self.params)
            self.opt = pytree.tree_map(lambda n, o: torch.where(ok, n, o), new_opt, self.opt)
        return loss.detach(), gn

    def _to_device(self, batch):
        return pytree.tree_map(
            lambda v: torch.from_numpy(v).to(self.device) if isinstance(v, np.ndarray) else v,
            batch)

    # -- restart ----------------------------------------------------------
    def resume(self) -> bool:
        """Restore the newest checkpoint if present.  Returns True if resumed."""
        if latest_step(self.cfg.ckpt_dir) is None:
            return False
        state = {"params": self.params, "opt": self.opt}
        tree, aux, _ = restore_checkpoint(self.cfg.ckpt_dir, state, shardings=self.shardings)
        self.params, self.opt = tree["params"], tree["opt"]
        self.step = int(aux["next_step"])
        return True

    def _checkpoint(self):
        self._mgr.save(
            self.step,
            {"params": self.params, "opt": self.opt},
            aux={"next_step": self.step},
            shardings=self.shardings,
        )

    # -- main loop --------------------------------------------------------
    def run(self, until: int | None = None):
        until = until if until is not None else self.cfg.n_steps
        ewma = None
        while self.step < until:
            t0 = time.perf_counter()
            batch = self._to_device(self.batch_fn(self.step))
            loss, _ = self._train_step(batch)
            loss = float(loss)
            if not np.isfinite(loss):
                self.nan_skips += 1
                if self.nan_skips > self.cfg.max_nan_skips:
                    raise FloatingPointError(
                        f"{self.nan_skips} consecutive non-finite losses at step {self.step}"
                    )
            else:
                self.nan_skips = 0
            self.losses.append(loss)
            dt = time.perf_counter() - t0
            self.step_walls.append(dt)

            # straggler detection (EWMA of step time)
            if ewma is None:
                ewma = dt
            if dt > self.cfg.straggler_factor * ewma and self.step > 2:
                self.straggler_events.append((self.step, dt))
                if self.on_straggler:
                    self.on_straggler(self.step, dt)
            ewma = 0.9 * ewma + 0.1 * dt

            # heartbeat for the external supervisor
            if self.cfg.heartbeat_path:
                os.makedirs(
                    os.path.dirname(os.path.abspath(self.cfg.heartbeat_path)),
                    exist_ok=True,
                )
                with open(self.cfg.heartbeat_path, "w") as f:
                    f.write(f"{self.step} {time.time()}\n")

            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"[train] step={self.step} loss={loss:.4f} dt={dt*1e3:.1f}ms")
        self._checkpoint()
        self._mgr.wait()
        return self.losses

    def close(self):
        self._mgr.close()
