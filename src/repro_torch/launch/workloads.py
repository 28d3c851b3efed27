"""Train cells: (architecture x shape x mesh) -> a step on each rank's
blocks and its shardings.

The port of ``repro.launch.workloads`` for the train cells: how each
architecture family is sharded for training (the reference's "single
source of truth"), on a named :class:`~repro_torch.launch.mesh.Mesh`.

* LM: parameters by ``transformer.param_shardings`` (with ``fsdp`` also
  over the data axes), tokens and labels by rows over the data axes, the
  AdamW moments ZeRO-1 (``opt_state_shardings``); an MoE config routes one
  token chunk a data rank with its experts over ``model``
  (``n_token_shards``, ``dp_axes``, ``ep_axis``);
* GNN: edge-parallel: the edge arrays (and DimeNet's triplets) split over
  the data axes, node arrays, parameters and moments whole (edges padded
  to a multiple of 512, as the reference pads them);
* FM: the table and first-order weights by rows over ``model``, the batch
  by rows over the data axes, the moments ZeRO-1.

``Workload.step(params, opt, *batch)`` runs one training step on this
rank's blocks (every rank of the mesh calls it) and returns ``(params,
opt, loss, gnorm)``, the loss and norm global: ``loss(params, *batch)``
differentiated, then ``update(params, grads, opt, lr=)``, the family's
AdamW (ZeRO-1 for the LM and FM, whose gradients are partial over the data
axes; the plain update for a GNN, whose gradients are whole on every
rank).  ``init_opt(device)`` gives this rank's zero AdamW state.  The
sharded :class:`~repro_torch.train.Trainer` runs a cell's ``update`` and
``init_opt``.  ``input_specs`` holds the global shapes
(:class:`~repro_torch.launch.sharding.ShapeDtype`) and ``in_shardings``
the layout of each input, so that
:func:`~repro_torch.launch.sharding.place` cuts global arrays into the
blocks a rank takes.  The serving kinds (prefill, decode, the FM's serve
and retrieval) and the engine cell raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import NamedSharding, PartitionSpec as P, ShapeDtype
from repro_torch.models import recsys as fm_model
from repro_torch.models import transformer as lm
from repro_torch.models.gnn import dimenet as m_dimenet
from repro_torch.models.gnn import egnn as m_egnn
from repro_torch.models.gnn import gatedgcn as m_gatedgcn
from repro_torch.models.gnn import pna as m_pna
from repro_torch.optim import adamw_init_blocks, adamw_update, opt_state_shardings

__all__ = ["Workload", "build_cell", "build_gnn_cell", "build_lm_cell",
           "build_recsys_cell", "opt_shapes", "value_and_grad"]

F32, I32 = torch.float32, torch.int32
NOT_PORTED = ("{} cells are not ported yet (ROADMAP: Not ported, the sharded "
              "serving and engine cells of launch/workloads.py)")


@dataclasses.dataclass
class Workload:
    name: str
    input_specs: tuple  # global ShapeDtypes of the step's positional inputs
    in_shardings: tuple
    loss: Callable  # (params, *batch) -> the global loss
    update: Callable  # (params, grads, opt, lr=) -> (params, opt, gnorm)

    def init_opt(self, device) -> dict:
        """Zero AdamW state: this rank's blocks of the moments' shardings."""
        return adamw_init_blocks(self.input_specs[0], self.in_shardings[1]["mu"], device)

    def step(self, params, opt, *batch):
        value, grads = value_and_grad(self.loss, params, *batch)
        with torch.no_grad():
            params, opt, gn = self.update(params, grads, opt)
        return params, opt, value, gn


def _ns(mesh, *spec):
    return NamedSharding(mesh, P(*spec))


def opt_shapes(param_shapes) -> dict:
    """The AdamW state's global shapes: f32 moments of each parameter's."""
    def f32(sh):
        return ShapeDtype(tuple(sh.shape), F32)

    return {"mu": pytree.tree_map(f32, param_shapes),
            "nu": pytree.tree_map(f32, param_shapes), "step": ShapeDtype((), I32)}


def value_and_grad(loss, params, *args):
    """``loss(params, *args)`` and its gradient, a tree like ``params``
    (zeros where a leaf is unused)."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    value = loss(pytree.tree_unflatten(leaves, spec), *args)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return value.detach(), pytree.tree_unflatten(grads, spec)


def _zero1_update(oshard, pshard):
    def update(params, grads, opt, lr: float = 3e-4):
        return adamw_update(params, grads, opt, lr=lr, mom_shardings=oshard["mu"],
                            param_shardings=pshard)

    return update


def _replicated_update(params, grads, opt, lr: float = 3e-4):
    return adamw_update(params, grads, opt, lr=lr)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def build_lm_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    if shape.kind != "train":
        raise NotImplementedError(NOT_PORTED.format(f"LM {shape.kind}"))
    cfg = spec.config
    dp = data_axes(mesh)
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    if cfg.is_moe:
        # sort-based MoE dispatch: one token chunk per data shard, experts
        # over the model axis (see models/moe.py)
        n_tok_shards = 1
        for a in dp:
            n_tok_shards *= mesh.shape[a]
        cfg = dataclasses.replace(cfg, n_token_shards=n_tok_shards, dp_axes=tuple(dp),
                                  ep_axis="model")
    pshard = lm.param_shardings(cfg, mesh, dp=dp)
    pshapes = lm.param_shapes(cfg)
    oshard = opt_state_shardings(pshard, pshapes, mesh, dp=dp)

    def loss(params, tokens, labels):
        return lm.loss_fn(params, cfg, tokens, labels, mesh=mesh)

    inputs = (pshapes, opt_shapes(pshapes), ShapeDtype((b, s), I32),
              ShapeDtype((b, s), I32))
    in_sh = (pshard, oshard, _ns(mesh, dp, None), _ns(mesh, dp, None))
    return Workload(f"{spec.name}:{shape.name}", inputs, in_sh, loss,
                    _zero1_update(oshard, pshard))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

_GNN_MODULES = {
    "dimenet": m_dimenet,
    "egnn": m_egnn,
    "gatedgcn": m_gatedgcn,
    "pna": m_pna,
}


def _gnn_batch_specs(arch: str, n: int, e: int, d: int, n_graphs: int,
                     n_triplets: int) -> dict:
    """The global shapes of a GNN cell's batch (the arrays each arch needs)."""
    batch = {"x": ShapeDtype((n, d), F32), "edge_index": ShapeDtype((2, e), I32)}
    if arch == "gatedgcn":
        batch["edge_attr"] = ShapeDtype((e, 1), F32)
    if arch in ("gatedgcn", "pna"):
        batch["labels"] = ShapeDtype((n,), I32)
        batch["train_mask"] = ShapeDtype((n,), F32)
    if arch in ("egnn", "dimenet"):
        batch["pos"] = ShapeDtype((n, 3), F32)
        batch["graph_ids"] = ShapeDtype((n,), I32)
        batch["y"] = ShapeDtype((n_graphs,), F32)
    if arch == "dimenet":
        batch["z"] = ShapeDtype((n,), I32)
        batch["triplets"] = ShapeDtype((2, n_triplets), I32)
    return batch


def _gnn_batch_shardings(batch_specs: dict, mesh, dp) -> dict:
    """Edge-parallel: edge-indexed arrays over dp, node arrays whole."""
    sh = {}
    for k, v in batch_specs.items():
        if k in ("edge_index", "triplets"):
            sh[k] = _ns(mesh, None, dp)
        elif k == "edge_attr":
            sh[k] = _ns(mesh, dp, None)
        else:
            sh[k] = _ns(mesh, *([None] * len(v.shape)))
    return sh


def gnn_param_shapes(arch: str, cfg) -> dict:
    """The parameters' shapes (a CPU draw of the small GNN weights)."""
    params = _GNN_MODULES[arch].init_params(torch.Generator().manual_seed(0), cfg,
                                            device="cpu")
    return pytree.tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), params)


def build_gnn_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    arch = spec.name
    mod = _GNN_MODULES[arch]
    dims = shape.dims
    dp = data_axes(mesh)
    if shape.name == "molecule":
        n_graphs = dims["batch"]
        n = dims["n_nodes"] * n_graphs
        e = dims["n_edges"] * n_graphs
        d = 16
    elif shape.name == "minibatch_lg":
        n, e, d = dims["sub_nodes"], dims["sub_edges"], 602
        n_graphs = 1
    else:
        n, e, d = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
        n_graphs = 1
    # edge arrays are split over the data axes; padded to a common multiple
    # (the pipeline pads real batches with zero-weight self-loop edges)
    e = (e + 511) // 512 * 512
    n_triplets = min(2 * e, 8_000_000)  # capped triplet sampling, as the reference

    cfg = spec.config
    if arch in ("gatedgcn", "pna", "egnn"):
        cfg = dataclasses.replace(cfg, d_in=d)
    batch_specs = _gnn_batch_specs(arch, n, e, d, n_graphs, n_triplets)
    if arch == "dimenet":  # x last, as the reference orders it
        batch_specs["x"] = batch_specs.pop("x")
    pshapes = gnn_param_shapes(arch, cfg)
    pshard = pytree.tree_map(lambda _: _ns(mesh), pshapes)  # replicated (small)
    oshard = opt_state_shardings(pshard, pshapes, mesh, dp=())

    def loss(params, batch):
        batch = dict(batch)
        batch["n_graphs"] = n_graphs
        if arch == "dimenet" and "z" not in batch:
            batch["z"] = (batch["x"].sum(-1).abs().to(I32) % spec.config.n_species)
        if arch == "egnn" and "pos" not in batch:
            batch["pos"] = batch["x"][:, :3]
        return mod.loss_fn(params, cfg, batch, mesh=mesh)

    inputs = (pshapes, opt_shapes(pshapes), batch_specs)
    in_sh = (pshard, oshard, _gnn_batch_shardings(batch_specs, mesh, dp))
    # each rank's gradients are whole (edge_side sums the edge-side parts)
    return Workload(f"{spec.name}:{shape.name}", inputs, in_sh, loss, _replicated_update)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def build_recsys_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    if shape.kind != "train":
        raise NotImplementedError(NOT_PORTED.format(f"FM {shape.kind}"))
    cfg = spec.config
    dp = data_axes(mesh)
    pshard = fm_model.param_shardings(cfg, mesh)
    pshapes = fm_model.param_shapes(cfg)
    oshard = opt_state_shardings(pshard, pshapes, mesh, dp=dp)
    b = shape.dims["batch"]

    def loss(params, batch):
        return fm_model.loss_fn(params, cfg, batch, mesh=mesh)

    batch_specs = {"ids": ShapeDtype((b, cfg.n_fields), I32),
                   "labels": ShapeDtype((b,), F32)}
    batch_sh = {"ids": _ns(mesh, dp, None), "labels": _ns(mesh, dp)}
    inputs = (pshapes, opt_shapes(pshapes), batch_specs)
    in_sh = (pshard, oshard, batch_sh)
    return Workload(f"{spec.name}:{shape.name}", inputs, in_sh, loss,
                    _zero1_update(oshard, pshard))


def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    if spec.family == "lm":
        return build_lm_cell(spec, shape, mesh)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape, mesh)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, mesh)
    if spec.family == "engine":
        raise NotImplementedError(NOT_PORTED.format("engine"))
    raise ValueError(spec.family)
