"""Cells: (architecture x shape x mesh) -> a step on each rank's blocks and
its shardings.

The port of ``repro.launch.workloads``: how each architecture family is
sharded (the reference's "single source of truth"), on a named
:class:`~repro_torch.launch.mesh.Mesh`.  Every cell is a :class:`Workload`:

* ``step(*inputs)`` runs one step on this rank's blocks (every rank of
  the mesh calls it);
* ``input_specs`` holds the global shapes
  (:class:`~repro_torch.launch.sharding.ShapeDtype`) and ``in_shardings``
  the layout of each input, so that
  :func:`~repro_torch.launch.sharding.place` cuts global arrays into the
  blocks a rank takes; ``out_shardings`` lays out the outputs, so that
  :func:`~repro_torch.launch.sharding.gather` assembles them;
* ``donate`` names the inputs whose memory the step may reuse (the train
  state, the decode cache), as the reference donates them;
* ``model_flops`` is the reference's analytic count of useful FLOPs
  (``6ND`` and its kin) that :mod:`repro_torch.launch.roofline` reads.

The kinds:

* LM train: parameters by ``transformer.param_shardings`` (with ``fsdp``
  also over the data axes), tokens and labels by rows over the data axes,
  the AdamW moments ZeRO-1 (``opt_state_shardings``); an MoE config routes
  one token chunk a data rank with its experts over ``model``
  (``n_token_shards``, ``dp_axes``, ``ep_axis``).  ``step(params, opt,
  *batch)`` returns ``(params, opt, loss, gnorm)``, the loss and norm
  global: ``loss(params, *batch)`` differentiated, then ``update(params,
  grads, opt, lr=)``, the family's AdamW; ``init_opt(device)`` gives this
  rank's zero AdamW state (the sharded
  :class:`~repro_torch.train.Trainer` runs a cell's ``update`` and
  ``init_opt``);
* LM prefill: tokens by rows over the data axes; the last position's
  logits come out ``(dp, None, model)`` (vocab-parallel) and the KV cache
  ``(None, dp, model, None, None)``: each model rank holds its sequence
  block of every KV head;
* LM decode: one token a sequence (``dp``) at a host-int ``pos`` against
  that cache; each model rank attends every head over its block and the
  softmax states merge over ``model``; logits ``(dp, model)``;
* GNN train: edge-parallel: the edge arrays (and DimeNet's triplets)
  split over the data axes, node arrays, parameters and moments whole
  (edges padded to a multiple of 512, as the reference pads them);
* FM train: the table and first-order weights by rows over ``model``, the
  batch by rows over the data axes, the moments ZeRO-1; FM serve and
  retrieval: the table replicated (lookups stay on the rank), the batch or
  the candidates (padded to a multiple of 512) split over the whole mesh;
* engine: one SPMD round of REW (the reference's representative 2-atom
  sameAs join plan, then ``process_candidates``) over the flattened mesh:
  every axis forms one :class:`~repro_torch.launch.mesh.EngineMesh`, whose
  collectives the cell books on the named mesh as ``"<axes>:<op>"``.
  :func:`engine_arena` lays a triple set out as the cell's inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.compat import pytree
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.launch.mesh import EngineMesh, data_axes
from repro_torch.launch.sharding import NamedSharding, PartitionSpec as P, ShapeDtype
from repro_torch.models import recsys as fm_model
from repro_torch.models import transformer as lm
from repro_torch.models.gnn import dimenet as m_dimenet
from repro_torch.models.gnn import egnn as m_egnn
from repro_torch.models.gnn import gatedgcn as m_gatedgcn
from repro_torch.models.gnn import pna as m_pna
from repro_torch.optim import adamw_init_blocks, adamw_update, opt_state_shardings

__all__ = ["Workload", "build_cell", "build_engine_cell", "build_gnn_cell",
           "build_lm_cell", "build_recsys_cell", "engine_arena", "opt_shapes",
           "value_and_grad"]

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass
class Workload:
    name: str
    kind: str  # the shape's kind: train, prefill, decode, serve, retrieval, engine
    input_specs: tuple  # global ShapeDtypes of the step's positional inputs
    in_shardings: tuple
    out_shardings: object
    model_flops: float  # the reference's analytic useful FLOPs, all ranks
    loss: Callable | None = None  # train: (params, *batch) -> the global loss
    update: Callable | None = None  # train: (params, grads, opt, lr=) -> (params, opt, gnorm)
    forward: Callable | None = None  # the serving and engine kinds' step
    donate: tuple = ()  # inputs whose memory the step may reuse
    notes: str = ""

    def init_opt(self, device) -> dict:
        """Zero AdamW state: this rank's blocks of the moments' shardings."""
        return adamw_init_blocks(self.input_specs[0], self.in_shardings[1]["mu"], device)

    def step(self, *inputs):
        """One step on this rank's blocks: forward only (under no_grad) for
        the serving and engine kinds; for train, ``(params, opt, *batch) ->
        (params, opt, loss, gnorm)``."""
        if self.forward is not None:
            with torch.no_grad():
                return self.forward(*inputs)
        params, opt, *batch = inputs
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


def _train_out(pshard, oshard, mesh) -> tuple:
    return (pshard, oshard, _ns(mesh), _ns(mesh))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_model_flops(cfg, tokens: int, kind: str, kv_len: int = 0) -> float:
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * tokens
    if kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence + attention over the cache
    attn = 4.0 * tokens * kv_len * cfg.n_heads * cfg.d_head
    return 2.0 * n * tokens + attn * cfg.n_layers


def build_lm_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
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
    name = f"{spec.name}:{shape.name}"

    if shape.kind == "train":
        oshard = opt_state_shardings(pshard, pshapes, mesh, dp=dp)

        def loss(params, tokens, labels):
            return lm.loss_fn(params, cfg, tokens, labels, mesh=mesh)

        inputs = (pshapes, opt_shapes(pshapes), ShapeDtype((b, s), I32),
                  ShapeDtype((b, s), I32))
        in_sh = (pshard, oshard, _ns(mesh, dp, None), _ns(mesh, dp, None))
        return Workload(name, "train", inputs, in_sh, _train_out(pshard, oshard, mesh),
                        _lm_model_flops(cfg, b * s, "train"), loss=loss,
                        update=_zero1_update(oshard, pshard), donate=(0, 1))

    cache_sh = {"k": _ns(mesh, None, dp, "model", None, None),
                "v": _ns(mesh, None, dp, "model", None, None)}
    if shape.kind == "prefill":
        def prefill(params, tokens):
            return lm.prefill(params, cfg, tokens, mesh=mesh)

        inputs = (pshapes, ShapeDtype((b, s), I32))
        in_sh = (pshard, _ns(mesh, dp, None))
        out_sh = (_ns(mesh, dp, None, "model"), cache_sh)
        return Workload(name, "prefill", inputs, in_sh, out_sh,
                        _lm_model_flops(cfg, b * s, "prefill"), forward=prefill)

    # decode: one new token against a seq_len KV cache split by sequence
    def decode(params, cache, token, pos):
        return lm.decode_step(params, cfg, cache, token, pos, mesh=mesh)

    cache_shape = ShapeDtype((cfg.n_layers, b, s, cfg.n_kv, cfg.d_head), torch.bfloat16)
    inputs = (pshapes, {"k": cache_shape, "v": cache_shape}, ShapeDtype((b,), I32),
              ShapeDtype((), I32))
    in_sh = (pshard, cache_sh, _ns(mesh, dp), _ns(mesh))
    out_sh = (_ns(mesh, dp, "model"), cache_sh)
    return Workload(name, "decode", inputs, in_sh, out_sh,
                    _lm_model_flops(cfg, b, "decode", kv_len=s), forward=decode,
                    donate=(1,), notes="pos is a host int on every rank")


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
    # analytic FLOPs, the reference's: edge-dominated message passing
    h = getattr(cfg, "d_hidden", 64)
    depth = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 4))
    flops = 6.0 * e * h * h * depth
    if arch == "dimenet":
        flops += 6.0 * n_triplets * h * cfg.n_bilinear * depth
    # each rank's gradients are whole (edge_side sums the edge-side parts)
    return Workload(f"{spec.name}:{shape.name}", "train", inputs, in_sh,
                    _train_out(pshard, oshard, mesh), flops, loss=loss,
                    update=_replicated_update, donate=(0, 1))


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def build_recsys_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    cfg = spec.config
    dp = data_axes(mesh)
    pshapes = fm_model.param_shapes(cfg)
    dims = shape.dims
    name = f"{spec.name}:{shape.name}"

    if shape.kind == "train":
        pshard = fm_model.param_shardings(cfg, mesh)
        oshard = opt_state_shardings(pshard, pshapes, mesh, dp=dp)
        b = dims["batch"]

        def loss(params, batch):
            return fm_model.loss_fn(params, cfg, batch, mesh=mesh)

        batch_specs = {"ids": ShapeDtype((b, cfg.n_fields), I32),
                       "labels": ShapeDtype((b,), F32)}
        batch_sh = {"ids": _ns(mesh, dp, None), "labels": _ns(mesh, dp)}
        inputs = (pshapes, opt_shapes(pshapes), batch_specs)
        in_sh = (pshard, oshard, batch_sh)
        return Workload(name, "train", inputs, in_sh, _train_out(pshard, oshard, mesh),
                        6.0 * b * cfg.n_fields * cfg.embed_dim, loss=loss,
                        update=_zero1_update(oshard, pshard), donate=(0, 1))

    # serving: the table is read-only and fits a card, so it is replicated
    # (lookups stay on the rank, no collective) and the rows split over the
    # whole mesh
    serve_pshard = pytree.tree_map(lambda _: _ns(mesh), pshapes)
    all_axes = tuple(mesh.axis_names)
    if shape.kind == "serve":
        b = dims["batch"]

        def serve(params, batch):
            return fm_model.serve_step(params, cfg, batch)

        inputs = (pshapes, {"ids": ShapeDtype((b, cfg.n_fields), I32)})
        in_sh = (serve_pshard, {"ids": _ns(mesh, all_axes, None)})
        return Workload(name, "serve", inputs, in_sh, _ns(mesh, all_axes),
                        2.0 * b * cfg.n_fields * cfg.embed_dim, forward=serve)

    # retrieval: one query against n_candidates split over the mesh, padded
    # to a multiple of 512 (the pipeline pads with sentinel rows)
    nc = (dims["n_candidates"] + 511) // 512 * 512

    def retrieval(params, user_ids, cand_rows):
        return fm_model.retrieval_scores(params, cfg, user_ids, cand_rows)

    inputs = (pshapes, ShapeDtype((1, cfg.n_fields), I32), ShapeDtype((nc,), I32))
    in_sh = (serve_pshard, _ns(mesh, None, None), _ns(mesh, all_axes))
    return Workload(name, "retrieval", inputs, in_sh, _ns(mesh, all_axes),
                    2.0 * nc * cfg.embed_dim, forward=retrieval)


# ---------------------------------------------------------------------------
# sameAs engine (the paper's workload)
# ---------------------------------------------------------------------------

ENGINE_FLAGS = ("rep_changed", "contradiction", "ov_rewrite", "ov_store", "ov_route",
                "ov_pair", "n_new", "n_pairs", "n_marked", "n_reflexive", "delta_rows",
                "delta_valid")
# the flags the reference's cell lays out replicated (the rest by rank, a
# rank's scalars as one row each: a global (ranks,) array)
_ENGINE_REPLICATED = ("rep_changed", "contradiction", "n_pairs")
_ENGINE_ROWS = {"ov_rewrite": torch.bool, "ov_store": torch.bool, "ov_route": torch.bool,
                "ov_pair": torch.bool, "n_new": I32, "n_marked": I32, "n_reflexive": I32}


def engine_rule():
    """The reference cell's representative 2-atom join rule,
    <x1', x2, x3> <- <x1, x2, x3> & <x1, sameAs, x1'>, its first delta plan
    and its head's variable slots."""
    from repro_torch.core.engine import build_plans
    from repro_torch.core.rules import Rule
    from repro_torch.core.terms import SAME_AS, var

    rule = Rule((var(4), var(2), var(3)), ((var(1), var(2), var(3)),
                                           (var(1), SAME_AS, var(4))))
    plan = tuple(build_plans(rule, full=False)[0])
    return rule, plan, tuple(t if t < 0 else None for t in rule.head)


def _engine_mesh(mesh) -> EngineMesh | None:
    """The flattened mesh as the engine's 1-D mesh (None at one rank)."""
    if mesh.size == 1:
        return None
    ag = mesh.axis(tuple(mesh.axis_names))
    return EngineMesh(group=ag.group, rank=ag.index, world=ag.size, backend=mesh.backend)


def build_engine_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    from repro_torch.core import collectives as coll
    from repro_torch.core.engine import eval_plan, process_candidates

    dims = shape.dims
    cap, n_res = dims["capacity"], dims["n_resources"]  # per-device arena rows
    axes = tuple(mesh.axis_names)  # the whole mesh, flattened, runs the engine
    n_dev = mesh.size
    cfg = spec.config
    _, plan, head_slots = engine_rule()

    def round_(spo, epoch, marked, tomb, n_used, rep, sort_perm, sorted_keys,
               atom_consts, head_consts, r):
        emesh = _engine_mesh(mesh)
        heads, valid, *_ = eval_plan(
            spo, epoch, marked, sorted_keys, sort_perm, r, atom_consts, head_consts,
            plan=plan, head_var_slots=head_slots, bind_cap=cfg.bind_cap,
            out_cap=cfg.out_cap, tomb=tomb, mesh=emesh)
        out = process_candidates(
            spo, epoch, marked, n_used, rep, sort_perm, sorted_keys, heads, valid, r,
            rewrite_cap=cfg.rewrite_cap, mesh=emesh, route_cap=cfg.route_cap)
        flags = out[-1]  # the reference's layout: the pairs counted over the mesh
        flags["n_pairs"] = flags["n_pairs"].to(I32)
        if emesh is not None:
            flags["n_pairs"] = coll.psum(flags["n_pairs"], emesh)
        for k, dtype in _ENGINE_ROWS.items():
            flags[k] = flags[k].to(dtype).reshape(1)
        if emesh is not None:  # the engine's collectives, booked on the named mesh
            label = "+".join(axes)
            for op, n in emesh.calls.items():
                mesh.calls[f"{label}:{op}"] += n
                mesh.bytes[f"{label}:{op}"] += emesh.bytes[op]
        return out

    rows = (cap + 1) * n_dev
    inputs = (ShapeDtype((rows, 3), I32), ShapeDtype((rows,), I32),
              ShapeDtype((rows,), torch.bool), ShapeDtype((rows,), I32),
              ShapeDtype((n_dev,), I32), ShapeDtype((n_res,), I32),
              ShapeDtype((rows,), I32), ShapeDtype((rows,), torch.int64),
              ShapeDtype((2, 3), I32), ShapeDtype((3,), I32), ShapeDtype((), I32))
    by_rank, whole = _ns(mesh, axes), _ns(mesh)
    in_sh = (_ns(mesh, axes, None), by_rank, by_rank, by_rank, by_rank, whole, by_rank,
             by_rank, whole, whole, whole)
    flags = {k: (whole if k in _ENGINE_REPLICATED else by_rank) for k in ENGINE_FLAGS}
    flags["delta_rows"] = _ns(mesh, axes, None)
    out_sh = (_ns(mesh, axes, None), by_rank, by_rank, by_rank, whole, by_rank, by_rank,
              flags)
    # one round over a full arena: joins ~ sort+search over cap rows a device
    flops = float(n_dev * cap * math.log2(max(cap, 2)) * 8)
    return Workload(f"{spec.name}:{shape.name}", "engine", inputs, in_sh, out_sh, flops,
                    forward=round_,
                    notes="one SPMD materialisation round (join plan + process); "
                          "spo and epoch are updated in place")


def engine_arena(triples: np.ndarray, n_res: int, cap: int, n_dev: int, r: int = 1,
                 epochs: np.ndarray | None = None) -> tuple:
    """The engine cell's global inputs (numpy) for ``triples`` (n, 3),
    ids below ``n_res``: each row in the block of shard ``s % n_dev`` (the
    owner the routed insert uses), live, at its entry of ``epochs`` (every
    row at ``r - 1``, the round's delta, unless given), each block ``cap``
    rows and a trash row with its own sorted index of packed keys (KEY_MAX
    behind, the permutation a stable sort's), rho the identity, the rule's
    constant rows, and round ``r``."""
    from repro_torch.core.engine import KEY_MAX
    from repro_torch.core.terms import SAME_AS
    from repro_torch.core.triples import pack

    triples = np.asarray(triples, dtype=np.int32)
    epochs = np.full(triples.shape[0], r - 1, np.int32) if epochs is None else epochs
    blk = cap + 1
    spo = np.zeros((n_dev * blk, 3), np.int32)
    epoch = np.full(n_dev * blk, -1, np.int32)
    n_used = np.zeros(n_dev, np.int32)
    perm = np.zeros(n_dev * blk, np.int32)
    keys = np.full(n_dev * blk, KEY_MAX, np.int64)
    for d in range(n_dev):
        own = triples[:, 0] % n_dev == d
        mine = triples[own]
        if mine.shape[0] > cap:
            raise ValueError(f"shard {d}: {mine.shape[0]} rows over its capacity {cap}")
        lo = d * blk
        spo[lo:lo + mine.shape[0]] = mine
        epoch[lo:lo + mine.shape[0]] = epochs[own]
        n_used[d] = mine.shape[0]
        k = np.full(blk, KEY_MAX, np.int64)
        k[:mine.shape[0]] = pack(mine)
        order = np.argsort(k, kind="stable")
        perm[lo:lo + blk] = order
        keys[lo:lo + blk] = k[order]
    rep = np.arange(n_res, dtype=np.int32)
    atom_consts = np.array([[0, 0, 0], [0, SAME_AS, 0]], np.int32)
    head_consts = np.zeros(3, np.int32)
    return (spo, epoch, np.zeros(n_dev * blk, bool), np.full(n_dev * blk, -1, np.int32),
            n_used, rep, perm, keys, atom_consts, head_consts, np.asarray(r, np.int32))


def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Workload:
    if spec.family == "lm":
        return build_lm_cell(spec, shape, mesh)
    if spec.family == "gnn":
        return build_gnn_cell(spec, shape, mesh)
    if spec.family == "recsys":
        return build_recsys_cell(spec, shape, mesh)
    if spec.family == "engine":
        return build_engine_cell(spec, shape, mesh)
    raise ValueError(spec.family)
