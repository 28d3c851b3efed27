"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; benchmark config from
arXiv:2003.00982): edge-gated message passing with residuals.

    e'_ij = A h_i + B h_j + C e_ij
    eta_ij = sigma(e'_ij) / (sum_j' sigma(e'_ij') + eps)
    h'_i  = U h_i + sum_j eta_ij * (V h_j)

The port of ``repro.models.gnn.gatedgcn``: both sums over the in-edges
of a node go through the ``segment_sum`` kernel, two launches a layer, and
so does the backward of the node gathers ``x[dst]`` and ``x[src]``; the
forward builds one segment plan of ``dst`` and one of ``src``.  LayerNorm
replaces BatchNorm, as in the reference.  ``loss_fn`` is the masked NLL.

With a ``mesh`` the edges (``edge_index``, ``edge_attr``) are this rank's
block along the data axes (:mod:`.common`'s edge parallelism): ``A``,
``B``, ``C``, ``V`` and ``embed_e`` act on edge rows, ``U``, ``embed_x``
and ``head`` on node rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import ops

from .common import (edge_shard, edge_side, gather, init_mlp, layer_norm, masked_nll, mlp,
                     seg_sum)


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 1
    n_classes: int = 40


def init_params(gen: torch.Generator, cfg: GatedGCNConfig,
                device: str | torch.device = "cuda") -> dict:
    """Weights normal * fan_in^-0.5 from ``gen``, zero biases, f32 on
    ``device``."""
    device = resolve(device, "init_params")
    h = cfg.d_hidden

    def lin(a, b):
        return init_mlp(gen, [a, b], device=device)[0]

    return {
        "embed_x": init_mlp(gen, [cfg.d_in, h], device=device),
        "embed_e": init_mlp(gen, [cfg.d_edge_in, h], device=device),
        "layers": [{name: lin(h, h) for name in "ABCUV"}
                   for _ in range(cfg.n_layers)],
        "head": init_mlp(gen, [h, h, cfg.n_classes], device=device),
    }


def forward(params, cfg: GatedGCNConfig, batch: dict, mesh=None) -> torch.Tensor:
    """batch: x (N, d_in), edge_attr (E, d_edge_in), edge_index (2, E)
    int32 (row 0 the sources, row 1 the destinations).  Returns logits
    (N, n_classes).  One segment plan of the destinations serves every
    segment sum of the forward and the backward of ``x[dst]``; one of the
    sources serves the backward of ``x[src]``.  With ``mesh``, the edges
    are this rank's."""
    ax = edge_shard(mesh)
    x = mlp(params["embed_x"], batch["x"])
    e = mlp(edge_side(params["embed_e"], ax), batch["edge_attr"])
    src, dst = batch["edge_index"][0], batch["edge_index"][1]
    n = x.shape[0]
    plan, src_plan = ops.segment_plan(dst, n), ops.segment_plan(src, n)
    for lp in params["layers"]:
        edge = edge_side({k: lp[k] for k in "ABCV"}, ax)
        (aw, ab), (bw, bb), (cw, cb) = edge["A"], edge["B"], edge["C"]
        (uw, ub), (vw, vb) = lp["U"], edge["V"]
        x_src = gather(x, src, src_plan, ax)
        e_new = gather(x, dst, plan, ax) @ aw + x_src @ bw + e @ cw + (ab + bb + cb)
        gate = torch.sigmoid(e_new.float()).to(x.dtype)
        msg = gate * (x_src @ vw + vb)
        den = seg_sum(gate, dst, n, plan, ax) + 1e-6
        agg = seg_sum(msg, dst, n, plan, ax) / den
        x = x + F.silu(layer_norm(x @ uw + ub + agg))
        e = e + F.silu(layer_norm(e_new))
    return mlp(params["head"], x)


def loss_fn(params, cfg: GatedGCNConfig, batch: dict, mesh=None):
    """Masked NLL of the node labels (``batch["labels"]``, int; optional
    ``batch["train_mask"]``, f32), as the reference's."""
    return masked_nll(forward(params, cfg, batch, mesh), batch)
