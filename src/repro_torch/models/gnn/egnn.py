"""EGNN — E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844).

    m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
    x_i' += C * sum_j (x_i - x_j) * phi_x(m_ij)
    h_i'  = phi_h(h_i, sum_j m_ij)

Equivariance comes from using only squared distances and relative vectors.
The port of ``repro.models.gnn.egnn``: the position update (rows of 3),
the message sum and the per-graph readout go through the ``segment_sum``
kernel, and so do the backward passes of the node gathers; the forward
builds one segment plan each of ``dst``, ``src`` and ``graph_ids``.

With a ``mesh`` the edges are this rank's block along the data axes
(:mod:`.common`'s edge parallelism): ``phi_e`` and ``phi_x`` act on edge
rows, ``embed``, ``phi_h`` and ``head`` on node rows; the per-graph
readout sums node rows, which every rank holds.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops

from .common import edge_shard, edge_side, gather, init_mlp, mlp, seg_sum


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_targets: int = 1


def init_params(gen: torch.Generator, cfg: EGNNConfig,
                device: str | torch.device = "cuda") -> dict:
    """Weights normal * fan_in^-0.5 from ``gen``, zero biases, f32 on
    ``device``; the reference's tree."""
    device = resolve(device, "init_params")
    h = cfg.d_hidden

    def m(dims):
        return init_mlp(gen, dims, device=device)

    return {
        "embed": m([cfg.d_in, h]),
        "layers": [{"phi_e": m([2 * h + 1, h, h]), "phi_x": m([h, h, 1]),
                    "phi_h": m([2 * h, h, h])} for _ in range(cfg.n_layers)],
        "head": m([h, h, cfg.n_targets]),
    }


def forward(params, cfg: EGNNConfig, batch: dict, mesh=None):
    """batch: x (N, d_in), pos (N, 3), edge_index (2, E) int32, graph_ids
    (N,) int32, n_graphs.  Returns (per-graph prediction (G, n_targets),
    final positions (N, 3)).  With ``mesh``, the edges are this rank's."""
    ax = edge_shard(mesh)
    h = mlp(params["embed"], batch["x"])
    pos = batch["pos"].float()
    src, dst = batch["edge_index"][0], batch["edge_index"][1]
    gid, n_graphs = batch["graph_ids"], int(batch["n_graphs"])
    n = h.shape[0]
    plan, src_plan = ops.segment_plan(dst, n), ops.segment_plan(src, n)
    gid_plan = ops.segment_plan(gid, n_graphs)
    for lp in params["layers"]:
        phi_e, phi_x = edge_side(lp["phi_e"], ax), edge_side(lp["phi_x"], ax)
        rel = gather(pos, dst, plan, ax) - gather(pos, src, src_plan, ax)
        d2 = (rel * rel).sum(-1, keepdim=True)
        m = mlp(phi_e, torch.cat([gather(h, dst, plan, ax), gather(h, src, src_plan, ax),
                                  d2.to(h.dtype)], -1))
        w = mlp(phi_x, m).float()
        pos = pos + seg_sum(rel * w, dst, n, plan, ax) / (n**0.5)
        agg = seg_sum(m, dst, n, plan, ax)
        h = h + mlp(lp["phi_h"], torch.cat([h, agg], -1))
    node_out = mlp(params["head"], h)
    return seg_sum(node_out, gid, n_graphs, gid_plan), pos


def loss_fn(params, cfg: EGNNConfig, batch: dict, mesh=None):
    """Mean squared error of the first target against ``batch["y"]``."""
    pred, _ = forward(params, cfg, batch, mesh)
    err = pred[:, 0].float() - batch["y"].float()
    return (err * err).mean()
