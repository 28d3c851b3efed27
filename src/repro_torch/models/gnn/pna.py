"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718).

Multi-aggregator (mean / max / min / std) x multi-scaler (identity /
amplification / attenuation) message passing with tower MLPs.  The port of
``repro.models.gnn.pna``: the degree, the means and the standard deviation
(and the empty-segment counts of max and min) go through the
``segment_sum`` kernel, with one segment plan of ``dst`` for the whole
forward, and so does the backward of ``x[dst]`` and ``x[src]`` (a plan of
``src`` too).  The max and min are PyTorch's ``scatter_reduce``, backward
included.  ``loss_fn`` is the masked NLL.

With a ``mesh`` the edges are this rank's block along the data axes
(:mod:`.common`'s edge parallelism): the message MLPs (``pre``) act on
edge rows, ``embed``, ``post`` and ``head`` on node rows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import ops

from .common import (degrees, edge_shard, edge_side, gather, init_mlp, layer_norm,
                     masked_nll, mlp, seg_max, seg_mean, seg_min, seg_std)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 40
    delta: float = 2.5  # avg log-degree normaliser from the train graphs


def init_params(gen: torch.Generator, cfg: PNAConfig,
                device: str | torch.device = "cuda") -> dict:
    """Weights normal * fan_in^-0.5 from ``gen``, zero biases, f32 on
    ``device``."""
    device = resolve(device, "init_params")
    h = cfg.d_hidden
    return {
        "embed": init_mlp(gen, [cfg.d_in, h], device=device),
        "layers": [
            {
                "pre": init_mlp(gen, [2 * h, h], device=device),  # message MLP on (h_i, h_j)
                "post": init_mlp(gen, [12 * h + h, h], device=device),  # 4 agg x 3 scalers + self
            }
            for _ in range(cfg.n_layers)
        ],
        "head": init_mlp(gen, [h, h, cfg.n_classes], device=device),
    }


def forward(params, cfg: PNAConfig, batch: dict, mesh=None) -> torch.Tensor:
    """batch: x (N, d_in), edge_index (2, E) int32.  Returns logits
    (N, n_classes).  One segment plan of the destinations serves every
    segment sum of the forward and the backward of ``x[dst]``; one of the
    sources serves the backward of ``x[src]``.  With ``mesh``, the edges
    are this rank's."""
    ax = edge_shard(mesh)
    x = mlp(params["embed"], batch["x"])
    src, dst = batch["edge_index"][0], batch["edge_index"][1]
    n = x.shape[0]
    plan, src_plan = ops.segment_plan(dst, n), ops.segment_plan(src, n)
    deg = degrees(dst, n, plan, ax)
    log_deg = torch.log(deg + 1.0)
    amp = (log_deg / cfg.delta)[:, None]
    att = (cfg.delta / torch.clamp(log_deg, min=1e-6))[:, None]
    for lp in params["layers"]:
        m = mlp(edge_side(lp["pre"], ax),
                torch.cat([gather(x, dst, plan, ax), gather(x, src, src_plan, ax)], dim=-1))
        aggs = [
            seg_mean(m, dst, n, plan=plan, ax=ax),
            seg_max(m, dst, n, plan, ax),
            seg_min(m, dst, n, plan, ax),
            seg_std(m, dst, n, plan=plan, ax=ax),
        ]
        agg = torch.cat(aggs, dim=-1)
        scaled = torch.cat([agg, agg * amp, agg * att], dim=-1)
        x = x + F.silu(layer_norm(mlp(lp["post"], torch.cat([scaled, x], dim=-1))))
    return mlp(params["head"], x)


def loss_fn(params, cfg: PNAConfig, batch: dict, mesh=None):
    """Masked NLL of the node labels, as the reference's."""
    return masked_nll(forward(params, cfg, batch, mesh), batch)
