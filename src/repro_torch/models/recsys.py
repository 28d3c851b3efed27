"""Factorisation Machine (Rendle, ICDM'10) over one large embedding arena.

The port of ``repro.models.recsys`` for serving.  Lookups gather rows of
one table (per-field offsets into the arena); the pairwise interaction uses
the O(F*K) sum-square trick.  When ``use_pallas`` is set (the field keeps
the reference's name so that configs carry over; here it means the
hand-written CUDA kernels) the interaction goes through ``fm_interact`` and
the field bags (the first-order term and the retrieval query) through
``embedding_bag``.

owl:sameAs integration: an optional ``rho`` row remap unifies equivalent
IDs (merged user/item registrations) before lookup — one extra gather,
after which merged IDs share one embedding row.

Everything runs where the parameters lie.  ``loss_fn`` trains with
``use_pallas=False``, the reference's autodiff path (the FM and bag
kernels have no backward and raise on the card under grad).

Sharded training: ``param_shardings`` splits the table and the
first-order weights by rows over ``model`` (the reference's row-sharded
arena); ``forward``/``loss_fn`` with a ``mesh`` look each id up in this
rank's rows (zero where another rank holds it), sum the lookups over
``model``, and take the loss as a mean over every data rank's rows.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collectives as coll
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import NamedSharding, PartitionSpec as P, ShapeDtype
from repro_torch.models.transformer import params_from_numpy

__all__ = ["FMConfig", "forward", "init_params", "loss_fn", "param_shapes",
           "param_shardings", "params_from_numpy", "retrieval_scores", "serve_step"]


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 865_707  # ~33.8M total rows, Criteo-scale
    use_pallas: bool = False  # True: the fm_interact and embedding_bag kernels

    @property
    def n_rows(self) -> int:
        # padded to a multiple of 2048, as the reference pads its
        # row-sharded table
        raw = self.n_fields * self.rows_per_field
        return (raw + 2047) // 2048 * 2048

    def param_count(self) -> int:
        return self.n_rows * (self.embed_dim + 1) + 1


def init_params(gen: torch.Generator, cfg: FMConfig,
                device: str | torch.device = "cuda") -> dict:
    """Table rows normal * 0.01 drawn from ``gen`` (on its own device),
    zero first-order weights and bias, all f32 on ``device``."""
    device = resolve(device, "init_params")
    table = torch.randn((cfg.n_rows, cfg.embed_dim), generator=gen,
                        device=gen.device, dtype=torch.float32) * 0.01
    return {
        "table": table.to(device),
        "w1": torch.zeros((cfg.n_rows,), dtype=torch.float32, device=device),
        "bias": torch.zeros((), dtype=torch.float32, device=device),
    }


def param_shapes(cfg: FMConfig) -> dict:
    f32 = torch.float32
    return {"table": ShapeDtype((cfg.n_rows, cfg.embed_dim), f32),
            "w1": ShapeDtype((cfg.n_rows,), f32), "bias": ShapeDtype((), f32)}


def param_shardings(cfg: FMConfig, mesh, tp="model") -> dict:
    return {
        "table": NamedSharding(mesh, P(tp, None)),  # row-sharded arena
        "w1": NamedSharding(mesh, P(tp)),
        "bias": NamedSharding(mesh, P()),
    }


def _lookup(table: torch.Tensor, rows: torch.Tensor, mesh) -> torch.Tensor:
    """``table[rows]`` of the global table, this rank holding its row block
    along ``model``: a masked local lookup summed over ``model``."""
    if mesh is None or "model" not in mesh.axis_names or mesh.shape["model"] == 1:
        return table[rows]
    n = table.shape[0]
    local = rows - mesh.coords["model"] * n
    mine = (local >= 0) & (local < n)
    got = table[local.clamp(0, n - 1)]
    mine = mine.reshape(*mine.shape, *([1] * (got.dim() - mine.dim())))
    return coll.all_reduce(torch.where(mine, got, 0.0), mesh, "model")


def _row_ids(cfg: FMConfig, ids: torch.Tensor) -> torch.Tensor:
    offsets = torch.arange(cfg.n_fields, dtype=torch.int32, device=ids.device)
    return ids.to(torch.int32) + offsets[None, :] * cfg.rows_per_field


def forward(params, cfg: FMConfig, batch: dict, mesh=None) -> torch.Tensor:
    """batch: ids (B, F) int per-field categorical IDs; optional rho row
    remap (n_rows,) from the sameAs engine.  Returns logits (B,).  With
    ``mesh``, ``params`` are this rank's blocks of :func:`param_shardings`
    and ``batch`` its rows."""
    rows = _row_ids(cfg, batch["ids"]).to(torch.int64)
    rho = batch.get("rho")
    if rho is not None:
        rows = rho[rows].to(torch.int64)  # ID unification via the representative map
    if mesh is not None:
        if cfg.use_pallas:
            raise ValueError("sharded FM training runs with use_pallas=False")
        emb = _lookup(params["table"], rows, mesh)
        first = _lookup(params["w1"], rows, mesh).sum(dim=1)
        s = emb.sum(dim=1)
        second = 0.5 * ((s * s) - (emb * emb).sum(dim=1)).sum(dim=-1)
        return params["bias"] + first + second
    emb = params["table"][rows]  # (B, F, K)
    if cfg.use_pallas:
        second = ops.fm_interact(emb)
    else:
        s = emb.sum(dim=1)
        second = 0.5 * ((s * s) - (emb * emb).sum(dim=1)).sum(dim=-1)
    if cfg.use_pallas:  # the bag of first-order weights: a table of width 1
        first = ops.embedding_bag(rows.to(torch.int32), params["w1"][:, None])[:, 0]
    else:
        first = params["w1"][rows].sum(dim=1)
    return params["bias"] + first + second


def loss_fn(params, cfg: FMConfig, batch: dict, mesh=None) -> torch.Tensor:
    """Mean binary cross entropy of the logits against ``batch["labels"]``
    in the reference's stable form, f32 (with ``mesh``, the mean of every
    data rank's mean)."""
    logits = forward(params, cfg, batch, mesh).float()
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    dp = () if mesh is None else data_axes(mesh)
    if coll.is_trivial(mesh, dp):
        return loss
    return coll.all_reduce(loss * (1.0 / mesh.axis(dp).size), mesh, dp)


def serve_step(params, cfg: FMConfig, batch: dict) -> torch.Tensor:
    return torch.sigmoid(forward(params, cfg, batch))


def retrieval_scores(params, cfg: FMConfig, user_ids: torch.Tensor,
                     cand_rows: torch.Tensor) -> torch.Tensor:
    """Score one user's field-bag embedding against N candidate rows:
    batched dot, not a loop (the ``retrieval_cand`` shape)."""
    rows = _row_ids(cfg, user_ids)  # (1, F)
    if cfg.use_pallas:
        q = ops.embedding_bag(rows, params["table"])[0]  # (K,)
    else:
        q = params["table"][rows[0].to(torch.int64)].sum(dim=0)
    cand_rows = cand_rows.to(torch.int64)
    cand = params["table"][cand_rows]  # (N, K)
    return cand @ q + params["w1"][cand_rows]
