"""Graphs for the GNNs: random ones, the edge graph of a KG, and its
sameAs-deduplicated form.

``random_graph`` is a copy of ``repro.data.pipeline.random_graph`` and
``build_graph_from_kg`` of the one in ``examples/kg_dedup_gnn.py`` (the
port imports nothing of ``repro``); both are numpy.  ``dedup_graph`` is
that example's deduplication step on the card: the KG's representative map
rho rewrites every edge endpoint (the ``rewrite_triples`` kernel), and
duplicate edges go (the ``dedup_order`` kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.terms import SAME_AS
from repro_torch.device import resolve
from repro_torch.kernels import ops


def random_graph(
    rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int, n_classes: int
) -> dict:
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return {
        "x": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "edge_index": np.stack([src, dst]),
        "edge_attr": rng.normal(size=(n_edges, 1)).astype(np.float32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
        "train_mask": (rng.random(n_nodes) < 0.5).astype(np.float32),
    }


def build_graph_from_kg(triples, n_nodes, d_feat, rng):
    """Edge list = non-sameAs payload triples; random features per node."""
    payload = triples[triples[:, 1] != SAME_AS]
    src, dst = payload[:, 0], payload[:, 2]
    x = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = (np.arange(n_nodes) % 4).astype(np.int32)
    return {
        "x": x,
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": np.ones((src.shape[0], 1), np.float32),
        "labels": labels,
        "train_mask": np.ones(n_nodes, np.float32),
    }


def graph_to(graph: dict, device: str | torch.device) -> dict:
    """A graph of numpy arrays (or tensors) as tensors on ``device``;
    Python ints (a batch's ``n_graphs``) stay ints."""
    device = resolve(device, "graph_to")
    return {k: v if isinstance(v, int) else torch.as_tensor(v).to(device)
            for k, v in graph.items()}


def dedup_graph(graph: dict, rho, device: str | torch.device = "cuda") -> dict:
    """``graph`` with every edge endpoint rewritten to its representative
    under ``rho`` (int32, one entry per node) and duplicate edges dropped:
    the unique (src, dst) pairs in ascending order, as ``np.unique(...,
    axis=0)`` gives them, with unit edge features.  Nodes keep their rows
    (a merged node stays, without edges).  Tensors on ``device``."""
    device = resolve(device, "dedup_graph")
    out = graph_to(graph, device)
    rho = torch.as_tensor(rho).to(device=device, dtype=torch.int32)
    src, dst = out["edge_index"].to(torch.int32)
    spo = torch.stack([src, torch.zeros_like(src), dst], dim=1)
    rewritten, _ = ops.rewrite_triples(spo, rho)
    keys = (rewritten[:, 0].to(torch.int64) << 32) | rewritten[:, 2].to(torch.int64)
    keys = keys[ops.dedup_order(keys).to(torch.int64)]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    keys = keys[first]
    out["edge_index"] = torch.stack([keys >> 32, keys & 0xFFFFFFFF]).to(torch.int32)
    out["edge_attr"] = torch.ones((keys.shape[0], 1), dtype=torch.float32, device=device)
    return out
