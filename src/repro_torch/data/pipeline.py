"""Synthetic data pipelines for the three model families, seeded per step.

The port of ``repro.data.pipeline``: numpy, drawn exactly as the
reference draws, so that both packages make the same arrays from the same
seed.  Generation is deterministic per step index, so a restarted run
resumes with identical batches: the checkpoint stores only the step
counter, not the data state.  ``random_graph`` lives in
:mod:`repro_torch.data.graphs` and is re-exported here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.graphs import random_graph

__all__ = ["build_triplets", "lm_batch", "molecule_batch", "random_graph",
           "recsys_batch"]


def lm_batch(step: int, batch: int, seq: int, vocab: int) -> dict:
    rng = np.random.default_rng(1234 + step)
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def molecule_batch(
    rng: np.random.Generator,
    n_graphs: int,
    nodes_per: int,
    edges_per: int,
    n_species: int = 16,
) -> dict:
    """Batched small graphs, flattened with graph_ids (+ triplets for DimeNet)."""
    n = n_graphs * nodes_per
    e = n_graphs * edges_per
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per).astype(np.int32)
    src = rng.integers(0, nodes_per, e).astype(np.int32) + offs
    dst = rng.integers(0, nodes_per, e).astype(np.int32) + offs
    # avoid self loops (distance 0 breaks angular terms)
    dst = np.where(dst == src, (dst + 1 - offs) % nodes_per + offs, dst)
    batch = {
        "z": rng.integers(0, n_species, n).astype(np.int32),
        "x": rng.normal(size=(n, 16)).astype(np.float32),
        "pos": rng.normal(size=(n, 3)).astype(np.float32) * 2.0,
        "edge_index": np.stack([src, dst]),
        "edge_attr": rng.normal(size=(e, 1)).astype(np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32),
        "n_graphs": n_graphs,
        "y": rng.normal(size=(n_graphs,)).astype(np.float32),
    }
    batch["triplets"] = build_triplets(batch["edge_index"], max_triplets=4 * e)
    return batch


def build_triplets(edge_index: np.ndarray, max_triplets: int) -> np.ndarray:
    """(2, T) arrays (edge k->j, edge j->i) for DimeNet, capped + padded.

    For each directed edge e2=(j->i), pair with incoming edges e1=(k->j),
    k != i, in edge order, until ``max_triplets`` pairs are made.  Padding
    repeats the last triplet (the reference's ``mode="edge"``); with no
    triplet at all, one (0, 0) pair is padded.
    """
    src, dst = edge_index
    e = src.shape[0]
    by_dst: dict[int, list[int]] = {}
    for idx in range(e):
        by_dst.setdefault(int(dst[idx]), []).append(idx)
    t_in, t_out = [], []
    for e2 in range(e):
        j = int(src[e2])
        for e1 in by_dst.get(j, ()):
            if int(src[e1]) != int(dst[e2]):
                t_in.append(e1)
                t_out.append(e2)
                if len(t_in) >= max_triplets:
                    break
        if len(t_in) >= max_triplets:
            break
    if not t_in:
        t_in, t_out = [0], [0]
    arr = np.stack([np.asarray(t_in, np.int32), np.asarray(t_out, np.int32)])
    pad = max_triplets - arr.shape[1]
    if pad > 0:
        arr = np.pad(arr, ((0, 0), (0, pad)), mode="edge")
    return arr


def recsys_batch(step: int, batch: int, n_fields: int, rows_per_field: int) -> dict:
    rng = np.random.default_rng(987 + step)
    return {
        "ids": rng.integers(0, rows_per_field, (batch, n_fields)).astype(np.int32),
        "labels": rng.integers(0, 2, batch).astype(np.float32),
    }
