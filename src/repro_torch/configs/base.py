"""ArchSpec: a model configuration with its reduced twin and its shapes.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``),
limited to the families the port runs: the LM, the GNN, the recsys and
the engine shapes.

Each shape entry:
  kind   — 'train', 'prefill'/'decode'/'serve', 'retrieval', 'engine'
           (materialisation round),
  dims   — shape-specific sizes,
  skip   — reason string when the cell is skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    dims: dict
    skip: str | None = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # 'lm' | 'gnn' | 'recsys' | 'engine'
    config: Any
    reduced: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}")


LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec(
        "long_500k",
        "decode",
        dict(seq_len=524288, global_batch=1),
        skip="pure full-attention arch: long_500k designated for sub-quadratic "
        "attention per assignment (DESIGN.md §4)",
    ),
)

GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    ),
    ShapeSpec(
        "minibatch_lg", "train",
        dict(
            n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
            fanout=(15, 10),
            # sampled-subgraph caps: 1024 seeds, 15 then 10 neighbours
            sub_nodes=1024 * (1 + 15 + 150), sub_edges=1024 * 15 + 1024 * 15 * 10,
        ),
    ),
    ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ),
    ShapeSpec(
        "molecule", "train",
        dict(n_nodes=30, n_edges=64, batch=128),
    ),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65_536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262_144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)
