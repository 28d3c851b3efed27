"""ArchSpec: a model configuration with its reduced twin and its shapes.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``),
limited to the families the port serves: the LM and the recsys shapes.

Each shape entry:
  kind   — 'train', 'prefill'/'decode'/'serve', 'retrieval',
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
    family: str  # 'lm' | 'recsys'
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

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65_536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262_144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)
