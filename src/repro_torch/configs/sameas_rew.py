"""sameas_rew — the paper's own workload as an engine configuration.

A copy of ``repro.configs.sameas_rew``.  :meth:`repro_torch.TorchEngine.from_config`
builds an engine from ``CONFIG`` or ``REDUCED``; dims are per-device
capacities (the reference's arena is sharded over a mesh, the port runs on
one device, where ``route_cap`` has no effect).
"""

import dataclasses

from .base import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    name: str = "sameas_rew"
    n_resources: int = 1 << 20
    capacity: int = 1 << 18        # per-device arena rows
    bind_cap: int = 1 << 14
    out_cap: int = 1 << 14
    rewrite_cap: int = 1 << 14
    # owner-routing bucket rows per destination shard (None = all-gather)
    route_cap: int | None = 1 << 12
    # replicated query rows per tombstone-seed / membership probe batch
    # (the incremental update path; TorchEngine.from_config plumbs it through)
    seed_chunk: int = 2048
    # out rows per delta/tomb plan during incremental updates (None = derive
    # from out_cap); full-evaluation plans always use out_cap
    delta_out_cap: int | None = None


CONFIG = EngineConfig()
REDUCED = EngineConfig(
    name="sameas_rew-reduced",
    n_resources=1 << 10,
    capacity=256,
    bind_cap=256,
    out_cap=256,
    rewrite_cap=256,
    route_cap=64,
    seed_chunk=64,
)

SHAPES = (
    # global arena = capacity x 256 (single pod) / x 512 (multi-pod)
    ShapeSpec("round_67m", "engine", dict(capacity=1 << 18, n_resources=1 << 20)),
    ShapeSpec("round_268m", "engine", dict(capacity=1 << 20, n_resources=1 << 21)),
)

SPEC = ArchSpec(
    name="sameas_rew",
    family="engine",
    config=CONFIG,
    reduced=REDUCED,
    shapes=SHAPES,
    source="this paper",
)
