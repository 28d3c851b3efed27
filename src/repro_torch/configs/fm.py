"""fm [Rendle ICDM'10]: 39 sparse fields, embed_dim=10, 2-way interactions
via the O(nk) sum-square trick; Criteo-scale tables."""

from repro_torch.models.recsys import FMConfig

from .base import RECSYS_SHAPES, ArchSpec

CONFIG = FMConfig(name="fm", n_fields=39, embed_dim=10, rows_per_field=865_707)
REDUCED = FMConfig(name="fm-reduced", n_fields=8, embed_dim=4, rows_per_field=100)

SPEC = ArchSpec(
    name="fm",
    family="recsys",
    config=CONFIG,
    reduced=REDUCED,
    shapes=RECSYS_SHAPES,
    source="ICDM'10 (Rendle); paper",
)
