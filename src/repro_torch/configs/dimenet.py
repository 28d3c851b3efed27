"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6 — triplet-gather kernel regime."""

from repro_torch.models.gnn.dimenet import DimeNetConfig

from .base import GNN_SHAPES, ArchSpec

CONFIG = DimeNetConfig(
    name="dimenet",
    n_blocks=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
)

REDUCED = DimeNetConfig(
    name="dimenet-reduced",
    n_blocks=2,
    d_hidden=16,
    n_bilinear=4,
    n_spherical=3,
    n_radial=4,
)

SPEC = ArchSpec(
    name="dimenet",
    family="gnn",
    config=CONFIG,
    reduced=REDUCED,
    shapes=GNN_SHAPES,
    source="arXiv:2003.03123; unverified",
)
