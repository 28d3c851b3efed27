"""egnn [arXiv:2102.09844]: n_layers=4 d_hidden=64, E(n)-equivariant."""

from repro_torch.models.gnn.egnn import EGNNConfig

from .base import GNN_SHAPES, ArchSpec

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)
REDUCED = EGNNConfig(name="egnn-reduced", n_layers=2, d_hidden=16)

SPEC = ArchSpec(
    name="egnn",
    family="gnn",
    config=CONFIG,
    reduced=REDUCED,
    shapes=GNN_SHAPES,
    source="arXiv:2102.09844; paper",
)
