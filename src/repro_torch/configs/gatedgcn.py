"""gatedgcn [arXiv:2003.00982]: n_layers=16 d_hidden=70, gated aggregation."""

from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

from .base import GNN_SHAPES, ArchSpec

CONFIG = GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70)
REDUCED = GatedGCNConfig(
    name="gatedgcn-reduced", n_layers=3, d_hidden=16, d_in=32, n_classes=5
)

SPEC = ArchSpec(
    name="gatedgcn",
    family="gnn",
    config=CONFIG,
    reduced=REDUCED,
    shapes=GNN_SHAPES,
    source="arXiv:2003.00982; paper",
)
