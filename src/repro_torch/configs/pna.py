"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75,
aggregators mean-max-min-std, scalers id-amp-atten."""

from repro_torch.models.gnn.pna import PNAConfig

from .base import GNN_SHAPES, ArchSpec

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)
REDUCED = PNAConfig(name="pna-reduced", n_layers=2, d_hidden=15, d_in=32, n_classes=5)

SPEC = ArchSpec(
    name="pna",
    family="gnn",
    config=CONFIG,
    reduced=REDUCED,
    shapes=GNN_SHAPES,
    source="arXiv:2004.05718; paper",
)
