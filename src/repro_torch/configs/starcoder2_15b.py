"""starcoder2-15b [arXiv:2402.19173]: 40L d=6144 48H (GQA kv=4) d_ff=24576,
vocab=49152, RoPE."""

from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, ArchSpec

CONFIG = LMConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_head=128,
    d_ff=24_576,
    vocab=49_152,
    rope_theta=1e5,
)

REDUCED = LMConfig(
    name="starcoder2-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=256,
    vocab=256,
)

SPEC = ArchSpec(
    name="starcoder2-15b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=LM_SHAPES,
    source="arXiv:2402.19173; hf",
)
