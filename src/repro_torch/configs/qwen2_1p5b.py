"""qwen2-1.5b [arXiv:2407.10671]: 28L d=1536 12H (GQA kv=2) d_ff=8960,
vocab=151936, QKV bias."""

from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, ArchSpec

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_head=128,
    d_ff=8960,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1e6,
)

REDUCED = LMConfig(
    name="qwen2-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
)

SPEC = ArchSpec(
    name="qwen2-1.5b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=LM_SHAPES,
    source="arXiv:2407.10671; hf",
)
