"""deepseek-moe-16b [arXiv:2401.06066]: 28L d=2048 16H (MHA kv=16)
fine-grained MoE: 2 shared + 64 routed top-6, expert d_ff=1408."""

from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, ArchSpec

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=0,
    vocab=102_400,
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_expert=1408,
    rope_theta=1e4,
)

REDUCED = LMConfig(
    name="deepseek-moe-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=0,
    vocab=256,
    n_experts=8,
    top_k=3,
    n_shared=1,
    d_expert=32,
)

SPEC = ArchSpec(
    name="deepseek-moe-16b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=LM_SHAPES,
    source="arXiv:2401.06066; hf",
)
