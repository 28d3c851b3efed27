"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: 30L d=576 9H (GQA kv=3)
d_ff=1536, vocab=49152 (llama-arch small)."""

from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, ArchSpec

CONFIG = LMConfig(
    name="smollm-135m",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_head=64,
    d_ff=1536,
    vocab=49_152,
    rope_theta=1e4,
)

REDUCED = LMConfig(
    name="smollm-reduced",
    n_layers=3,
    d_model=48,
    n_heads=3,
    n_kv=3,
    d_head=16,
    d_ff=96,
    vocab=256,
)

SPEC = ArchSpec(
    name="smollm-135m",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=LM_SHAPES,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
