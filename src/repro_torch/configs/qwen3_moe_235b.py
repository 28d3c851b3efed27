"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B]: 94L d=4096 64H (GQA kv=4)
MoE 128 experts top-8, expert d_ff=1536, vocab=151936, head_dim=128."""

from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, ArchSpec

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_head=128,
    d_ff=0,
    vocab=151_936,
    n_experts=128,
    top_k=8,
    n_shared=0,
    d_expert=1536,
    rope_theta=1e6,
    # training-side fields of the reference's config, carried over as they
    # are (the port's serving path reads neither)
    fsdp=True,
    remat_group=1,
)

REDUCED = LMConfig(
    name="qwen3-moe-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=0,
    vocab=256,
    n_experts=8,
    top_k=2,
    n_shared=0,
    d_expert=32,
)

SPEC = ArchSpec(
    name="qwen3-moe-235b-a22b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-30B-A3B scaled per assignment; hf",
)
