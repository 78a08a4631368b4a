"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336, vocab=65536,
MoE 16 experts top-2; Mamba:attention 7:1 interleave. [arXiv:2403.19887; hf]

Superblock of 8 layers: attention at index 4 (mid-block, as in the release),
MoE replaces the MLP every other layer (offset 1)."""

from .base import ArchConfig

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    n_experts=16,
    top_k=2,
    vocab_size=65536,
    pattern=_PATTERN,
    ssm_expand=2,
    ssm_state=16,
    ssm_conv=4,
    rope_theta=0.0,  # Jamba uses no positional encoding in attn layers
    source="arXiv:2403.19887",
)
