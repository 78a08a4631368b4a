"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536,
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]

head_dim=128 (HF config value; q/k-norm enabled as in Qwen3)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,  # no dense FFN: every layer is MoE
    moe_d_ff=1536,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    pattern=((("attn", "moe")),),
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-235B-A22B",
)
