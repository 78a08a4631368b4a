"""llama-3.2-vision-90b — 100L d_model=8192 64H (GQA kv=8) d_ff=28672,
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision family; unverified]

The vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, n_img_tokens, d_model); cross-attn layers are gated
(tanh-gate, zero-init) as in the release."""

from .base import ArchConfig

_PATTERN = tuple(
    ("xattn" if i == 4 else "attn", "dense") for i in range(5)
)

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    pattern=_PATTERN,
    n_img_tokens=1024,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-90B-Vision",
)
