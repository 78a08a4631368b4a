"""musicgen-large — 48L d_model=2048 32H (kv=32, full MHA) d_ff=8192,
vocab=2048 (EnCodec codebook).  Decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, T, d_model); the backbone predicts codebook tokens."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=((("attn", "dense")),),
    embed_input=False,  # frame embeddings arrive precomputed
    rope_theta=10000.0,
    source="arXiv:2306.05284",
)
