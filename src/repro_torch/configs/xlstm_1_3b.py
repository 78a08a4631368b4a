"""xlstm-1.3b — 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM + mLSTM blocks
at 7:1 (the paper's xLSTM[7:1] 1.3B configuration).  [arXiv:2405.04517;
unverified]

No separate FFN (d_ff=0): mLSTM blocks carry a 2x up-projection internally,
sLSTM blocks operate at model width."""

from .base import ArchConfig

_PATTERN = tuple(("mlstm" if i != 7 else "slstm", "none") for i in range(8))

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=_PATTERN,
    xlstm_heads=4,
    xlstm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
