"""The LM stack on PyTorch for serving: layers (norms, rope, blockwise
attention), the MoE layer with its compressed-key dispatch sort, the
Mamba and xLSTM mixers, and the ``LM`` over the ten configs."""

from . import layers, lm, moe, ssm, xlstm  # noqa: F401
