# Pluggable execution backends for the reconstruction pipeline.  See
# base.py for the interface, the determinism contract and the device rule.

from .base import (
    ExecutionBackend,
    available_backends,
    get_backend,
    register_backend,
)
from . import torch_backend  # noqa: F401  (self-registers "torch")
from . import cuda_backend  # noqa: F401  (self-registers "cuda")
from . import distributed  # noqa: F401  (self-registers "distributed")

__all__ = [
    "ExecutionBackend",
    "available_backends",
    "get_backend",
    "register_backend",
]
