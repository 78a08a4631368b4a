"""The plain-PyTorch oracle backend: ``extract_bits`` + the keyed sort.

The counterpart of the reference's ``jnp`` backend and the semantics every
other backend is tested against.  Every op is plain tensor code, so it
runs on any device; build, lookup and refresh are the base class's.
"""

from __future__ import annotations

from repro_torch.core.compress import ExtractionPlan, extract_bits
from repro_torch.core.plancache import sort_padded

from .base import ExecutionBackend, register_backend

__all__ = ["TorchBackend"]


@register_backend("torch")
class TorchBackend(ExecutionBackend):
    """Plain tensor ops on ``device`` — the oracle path."""

    def extract(self, words, plan: ExtractionPlan):
        return extract_bits(words, plan)

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        return sort_padded(keys, rows, n_valid=n_valid, keep_padded=keep_padded)
