"""The plain-PyTorch oracle backend: ``extract_bits`` + the keyed sort.

The counterpart of the reference's ``jnp`` backend and the semantics every
other backend is tested against.  Every op is plain tensor code, so it
runs on any device; build, lookup, refresh and the batched extract+sort
(the runtime-bitmap extract and the keyed sort, member by member) are the
base class's.  The fused path is ``plancache.fused_extract_sort_padded``.
"""

from __future__ import annotations

from repro_torch.core.compress import ExtractionPlan, extract_bits
from repro_torch.core.plancache import fused_extract_sort_padded, sort_padded

from .base import ExecutionBackend, register_backend

__all__ = ["TorchBackend"]


@register_backend("torch")
class TorchBackend(ExecutionBackend):
    """Plain tensor ops on ``device`` — the oracle path."""

    supports_fused = True
    supports_batched = True

    def extract(self, words, plan: ExtractionPlan):
        return extract_bits(words, plan)

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        return sort_padded(keys, rows, backend=self.name, n_valid=n_valid,
                           keep_padded=keep_padded)

    def fused_extract_sort(self, words, plan, rows, *, n_valid=None, keep_padded=False):
        return fused_extract_sort_padded(words, plan, rows, backend=self.name,
                                         n_valid=n_valid, keep_padded=keep_padded)
