"""CUDA-kernel backend: the counterpart of the reference's ``pallas``.

* ``extract`` — the pext kernel (``kernels/pext``);
* ``sort`` — the bitonic block-sort kernel (``kernels/bitonic``) over the
  bucket, then the keyed sort of the block runs, which restores the
  (key, row) order the unstable network does not guarantee (the
  reference merges the runs with one ``lax.sort`` outside any kernel; its
  counterpart here is the plain stable-sort series of
  ``core.dbits.sort_words_keyed``); a block of keys wider than 23 words
  does not fit the kernel's shared memory, so such a sort raises on the
  card;
* ``build`` — ``build_btree`` with the pk-window kernel (``kernels/build``)
  as its ``slice_fn``;
* ``lookup`` — ``lookup_batch_planned`` with the probe kernel
  (``kernels/lookup``) screening the leaf entries;
* ``refresh_meta`` — the base class's plain adjacent-dpos pass, as in the
  reference (its dbit kernel waits for a later slice, ROADMAP Queue 1
  item 6).

On a CPU device every wrapper takes its plain version, so the backend is
testable without a card; on a CUDA device it launches the kernels.
"""

from __future__ import annotations

from repro_torch.core.compress import ExtractionPlan
from repro_torch.core.dbits import sort_words_keyed
from repro_torch.core.plancache import sort_padded
from repro_torch.kernels.bitonic import block_sort
from repro_torch.kernels.build import pk_windows
from repro_torch.kernels.lookup import leaf_match_fn
from repro_torch.kernels.pext import pext

from .base import ExecutionBackend, register_backend

__all__ = ["CudaBackend"]


@register_backend("cuda")
class CudaBackend(ExecutionBackend):
    """pext extraction + bitonic block sort + pk-window build + probe lookup."""

    def extract(self, words, plan: ExtractionPlan):
        return pext(words, plan)

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        def impl(kp, rp):
            return sort_words_keyed(*block_sort(kp, rp))

        return sort_padded(keys, rows, impl=impl, n_valid=n_valid,
                           keep_padded=keep_padded)

    def build(self, comp_sorted, row_sorted, meta, words, lengths, config,
              rids=None, n_valid=None):
        from repro_torch.core.btree import build_btree

        return build_btree(comp_sorted, row_sorted, meta, words, lengths, config,
                           rids=rids, slice_fn=pk_windows, n_valid=n_valid)

    def lookup(self, tree, queries):
        from repro_torch.core.btree import lookup_batch_planned

        return lookup_batch_planned(tree, queries, leaf_match_fn=leaf_match_fn)
