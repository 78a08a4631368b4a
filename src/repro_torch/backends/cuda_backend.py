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
* ``merge_sorted`` — the bucketed merge with the merge-rank kernel
  (``kernels/merge``) as the one rank pass of the smaller run in the
  larger, then the plain complement scatter, as the reference's pallas
  backend does;
* ``build`` — ``build_btree`` with the pk-window kernel (``kernels/build``)
  as its ``slice_fn``;
* ``lookup`` — ``lookup_batch_planned`` with the probe kernel
  (``kernels/lookup``) screening the leaf entries;
* ``lookup_many`` — ``lookup_many_planned`` with the tenant-major probe
  kernel (``kernels/lookup``) screening every tenant's leaf entries in
  one launch per call;
* ``refresh_meta`` — the dbit kernel (``kernels/dbit``) computes the
  adjacent D-bit positions on the card; the base class's host scatter
  turns them into the bitmap.

On a CPU device every wrapper takes its plain version, so the backend is
testable without a card; on a CUDA device it launches the kernels.
"""

from __future__ import annotations

from repro_torch.core.compress import ExtractionPlan
from repro_torch.core.dbits import sort_words_keyed
from repro_torch.core.plancache import merge_padded, sort_padded
from repro_torch.kernels import merge
from repro_torch.kernels.bitonic import block_sort
from repro_torch.kernels.build import pk_windows
from repro_torch.kernels.dbit import adjacent_dbits
from repro_torch.kernels.lookup import leaf_match_fn, leaf_match_many_fn
from repro_torch.kernels.pext import pext

from .base import ExecutionBackend, register_backend

__all__ = ["CudaBackend"]


@register_backend("cuda")
class CudaBackend(ExecutionBackend):
    """pext extraction + bitonic block sort + merge-rank merge + pk-window
    build + probe lookup + tenant-major probe lookup_many + dbit refresh."""

    dbit_fn = staticmethod(adjacent_dbits)

    def extract(self, words, plan: ExtractionPlan):
        return pext(words, plan)

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        def impl(kp, rp):
            return sort_words_keyed(*block_sort(kp, rp))

        return sort_padded(keys, rows, impl=impl, n_valid=n_valid,
                           keep_padded=keep_padded)

    def merge_sorted(self, keys_a, rows_a, keys_b, rows_b, *,
                     n_valid_a=None, n_valid_b=None, keep_padded=False):
        return merge_padded(keys_a, rows_a, keys_b, rows_b, impl=merge.merge_sorted,
                            n_valid_a=n_valid_a, n_valid_b=n_valid_b,
                            keep_padded=keep_padded)

    def build(self, comp_sorted, row_sorted, meta, words, lengths, config,
              rids=None, n_valid=None):
        from repro_torch.core.btree import build_btree

        return build_btree(comp_sorted, row_sorted, meta, words, lengths, config,
                           rids=rids, slice_fn=pk_windows, n_valid=n_valid)

    def lookup(self, tree, queries):
        from repro_torch.core.btree import lookup_batch_planned

        return lookup_batch_planned(tree, queries, leaf_match_fn=leaf_match_fn)

    def lookup_many(self, stacked, queries, n_valid=None):
        from repro_torch.core.btree import lookup_many_planned

        return lookup_many_planned(stacked, queries, n_valid,
                                   leaf_match_many_fn=leaf_match_many_fn)
