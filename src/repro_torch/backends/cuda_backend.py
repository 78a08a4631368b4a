"""CUDA-kernel backend: the counterpart of the reference's ``pallas``.

* ``extract`` — the pext kernel (``kernels/pext``);
* ``sort`` — the bitonic block-sort kernel (``kernels/bitonic``) over the
  bucket, then the keyed sort of the block runs, which restores the
  (key, row) order the unstable network does not guarantee (the
  reference merges the runs with one ``lax.sort`` outside any kernel; its
  counterpart here is the plain stable-sort series of
  ``core.dbits.sort_words_keyed``); keys of any width, the reference's
  128-word keys included;
* ``merge_sorted`` — the bucketed merge with the merge-rank kernel
  (``kernels/merge``) as the one rank pass of the smaller run in the
  larger, then the plain complement scatter, as the reference's pallas
  backend does; the same kernel is the ``rank_fn`` of the replica's
  insert rule (the neighbors of a batch's keys in the standing run);
* ``build`` — ``build_btree`` with the dbit kernel's positions form
  (``kernels/dbit``) as ``dpos_fn``, the leaf entries' D-bits, and the
  pk-window kernel's two forms (``kernels/build``): the leaf level's row
  gather with its windows as ``gather_slice_fn``, the upper levels'
  windows of gathered rows as ``slice_fn``;
* ``lookup`` — ``lookup_batch_planned`` with the probe kernel's
  leaf-stage form (``kernels/lookup``): the partial-key screen, the
  full-key confirm of the candidates and the rid in one launch, no leaf
  key gathered;
* ``lookup_many`` — ``lookup_many_planned`` with the same form over every
  tenant of the arena in one launch per call;
* ``batched_extract_sort`` (``run_many``) — the pext kernel once per
  member with that member's plan, then **one** bitonic launch over the
  stacked ``(k·n_pad, Wc)`` rows, where ``n_pad`` is the member's bucket
  rounded up to a multiple of the block (512), so no block straddles two
  members; then one keyed sort of the whole stack with the member as its
  leading key, that sort one program under ``("run_many", "cuda", k, b,
  Wc, block)`` as the reference's pallas backend keys it.  No fused
  path, as the reference's pallas backend has none;
* ``refresh_meta`` — the dbit kernel's bitmap form reduces the sorted
  run's adjacent D-bits to its Wc bitmap words on the card; the base
  class maps their set bits through D-offset on the host.  The
  pipeline's ``meta_from_keys`` runs the same form over the sorted full
  keys (``dbitmap_fn``).

Every op but ``extract`` is a plan-cache program under the reference's
key with ``"cuda"`` as the backend; the lookups replay CUDA graphs on the card.
On a CPU device every wrapper takes its plain version, so the backend is
testable without a card; on a CUDA device it launches the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core.compress import ExtractionPlan
from repro_torch.core.dbits import sort_words_keyed
from repro_torch.core.plancache import (
    ROW_PAD_B, SENTINEL, get_cache, iota, merge_padded, pad_tail, sort_padded)
from repro_torch.kernels import merge
from repro_torch.kernels.bitonic import DEFAULT_BLOCK, block_sort
from repro_torch.kernels.build import gather_windows, pk_windows
from repro_torch.kernels.dbit import adjacent_dbitmap, adjacent_dbits
from repro_torch.kernels.lookup import leaf_stage, leaf_stage_many
from repro_torch.kernels.pext import pext

from .base import ExecutionBackend, register_backend

__all__ = ["CudaBackend"]


@register_backend("cuda")
class CudaBackend(ExecutionBackend):
    """pext extraction + bitonic block sort + merge-rank merge + dbit and
    pk-window build + probe lookup + tenant-major probe lookup_many + dbit
    refresh."""

    supports_batched = True
    dbitmap_fn = staticmethod(adjacent_dbitmap)
    dpos_fn = staticmethod(adjacent_dbits)
    rank_fn = staticmethod(merge.merge_ranks)

    def extract(self, words, plan: ExtractionPlan):
        return pext(words, plan)

    def sort(self, keys, rows, *, n_valid=None, keep_padded=False):
        def impl(kp, rp):
            return sort_words_keyed(*block_sort(kp, rp))

        return sort_padded(keys, rows, backend=self.name, impl=impl,
                           extra_key=(DEFAULT_BLOCK,), n_valid=n_valid,
                           keep_padded=keep_padded)

    def batched_extract_sort(self, words, bitmaps, rows, plans):
        del bitmaps  # pext walks the members' plans
        k, b = int(words.shape[0]), int(words.shape[1])
        # each member fills whole blocks, so no block straddles two
        # members: the rows past b are all-ones keys with row ids above
        # every pad row of the pipeline, so they sort last in the member
        n_pad = -(-b // DEFAULT_BLOCK) * DEFAULT_BLOCK
        comp = torch.stack([pext(words[i], p) for i, p in enumerate(plans)])
        wc = int(comp.shape[2])
        cache = get_cache()

        def builder():
            def prog(comp, rows):
                extra = ROW_PAD_B + iota(n_pad, comp.device)[b:]
                comp = pad_tail(comp, n_pad, SENTINEL, dim=1).reshape(k * n_pad, wc)
                rws = torch.cat([rows, extra.expand(k, n_pad - b)], dim=1).reshape(k * n_pad)
                keys, rws = block_sort(comp, rws, block=DEFAULT_BLOCK)
                # rows repeat across members, so the member leads the key:
                # one series of stable sorts orders the whole stack, member
                # by member
                member = torch.arange(k, device=comp.device).repeat_interleave(n_pad)
                keyed, rws = sort_words_keyed(torch.cat([member[:, None], keys], dim=1), rws)
                keys = keyed[:, 1:].reshape(k, n_pad, wc)[:, :b].contiguous()
                return keys, rws.reshape(k, n_pad)[:, :b].contiguous()

            return cache.traced(prog)

        prog = cache.program(("run_many", self.name, k, b, wc, DEFAULT_BLOCK), builder)
        return prog(comp, rows)

    def merge_sorted(self, keys_a, rows_a, keys_b, rows_b, *,
                     n_valid_a=None, n_valid_b=None, keep_padded=False):
        return merge_padded(keys_a, rows_a, keys_b, rows_b, backend=self.name,
                            impl=merge.merge_sorted,
                            n_valid_a=n_valid_a, n_valid_b=n_valid_b,
                            keep_padded=keep_padded)

    def build(self, comp_sorted, row_sorted, meta, words, lengths, config,
              rids=None, n_valid=None):
        from repro_torch.core.btree import build_btree

        return build_btree(comp_sorted, row_sorted, meta, words, lengths, config,
                           rids=rids, dpos_fn=self.dpos_fn, slice_fn=pk_windows,
                           gather_slice_fn=gather_windows, n_valid=n_valid,
                           backend_name=self.name)

    def lookup(self, tree, queries):
        from repro_torch.core.btree import lookup_batch_planned

        return lookup_batch_planned(tree, queries, leaf_stage_fn=leaf_stage,
                                    backend_name=self.name)

    def lookup_many(self, stacked, queries, n_valid=None):
        from repro_torch.core.btree import lookup_many_planned

        return lookup_many_planned(stacked, queries, n_valid, leaf_stage_fn=leaf_stage_many,
                                   backend_name=self.name)
