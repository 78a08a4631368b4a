"""Deterministic sharded data pipeline on the compressed key sort.

Epoch shuffling and dedup both run through the compressed key sort of a
backend (``"cuda"`` by default: the dbit kernel's bitmap form for the
D-bitmap, then pext and the bitonic sort):

  * shuffle: sort documents by ``(fnv1a(seed || doc_id) || doc_id)`` — a
    keyed permutation that any worker can reproduce locally, so a restarted
    or straggling worker re-derives exactly its shard without coordination
    (straggler/restart safety comes from determinism, not state);
  * dedup: equal compressed keys => equal keys when the D-bitmap covers the
    dataset (Theorem 2 corollary) — adjacent-equality scan post-sort.

Batches are yielded as (step, batch) with a monotone step id; resuming from
checkpoint step N skips exactly N batches by arithmetic, not by replay.
Every function runs on ``device`` (CUDA unless named) and returns tensors
there: int64 document ids, int32 tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.backends import get_backend
from repro_torch.core.compress import make_plan
from repro_torch.core.dbits import compute_dbitmap
from repro_torch.core.sortkeys import compressed_key_sort
from repro_torch.core.u32 import MASK32, resolve_device, to_u32

__all__ = ["shuffle_order", "dedup_tokens", "TokenPipeline"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x01000193


def _fnv1a_vec(x: torch.Tensor, seed: int) -> torch.Tensor:
    """FNV-1a over the four little-endian bytes of each u32 of ``x``, from
    the 64-bit offset basis xor ``seed`` kept to 32 bits: int64 carriers
    in 0 .. 2^32-1 (each product stays below 2^57, so int64 holds it)."""
    h = torch.full(x.shape, (_FNV_OFFSET ^ seed) & MASK32, dtype=torch.int64, device=x.device)
    v = x.to(torch.int64)
    for shift in (0, 8, 16, 24):
        h = ((h ^ ((v >> shift) & 0xFF)) * _FNV_PRIME) & MASK32
    return h


def _sort_keys(words: torch.Tensor, rids: torch.Tensor, backend):
    """D-bitmap of ``words`` with the backend's bitmap pass, its plan, and
    the compressed key sort."""
    bm = compute_dbitmap(words, dbitmap_fn=backend.dbitmap_fn)
    plan = make_plan(to_u32(bm), int(words.shape[1]))
    return compressed_key_sort(words, rids, plan, backend=backend)


def shuffle_order(n_docs: int, seed: int, backend: str = "cuda", device=None) -> torch.Tensor:
    """Keyed shuffle permutation via compressed key sort: (n_docs,) int64."""
    be = get_backend(backend, resolve_device(device))
    doc = torch.arange(n_docs, dtype=torch.int64, device=be.device)
    words = torch.stack([_fnv1a_vec(doc, seed), doc], dim=1)  # (n, 2) u32 carriers
    return _sort_keys(words, doc, be).rids


def dedup_tokens(docs, backend: str = "cuda", device=None) -> torch.Tensor:
    """Drop exact-duplicate rows of (n, L) int32 token docs via sorted
    compressed keys (adjacent-equal scan): the ascending (n_kept,) int64
    indices of each distinct row's first occurrence."""
    be = get_backend(backend, resolve_device(device))
    words = torch.as_tensor(docs).to(be.device, torch.int64) & MASK32  # u32 view of the tokens
    n = int(words.shape[0])
    res = _sort_keys(words, torch.arange(n, dtype=torch.int64, device=be.device), be)
    keep = torch.ones(n, dtype=torch.bool, device=be.device)
    keep[1:] = (res.keys[1:] != res.keys[:-1]).any(dim=1)
    return torch.sort(res.rids[keep]).values


@dataclass
class TokenPipeline:
    """Sharded, resumable LM batch source over a document array."""

    docs: object  # (n_docs, doc_len) int32, numpy or a tensor
    global_batch: int
    seq_len: int
    seed: int = 0
    backend: str = "cuda"
    device: object = None
    _order_cache: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.docs = torch.as_tensor(self.docs, device=self.device)
        assert self.docs.shape[1] >= self.seq_len + 1
        self.n_docs = int(self.docs.shape[0])
        self.per_epoch = self.n_docs // self.global_batch

    def _epoch_order(self, epoch: int) -> torch.Tensor:
        if epoch not in self._order_cache:
            self._order_cache[epoch] = shuffle_order(self.n_docs, self.seed + epoch,
                                                     self.backend, self.device)
        return self._order_cache[epoch]

    def batch_at(self, step: int) -> dict:
        """Deterministic random access — the resume/straggler-safety hook."""
        epoch, off = divmod(step, self.per_epoch)
        order = self._epoch_order(epoch)
        rows = order[off * self.global_batch : (off + 1) * self.global_batch]
        toks = self.docs[rows]
        return {
            "tokens": toks[:, : self.seq_len].to(torch.int32),
            "labels": toks[:, 1 : self.seq_len + 1].to(torch.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield step, self.batch_at(step)
            step += 1
