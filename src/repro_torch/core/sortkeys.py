"""Compressed key sort (paper §3.2, §5.2) on one device, and its
sort-key statistics.

``compressed_key_sort`` extracts the distinction bits with a backend's
``extract`` (the pext kernel on ``"cuda"``) and sorts the compressed keys
with its ``sort`` (bitonic blocks, then the keyed run sort, on
``"cuda"``); ``full_key_sort`` sorts the full keys the same way.

The backends sort ``(key, row)`` pairs lexicographically, with distinct
rows.  Here the rows are the input positions ``0 .. n-1``, so equal keys
keep their input order: exactly the stable sort with ``rids`` as payload
that the reference runs, for any ``rids``, duplicates included.

The measurable effects of compression are the *sort key ratio* (fewer
sort-key words) and the *word comparison ratio* (distinction bits packed
into the leading word resolve a comparison sooner).  The pipeline's stats
report both; ``word_comparison_counts`` estimates the second.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .compress import ExtractionPlan
from .u32 import to_carrier

__all__ = ["SortResult", "full_key_sort", "compressed_key_sort", "word_comparison_counts"]


@dataclass
class SortResult:
    """Sorted sort-keys plus the permutation that produced them."""

    keys: torch.Tensor  # (n, W) sorted (full or compressed) keys, int64 carriers
    rids: torch.Tensor  # (n,) record ids, permuted
    perm: torch.Tensor  # (n,) original row index of each sorted row


def _backend(backend, device):
    from repro_torch.backends import ExecutionBackend, get_backend

    return backend if isinstance(backend, ExecutionBackend) else get_backend(backend, device)


def _sort(be, keys: torch.Tensor, rids) -> SortResult:
    rids = to_carrier(rids, be.device)
    rows = torch.arange(keys.shape[0], dtype=torch.int64, device=be.device)
    sk, perm = be.sort(keys, rows)
    return SortResult(keys=sk, rids=rids[perm], perm=perm)


def full_key_sort(words, rids, backend="cuda", device=None) -> SortResult:
    """Baseline: sort by the full (uncompressed) keys.  ``words`` are (n, W)
    u32 words (numpy or int64 carriers); ``backend`` is a name (made on
    ``device``, CUDA unless named) or an ``ExecutionBackend``."""
    be = _backend(backend, device)
    return _sort(be, to_carrier(words, be.device), rids)


def compressed_key_sort(words, rids, plan: ExtractionPlan, backend="cuda",
                        device=None) -> SortResult:
    """The paper's compressed key sort: extract distinction bits, then sort.

    Returns the *compressed* keys in sorted order; by Theorem 2 the induced
    permutation sorts the full keys as well.
    """
    be = _backend(backend, device)
    return _sort(be, be.extract(to_carrier(words, be.device), plan), rids)


def word_comparison_counts(sorted_words: torch.Tensor, sample_pairs: int = 4096,
                           seed: int = 0) -> float:
    """Estimate wcc — average word comparisons per key comparison (§6.3).

    A comparator examines words until the first difference; for a random
    pair that is (index of first differing word + 1).  Sampled over random
    pairs of the key set drawn from a numpy generator seeded by ``seed``
    (the reference draws with its own generator, so the two packages sample
    different pairs and agree only statistically).
    """
    n, w = sorted_words.shape
    idx = np.random.default_rng(seed).integers(0, n, size=(sample_pairs, 2))
    idx = torch.as_tensor(idx, device=sorted_words.device)
    diff = sorted_words[idx[:, 0]] != sorted_words[idx[:, 1]]
    first = torch.argmax(diff.to(torch.int8), dim=-1)
    words_examined = torch.where(diff.any(dim=-1), first + 1, torch.full_like(first, w))
    return float(words_examined.to(torch.float64).mean())
