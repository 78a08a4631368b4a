"""Sort-key statistics of the compressed key sort (paper §3.2, §6.3).

The measurable effects of compression are the *sort key ratio* (fewer
sort-key words) and the *word comparison ratio* (distinction bits packed
into the leading word resolve a comparison sooner).  The pipeline's stats
report both; this module estimates the second.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["word_comparison_counts"]


def word_comparison_counts(sorted_words: torch.Tensor, sample_pairs: int = 4096,
                           seed: int = 0) -> float:
    """Estimate wcc — average word comparisons per key comparison (§6.3).

    A comparator examines words until the first difference; for a random
    pair that is (index of first differing word + 1).  Sampled over random
    pairs of the key set drawn from a numpy generator seeded by ``seed``
    (the reference draws with ``jax.random``, so the two packages sample
    different pairs and agree only statistically).
    """
    n, w = sorted_words.shape
    idx = np.random.default_rng(seed).integers(0, n, size=(sample_pairs, 2))
    idx = torch.as_tensor(idx, device=sorted_words.device)
    diff = sorted_words[idx[:, 0]] != sorted_words[idx[:, 1]]
    first = torch.argmax(diff.to(torch.int8), dim=-1)
    words_examined = torch.where(diff.any(dim=-1), first + 1, torch.full_like(first, w))
    return float(words_examined.to(torch.float64).mean())
