"""Scalar numpy oracle of the dbit kernel: one pair at a time."""

from __future__ import annotations

import numpy as np

from repro_torch.core.dbits import NO_DBIT


def adjacent_dbits_ref(sorted_words: np.ndarray) -> np.ndarray:
    """(n, W) uint32 sorted keys -> (n-1,) int32 adjacent D-bit positions."""
    w = np.asarray(sorted_words, np.uint32)
    out = np.full(max(len(w) - 1, 0), NO_DBIT, np.int32)
    for i in range(len(out)):
        for j, x in enumerate(w[i] ^ w[i + 1]):
            if x:
                out[i] = 32 * j + 32 - int(x).bit_length()
                break
    return out
