"""Scalar numpy oracles of the dbit kernel's two forms: one pair at a time."""

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


def adjacent_dbitmap_ref(sorted_words: np.ndarray) -> np.ndarray:
    """(n, W) uint32 sorted keys -> (W,) uint32 bitmap: bit ``31 - p % 32``
    of word ``p // 32`` set for every adjacent pair's D-bit ``p``."""
    w = np.asarray(sorted_words, np.uint32)
    out = np.zeros(w.shape[1], np.uint32)
    for p in adjacent_dbits_ref(w).tolist():
        if p != NO_DBIT:
            out[p // 32] |= np.uint32(1 << (31 - p % 32))
    return out
