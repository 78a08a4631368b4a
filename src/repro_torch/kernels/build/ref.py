"""Scalar numpy oracle of the pk-window gather."""

from __future__ import annotations

import numpy as np


def pk_windows_ref(words: np.ndarray, starts: np.ndarray, pk: int) -> np.ndarray:
    """(m, W) uint32 keys + (m,) start positions -> (m,) uint32 windows:
    the start clipped into the key, the word past the key end read as 0,
    the top ``pk`` bits of the 32-bit window kept."""
    w = np.asarray(words, np.uint32)
    m, n_words = w.shape
    out = np.zeros((m,), np.uint32)
    for i in range(m):
        start = min(max(int(starts[i]), 0), n_words * 32 - 1)
        wi, sh = start // 32, start % 32
        w0 = int(w[i, wi])
        w1 = int(w[i, wi + 1]) if wi + 1 < n_words else 0
        window = ((w0 << sh) | (w1 >> (32 - sh) if sh else 0)) & 0xFFFFFFFF
        out[i] = np.uint32(window >> (32 - pk))
    return out
