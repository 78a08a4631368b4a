"""Scalar numpy oracle of the partial-key probe."""

from __future__ import annotations

import numpy as np


def probe_ref(
    queries: np.ndarray, starts: np.ndarray, entry_pk: np.ndarray, pk: int
) -> np.ndarray:
    """(m, W) pair queries + (m,) starts + (m,) stored partial keys -> (m,)
    bool candidate mask (clipped start, zero word past the key end, top
    ``pk`` bits kept)."""
    q = np.asarray(queries, np.uint32)
    m, n_words = q.shape
    out = np.zeros((m,), bool)
    for i in range(m):
        start = min(max(int(starts[i]), 0), n_words * 32 - 1)
        wi, sh = start // 32, start % 32
        w0 = int(q[i, wi])
        w1 = int(q[i, wi + 1]) if wi + 1 < n_words else 0
        window = ((w0 << sh) | (w1 >> (32 - sh) if sh else 0)) & 0xFFFFFFFF
        out[i] = np.uint32(window >> (32 - pk)) == np.uint32(entry_pk[i])
    return out
