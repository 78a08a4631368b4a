"""Pure-numpy oracle for the merge-path ranks: scalar binary search."""

from __future__ import annotations

import numpy as np


def _pair_less(ka, ra, kb, rb) -> bool:
    ta, tb = tuple(int(x) for x in ka), tuple(int(x) for x in kb)
    return (ta, int(ra)) < (tb, int(rb))


def merge_ranks_ref(
    keys_q: np.ndarray, rows_q: np.ndarray, keys_s: np.ndarray, rows_s: np.ndarray
) -> np.ndarray:
    """Per-query rank in the sorted run, one scalar binary search each."""
    n_s = len(keys_s)
    out = np.zeros(len(keys_q), np.int32)
    for i in range(len(keys_q)):
        lo, hi = 0, n_s
        while lo < hi:
            mid = (lo + hi) // 2
            if _pair_less(keys_s[mid], rows_s[mid], keys_q[i], rows_q[i]):
                lo = mid + 1
            else:
                hi = mid
        out[i] = lo
    return out
