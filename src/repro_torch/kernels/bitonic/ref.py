"""numpy oracle of the bitonic block sort: a stable sort per block.

A bitonic network is not stable, so rows with equal keys may come out in
another order than here; the keys of each block and the (key, row) pairs
as a set must agree.
"""

from __future__ import annotations

import numpy as np


def block_sort_ref(words: np.ndarray, rows: np.ndarray, block: int):
    """(n, W) uint32 keys + (n,) rows -> each ``block`` rows sorted."""
    w = np.asarray(words, np.uint32)
    r = np.asarray(rows, np.uint32)
    out_w, out_r = w.copy(), r.copy()
    for s in range(0, w.shape[0], block):
        blk = w[s : s + block]
        order = np.lexsort(blk.T[::-1])
        out_w[s : s + block] = blk[order]
        out_r[s : s + block] = r[s : s + block][order]
    return out_w, out_r
