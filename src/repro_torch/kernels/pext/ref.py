"""Scalar numpy oracle of the pext kernel: one bit at a time per key."""

from __future__ import annotations

import numpy as np

from repro_torch.core.compress import ExtractionPlan


def pext_ref(words: np.ndarray, plan: ExtractionPlan) -> np.ndarray:
    """(n, W) uint32 keys -> (n, Wc) uint32 compressed keys."""
    w = np.asarray(words, np.uint32)
    out = np.zeros((w.shape[0], plan.n_words_out), np.uint32)
    for b in range(plan.n_bits):
        dw, ds = plan.dst(b)
        bit = (w[:, plan.src_word[b]] >> np.uint32(plan.src_shift[b])) & np.uint32(1)
        out[:, dw] |= bit << np.uint32(ds)
    return out
