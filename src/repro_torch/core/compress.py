"""Compressed-key extraction (paper §5.1).

The D-bitmap is metadata fixed at reconstruction time (it is persisted in
the DS-metadata, §4.2), so it is turned host-side into an **extraction
plan**: for each output bit ``b`` of the compressed key, the source word
and source shift in the full key.  ``extract_bits`` applies the plan with
plain tensor ops — the oracle of the pext kernel in
``repro_torch.kernels.pext``, which walks the same plan per key.

Compressed keys are ``(n, Wc)`` int64-carrier words, word 0 most
significant, bit order preserved (ascending source position -> ascending
output position), which is what Theorem 2 needs for order equivalence.
The slack bits of the last compressed word are zero for every key.

``extract_bits_dynamic`` takes the bitmap as a tensor instead of a plan
(the reference's runtime-bitmap form, for bitmaps updated online): each
source bit's output slot is the running popcount of the bitmap, found on
the device, so no plan is made on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dbits import dbit_positions_nonempty

__all__ = ["ExtractionPlan", "make_plan", "plan_bitmap", "extract_bits", "extract_bits_dynamic"]


@dataclass(frozen=True)
class ExtractionPlan:
    """Static schedule mapping full-key bit positions to compressed-key bits.

    positions:   (B_c,) ascending source bit positions.
    src_word:    (B_c,) source word index   = positions // 32
    src_shift:   (B_c,) right-shift amount  = 31 - positions % 32
    n_words_in:  full key width in words.
    n_words_out: compressed key width in words = ceil(B_c / 32).
    """

    positions: tuple[int, ...]
    src_word: tuple[int, ...]
    src_shift: tuple[int, ...]
    n_words_in: int
    n_words_out: int

    @property
    def n_bits(self) -> int:
        return len(self.positions)

    def dst(self, b: int) -> tuple[int, int]:
        """(dst_word, dst_shift) of output bit b (b=0 is global MSB)."""
        return b // 32, 31 - (b % 32)

    def as_arrays(self) -> dict[str, np.ndarray]:
        """Plan as dense arrays (the form the pext kernel takes)."""
        b = np.arange(self.n_bits, dtype=np.int32)
        return {
            "src_word": np.asarray(self.src_word, np.int32),
            "src_shift": np.asarray(self.src_shift, np.int32),
            "dst_word": b // 32,
            "dst_shift": 31 - (b % 32),
        }


def make_plan(bitmap: np.ndarray, n_words_in: int | None = None) -> ExtractionPlan:
    """Build the extraction plan from a D-bitmap (host-side)."""
    bm = np.asarray(bitmap, dtype=np.uint32)
    if n_words_in is None:
        n_words_in = bm.shape[0]
    pos = dbit_positions_nonempty(bm)
    return ExtractionPlan(
        positions=tuple(int(p) for p in pos),
        src_word=tuple(int(p) // 32 for p in pos),
        src_shift=tuple(31 - int(p) % 32 for p in pos),
        n_words_in=int(n_words_in),
        n_words_out=(len(pos) + 31) // 32,
    )


def plan_bitmap(plan: ExtractionPlan) -> np.ndarray:
    """The (n_words_in,) ``uint32`` D-bitmap a plan was made from (the
    inverse of :func:`make_plan`)."""
    pos = np.asarray(plan.positions, np.int64)
    bm = np.zeros(plan.n_words_in, np.uint32)
    np.bitwise_or.at(bm, pos // 32, (np.uint32(1) << (31 - pos % 32).astype(np.uint32)))
    return bm


def extract_bits(words: torch.Tensor, plan: ExtractionPlan) -> torch.Tensor:
    """(n, W) full keys -> (n, Wc) compressed keys, one shift+mask+shift+or
    per planned bit over all keys at once (no mask needed: a 0/1 bit
    shifted by at most 31 stays inside 32 bits)."""
    n = words.shape[0]
    out = torch.zeros((n, plan.n_words_out), dtype=torch.int64, device=words.device)
    for b in range(plan.n_bits):
        dw, ds = plan.dst(b)
        bit = (words[:, plan.src_word[b]] >> plan.src_shift[b]) & 1
        out[:, dw] |= bit << ds
    return out


def extract_bits_dynamic(
    words: torch.Tensor, bitmap, n_words_out: int
) -> torch.Tensor:
    """(n, W) full keys -> (n, n_words_out) compressed keys under a (W,)
    D-bitmap given as data (int64 carrier tensor or numpy ``uint32``).

    The reference ranks the selected bit columns with a cumulative
    popcount of the bitmap and scatters the key's bit matrix into its
    slots; here the same ranks give each source bit its output word and
    shift, and the bits are added into place one source word at a time,
    so only an (n, 32) slab is live.  Bits ranked past
    ``32 * n_words_out`` are dropped, as the reference's scatter drops
    them; an empty bitmap gives all-zero keys.
    """
    n, w = words.shape
    dev = words.device
    bm = bitmap.to(device=dev, dtype=torch.int64) if isinstance(bitmap, torch.Tensor) \
        else torch.as_tensor(np.asarray(bitmap, np.uint32).astype(np.int64), device=dev)
    shifts = torch.arange(31, -1, -1, device=dev)
    sel = ((bm[:, None] >> shifts) & 1).reshape(w * 32)
    slot = torch.cumsum(sel, 0) - 1
    b_out = int(n_words_out) * 32
    # unselected and overflowing bits park in one extra word, dropped below
    slot = torch.where((sel == 1) & (slot < b_out), slot, torch.full_like(slot, b_out))
    dst_word = slot // 32
    dst_shift = 31 - slot % 32
    out = torch.zeros((n, int(n_words_out) + 1), dtype=torch.int64, device=dev)
    for src in range(w):
        cols = slice(32 * src, 32 * src + 32)
        bits = (words[:, src : src + 1] >> shifts) & 1
        # slots are distinct within a word, so the sum is the OR
        out.index_add_(1, dst_word[cols], bits << dst_shift[cols])
    return out[:, : int(n_words_out)].contiguous()
