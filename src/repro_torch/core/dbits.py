"""Distinction bits (paper §3), on int64-carrier tensors.

Keys are ``(n, W)`` int64 tensors holding 32-bit words (see
``repro_torch.core.u32``), word 0 most significant; bit position ``p``
lives in word ``p // 32`` at shift ``31 - (p % 32)`` (position 0 = global
MSB, the paper's numbering).

* Lemma 1:    D-bit(key_i, key_j) = min_{i<k<=j} D_k   (adjacent D-bits).
* Theorem 1:  the D-bit positions over *all* pairs equal those over
              *adjacent* pairs in sorted order.
* Theorem 2:  the bit slice at (a superset of) the D-bit positions sorts
              the keys correctly.

``compute_dbitmap`` therefore looks only at adjacent keys of the sorted
input.  The merge primitives (``rank_in_sorted_keyed``,
``merge_from_ranks``, ``merge_words_keyed``) fold two sorted (key, row)
runs into one: the chunked sort's merge ladder and ``run_incremental``
use them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "lex_less",
    "lex_compare_le",
    "sort_words",
    "sort_words_keyed",
    "rank_in_sorted_keyed",
    "merge_from_ranks",
    "merge_words_keyed",
    "adjacent_dbit_positions",
    "dbit_position_pairwise",
    "positions_to_bitmap",
    "bitmap_to_positions",
    "dbit_positions_nonempty",
    "compute_dbitmap",
    "compute_variant_bitmap",
    "NO_DBIT",
]

#: D-bit position of two equal keys: one past any real bit position
NO_DBIT = 2**31 - 1


# ---------------------------------------------------------------------------
# multiword lexicographic comparison
# ---------------------------------------------------------------------------

def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vectorized ``a < b`` for (..., W) keys, word 0 most significant."""
    lt = a < b
    eq = a == b
    # all words before position i are equal
    eq_prefix = torch.cumprod(
        torch.cat([torch.ones_like(eq[..., :1]), eq[..., :-1]], dim=-1).to(torch.int32),
        dim=-1,
    ).bool()
    return (lt & eq_prefix).any(dim=-1)


def lex_compare_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vectorized ``a <= b`` for (..., W) keys."""
    return lex_less(a, b) | (a == b).all(dim=-1)


def sort_words(
    words: torch.Tensor, *payloads: torch.Tensor, num_key_words: int | None = None
) -> tuple[torch.Tensor, ...]:
    """Stable lexicographic sort of (n, W) keys with payload vectors.

    The reference's multi-operand ``lax.sort(num_keys=...)`` becomes a
    least-significant-first series of stable single-column sorts: the
    last key column first, word 0 last.  Rows equal on every key column
    keep their input order, as in the reference.
    """
    n, w = words.shape
    if num_key_words is None:
        num_key_words = w
    perm = torch.arange(n, device=words.device)
    for col in range(num_key_words - 1, -1, -1):
        order = torch.sort(words[perm, col], stable=True).indices
        perm = perm[order]
    return (words[perm],) + tuple(p[perm] for p in payloads)


def sort_words_keyed(
    keys: torch.Tensor, rows: torch.Tensor, *payloads: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Sort (n, W) keys with (n,) rows as the least-significant key word.

    The backend determinism contract: ascending (key, row) order whatever
    the input order.  Returns (keys_sorted, rows_sorted, *payloads_sorted),
    each contiguous: the CUDA kernels downstream take dense rows.
    """
    w = keys.shape[1]
    keyed = torch.cat([keys, rows.to(keys.dtype)[:, None]], dim=1)
    out = sort_words(keyed, *payloads)
    return (out[0][:, :w].contiguous(), out[0][:, w].contiguous()) + tuple(out[1:])


# ---------------------------------------------------------------------------
# merge of sorted (key, row) runs
# ---------------------------------------------------------------------------

def _pair_less(keys_a, rows_a, keys_b, rows_b) -> torch.Tensor:
    """Elementwise ``(key_a, row_a) < (key_b, row_b)`` for (m, W) keys and
    (m,) rows: lexicographic over the key words, the row as the last word."""
    lt = rows_a < rows_b
    for w in range(int(keys_a.shape[1]) - 1, -1, -1):
        ka, kb = keys_a[:, w], keys_b[:, w]
        lt = (ka < kb) | ((ka == kb) & lt)
    return lt


def rank_in_sorted_keyed(
    keys_s: torch.Tensor,
    rows_s: torch.Tensor,
    keys_q: torch.Tensor,
    rows_q: torch.Tensor,
) -> torch.Tensor:
    """Rank of each query pair in a sorted run: #{i : (key_s, row_s)_i < q}.

    ``(keys_s, rows_s)`` must be ascending in the (key, row) order of the
    backend determinism contract; the queries need not be sorted.  The
    output position of a run element in a two-run merge is its own index
    plus its rank in the *other* run.  A whole-array binary search of
    ``bit_length(n_s)`` steps; returns (n_q,) int32.
    """
    ns = int(keys_s.shape[0])
    nq = int(keys_q.shape[0])
    dev = keys_q.device
    if ns == 0 or nq == 0:
        return torch.zeros((nq,), dtype=torch.int32, device=dev)
    lo = torch.zeros((nq,), dtype=torch.int64, device=dev)
    hi = torch.full((nq,), ns, dtype=torch.int64, device=dev)
    for _ in range(max(1, ns.bit_length())):
        mid = (lo + hi) // 2
        midc = mid.clamp(max=ns - 1)
        lt = _pair_less(keys_s[midc], rows_s[midc], keys_q, rows_q) & (mid < ns)
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    return lo.to(torch.int32)


def merge_from_ranks(
    keys_a: torch.Tensor,
    rows_a: torch.Tensor,
    keys_b: torch.Tensor,
    rows_b: torch.Tensor,
    rank_fn=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two ascending (key, row) runs given a rank primitive.

    ``rank_fn(keys_s, rows_s, keys_q, rows_q)`` returns the rank of each
    query pair in the sorted run (#{s < q}); the default is
    ``rank_in_sorted_keyed``, the CUDA backend passes its kernel.  Rows
    must be distinct across the two runs, so the (key, row) order is total
    and the scatter collision-free.

    One rank pass, not two: the smaller run (``nb <= na`` picks b) is
    ranked in the larger, which gives its exact output positions; the
    larger run fills the other slots in its own order, so slot ``p`` holds
    its element ``p - #{ranked elements before p}`` — one cumsum and one
    gather.  The output is byte-identical to ``sort_words_keyed`` over the
    concatenation.
    """
    if rank_fn is None:
        rank_fn = rank_in_sorted_keyed
    na, nb = int(keys_a.shape[0]), int(keys_b.shape[0])
    if na == 0:
        return keys_b, rows_b
    if nb == 0:
        return keys_a, rows_a
    if nb <= na:
        small_k, small_r, big_k, big_r = keys_b, rows_b, keys_a, rows_a
    else:
        small_k, small_r, big_k, big_r = keys_a, rows_a, keys_b, rows_b
    n_small, n_big = int(small_k.shape[0]), int(big_k.shape[0])
    n, dev = na + nb, keys_a.device
    pos_s = torch.arange(n_small, device=dev) + rank_fn(big_k, big_r, small_k, small_r)
    occ = torch.zeros((n,), dtype=torch.int64, device=dev)
    occ[pos_s] = 1
    # number of ranked (small-run) elements strictly before each position
    before = torch.cumsum(occ, 0) - occ
    big_idx = (torch.arange(n, device=dev) - before).clamp(0, n_big - 1)
    keys = big_k[big_idx].index_copy_(0, pos_s, small_k)
    rows = big_r[big_idx].index_copy_(0, pos_s, small_r)
    return keys, rows


def merge_words_keyed(
    keys_a: torch.Tensor,
    rows_a: torch.Tensor,
    keys_b: torch.Tensor,
    rows_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two runs that are each ascending in (key, row) order with the
    plain rank pass: the semantics of the backend ``merge_sorted`` op."""
    return merge_from_ranks(keys_a, rows_a, keys_b, rows_b)


# ---------------------------------------------------------------------------
# distinction bit positions
# ---------------------------------------------------------------------------

def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values (x > 0), exactly: ``frexp`` of the
    float64 value (exact below 2**53) gives x = m * 2**e with m in
    [0.5, 1), so the highest set bit is e - 1."""
    _, exp = torch.frexp(x.to(torch.float64))
    return 32 - exp.to(torch.int64)


def dbit_position_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """D-bit(a, b) for (..., W) keys: MSB position where they differ.

    Returns ``NO_DBIT`` where the keys are equal (int64 result).
    """
    x = a ^ b
    nz = x != 0
    any_nz = nz.any(dim=-1)
    first_word = torch.argmax(nz.to(torch.int8), dim=-1)  # first differing word
    xw = torch.gather(x, -1, first_word[..., None])[..., 0]
    clz = _clz32(torch.where(any_nz, xw, torch.ones_like(xw)))
    pos = first_word * 32 + clz
    return torch.where(any_nz, pos, torch.full_like(pos, NO_DBIT))


def adjacent_dbit_positions(sorted_words: torch.Tensor) -> torch.Tensor:
    """D_i = D-bit(key_{i-1}, key_i) for i in 1..n-1 of sorted keys: (n-1,).

    Equal adjacent keys (duplicates) yield ``NO_DBIT``.
    """
    return dbit_position_pairwise(sorted_words[:-1], sorted_words[1:])


def positions_to_bitmap(positions: torch.Tensor, n_words: int) -> torch.Tensor:
    """Bit positions -> (n_words,) int64-carrier bitmap (MSB-first);
    ``NO_DBIT`` entries are ignored, duplicates are harmless."""
    occ = torch.zeros(n_words * 32, dtype=torch.bool, device=positions.device)
    occ[positions[positions != NO_DBIT]] = True
    shifts = torch.arange(31, -1, -1, device=positions.device)
    return (occ.view(n_words, 32).to(torch.int64) << shifts).sum(dim=1)


def bitmap_to_positions(bitmap: np.ndarray) -> np.ndarray:
    """Positions of set bits, ascending (host-side; bitmap is metadata)."""
    bm = np.asarray(bitmap, dtype=np.uint32)
    bits = np.unpackbits(bm.astype(">u4").view(np.uint8))
    return np.flatnonzero(bits).astype(np.int32)


def dbit_positions_nonempty(bitmap: np.ndarray) -> np.ndarray:
    """``bitmap_to_positions`` with the degenerate-bitmap convention.

    An empty D-bitmap (all keys identical) yields the single position 0 so
    extraction plans, D-offset tables and tree builds all keep one-bit
    shapes — the ONE place this convention is defined.
    """
    pos = bitmap_to_positions(bitmap)
    if len(pos) == 0:
        pos = np.asarray([0], dtype=np.int32)
    return pos


def compute_dbitmap(words: torch.Tensor, *, presorted: bool = False,
                    dbitmap_fn=None) -> torch.Tensor:
    """D-bitmap of a key set: sort, then adjacent-pair distinction bits.

    By Theorem 1 this bitmap covers the distinction bit positions of *every*
    key pair.  Returns a (W,) int64-carrier tensor on the keys' device.
    ``dbitmap_fn(sorted_words) -> (W,)`` is the adjacent-pair pass over the
    sorted keys (default: the positions, then their bits, with plain
    tensor ops; the CUDA backend passes its dbit kernel's bitmap form).
    """
    w = words if presorted else sort_words(words)[0]
    if dbitmap_fn is not None:
        return dbitmap_fn(w)
    return positions_to_bitmap(adjacent_dbit_positions(w), int(words.shape[1]))


def _or_reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 0 by pairwise halving (torch has no OR reduce)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        rest = x[2 * half:]
        x = torch.cat([x[:half] | x[half : 2 * half], rest], dim=0)
    return x[0]


def compute_variant_bitmap(
    words: torch.Tensor, reference: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Variant bitmap + reference key (paper §4.2): OR of (key XOR reference).

    The reference key is an arbitrary member — row 0.
    """
    ref = words[0] if reference is None else reference
    return _or_reduce_rows(words ^ ref[None, :]), ref
