"""Merge-path ranks — the CUDA kernel's wrapper, its plain-PyTorch version
and the kernel-ranked merge.

The kernel (``csrc/merge_rank.cu``) replaces the TPU kernel
``repro/kernels/merge/kernel.py::_rank_kernel`` / ``merge_rank_planes``:
the rank of each (key, row) query in a run sorted by (key, row), the row
as the least-significant key word.  The merge ranks one sorted run in
another, so a block takes a tile of 256 consecutive queries: one warp
finds the window of the searched run between the ranks of the tile's
first query and the next tile's first; the block stages the tile and the
window's key words (or an evenly spaced sample of a larger window) in
shared memory, checks that the tile ascends, and searches there, ending a
sampled window with a few probes in device memory.  A tile that does not
ascend searches the whole run in device memory per query, so any query
order gives exact ranks.  The searched run has no size cap (the TPU kernel
needed it to fit VMEM).  Its bound counts bytes: each query and the key
words of each searched row read once.
"""

from __future__ import annotations

import torch

from repro_torch.core.dbits import merge_from_ranks, rank_in_sorted_keyed
from repro_torch.kernels import cudalib

__all__ = ["merge_ranks", "merge_ranks_plain", "merge_sorted"]


def merge_ranks_plain(keys_q: torch.Tensor, rows_q: torch.Tensor,
                      keys_s: torch.Tensor, rows_s: torch.Tensor) -> torch.Tensor:
    """#{i : (key_s, row_s)_i < (key_q, row_q)} per query with plain
    tensor ops: (n_q,) int32."""
    return rank_in_sorted_keyed(keys_s, rows_s, keys_q, rows_q)


def merge_ranks(keys_q: torch.Tensor, rows_q: torch.Tensor,
                keys_s: torch.Tensor, rows_s: torch.Tensor) -> torch.Tensor:
    """Rank of each (n_q, W) int64-carrier query pair in the ascending
    (n_s, W) run: (n_q,) int32.

    A CPU tensor takes :func:`merge_ranks_plain`; a CUDA tensor launches
    the kernel (or raises).  ``n_q == 0`` or ``n_s == 0`` gives zeros and
    launches nothing.
    """
    if keys_q.device.type == "cpu":
        return merge_ranks_plain(keys_q, rows_q, keys_s, rows_s)
    dev = keys_q.device
    cudalib.check_tensor("keys_q", keys_q, dev, torch.int64, 2)
    cudalib.check_tensor("rows_q", rows_q, dev, torch.int64, 1)
    cudalib.check_tensor("keys_s", keys_s, dev, torch.int64, 2)
    cudalib.check_tensor("rows_s", rows_s, dev, torch.int64, 1)
    n_q, w = keys_q.shape
    n_s = int(keys_s.shape[0])
    if keys_s.shape[1] != w:
        raise ValueError(f"query keys have {w} words, the searched run {keys_s.shape[1]}")
    if rows_q.shape[0] != n_q or rows_s.shape[0] != n_s:
        raise ValueError("each key needs one row id")
    if n_s >= 2**31:
        raise ValueError(f"a searched run of {n_s} rows overflows the int32 ranks")
    if n_q == 0 or n_s == 0:
        return torch.zeros((n_q,), dtype=torch.int32, device=dev)
    out = torch.empty((n_q,), dtype=torch.int32, device=dev)
    cudalib.launch("merge_rank", "repro_merge_rank", dev,
                   keys_q, rows_q, keys_s, rows_s, out, n_q, n_s, w)
    return out


def merge_sorted(keys_a: torch.Tensor, rows_a: torch.Tensor,
                 keys_b: torch.Tensor, rows_b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-ranked merge of two ascending (key, row) runs: the one rank
    pass (the smaller run in the larger) goes through :func:`merge_ranks`,
    the complement scatter is ``core.dbits.merge_from_ranks``'s, so the
    output equals ``merge_words_keyed`` byte for byte."""

    def kernel_ranks(keys_s, rows_s, keys_q, rows_q):
        return merge_ranks(keys_q, rows_q, keys_s, rows_s)

    return merge_from_ranks(keys_a, rows_a, keys_b, rows_b, rank_fn=kernel_ranks)
