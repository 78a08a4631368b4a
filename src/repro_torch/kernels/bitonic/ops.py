"""Bitonic block sort — the CUDA kernel's wrapper and its plain-PyTorch
version.

The kernel (``csrc/bitonic.cu``) replaces the TPU kernel
``repro/kernels/bitonic/kernel.py::_bitonic_kernel`` /
``bitonic_block_sort_planes``: each ``block`` rows are sorted on their own
by a bitonic network, lexicographically over the key words, with the row
id as payload.  The network is not stable, so the result is defined by
the network itself: the plain version below runs the reference's network
lane for lane, and the kernel's pairwise compare-exchange makes the same
choice at every lane, so all three agree byte for byte.  Its bound is
the bytes (one read and one write of each row); keys of 1-8 and 16 words
sort in registers, where integer issue limits the kernel.  Any other
width, up to the reference's 128-word keys, sorts with the leading key
words in shared memory and the rest read from device memory on a tie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cudalib

__all__ = ["DEFAULT_BLOCK", "block_sort", "block_sort_plain"]

DEFAULT_BLOCK = 512

#: pad rows past n read as all-ones in every plane (sort last, as in the
#: reference's padding)
_SENTINEL = 0xFFFFFFFF


def block_sort_plain(
    words: torch.Tensor, rows: torch.Tensor, block: int = DEFAULT_BLOCK
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference network with tensor ops: per substage every lane
    compares itself with its partner ``lane ^ j`` and keeps its own entry
    or takes the partner's (ties keep their own)."""
    n, w = words.shape
    total = n + (-n % block)
    planes = torch.cat([words.T, rows[None, :].to(words.dtype)], dim=0)
    if total > n:
        pad = torch.full((w + 1, total - n), _SENTINEL, dtype=planes.dtype,
                         device=planes.device)
        planes = torch.cat([planes, pad], dim=1)
    x = planes.reshape(w + 1, total // block, block)
    idx = torch.arange(block, device=words.device)
    for stage in range(1, block.bit_length()):
        k = 1 << stage
        for sub in range(stage - 1, -1, -1):
            j = 1 << sub
            px = x[:, :, idx ^ j]
            lt = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
            eq = torch.ones_like(lt)
            for word in range(w):
                lt = lt | (eq & (x[word] < px[word]))
                eq = eq & (x[word] == px[word])
            want_le = ((idx & j) == 0) == ((idx & k) == 0)
            keep = torch.where(want_le, lt | eq, ~lt)
            x = torch.where(keep, x, px)
    out = x.reshape(w + 1, total)[:, :n]
    return out[:w].T.contiguous(), out[w].contiguous()


def block_sort(
    words: torch.Tensor, rows: torch.Tensor, block: int = DEFAULT_BLOCK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each ``block`` of rows of (n, W) keys + (n,) row payload.

    A CPU tensor takes :func:`block_sort_plain`; a CUDA tensor launches the
    kernel (or raises).  Returns the block-sorted keys and rows.
    """
    if block < 2 or block & (block - 1) or block > 2048:
        raise ValueError(f"block must be a power of two in [2, 2048], got {block}")
    if words.device.type == "cpu":
        return block_sort_plain(words, rows, block)
    dev = words.device
    cudalib.check_tensor("words", words, dev, torch.int64, 2)
    cudalib.check_tensor("rows", rows, dev, torch.int64, 1)
    n, w = words.shape
    if rows.shape[0] != n:
        raise ValueError(f"{rows.shape[0]} rows for {n} keys")
    keys_out = torch.empty_like(words)
    rows_out = torch.empty_like(rows)
    if n == 0:
        return keys_out, rows_out
    cudalib.launch(
        "bitonic_block_sort", "repro_bitonic_block_sort", dev,
        words, rows, keys_out, rows_out, n, w, block,
    )
    return keys_out, rows_out
