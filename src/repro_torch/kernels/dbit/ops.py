"""Adjacent distinction bits — the CUDA kernel's wrapper and its
plain-PyTorch version.

The kernel (``csrc/dbit.cu``) replaces the TPU kernel
``repro/kernels/dbit/kernel.py::_dbit_kernel`` / ``dbit_planes``: for
each adjacent pair of a sorted run, the position of the first differing
bit, ``32*w + clz(prev ^ cur)`` at the first word ``w`` that differs, or
``NO_DBIT`` for an equal pair.  One thread per pair reads both rows in
place, so no shifted copies of the run are made.  It is bound by bytes:
one read of each row and one int32 written per pair.
"""

from __future__ import annotations

import torch

from repro_torch.core.dbits import adjacent_dbit_positions
from repro_torch.kernels import cudalib

__all__ = ["adjacent_dbits", "adjacent_dbits_plain"]


def adjacent_dbits_plain(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) sorted keys -> (n-1,) int32 positions with plain tensor ops."""
    return adjacent_dbit_positions(sorted_words).to(torch.int32)


def adjacent_dbits(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) int64-carrier sorted keys -> (n-1,) int32 adjacent D-bit
    positions (``NO_DBIT`` where a key equals its predecessor).

    A CPU tensor takes :func:`adjacent_dbits_plain`; a CUDA tensor
    launches the kernel (or raises).  ``n < 2`` gives an empty vector.
    """
    if sorted_words.device.type == "cpu":
        return adjacent_dbits_plain(sorted_words)
    dev = sorted_words.device
    cudalib.check_tensor("sorted_words", sorted_words, dev, torch.int64, 2)
    n, w = sorted_words.shape
    m = max(n - 1, 0)
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    cudalib.launch("dbit", "repro_dbit", dev, sorted_words, out, m, w)
    return out
