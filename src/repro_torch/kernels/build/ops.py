"""pk-window gather of the bulk build — the CUDA kernel's wrapper and its
plain-PyTorch version.

The kernel (``csrc/pk_window.cu``) replaces the TPU kernel
``repro/kernels/build/kernel.py::_pk_window_kernel`` /
``pk_window_planes``: the ``pk`` bits of each entry's full key starting at
a per-entry bit position, bit-identical to ``core.btree._slice_bits``.  It
is bound by bytes; one thread per entry reads only the two key words its
window straddles instead of selecting across all W planes.
"""

from __future__ import annotations

import torch

from repro_torch.core.btree import _slice_bits
from repro_torch.kernels import cudalib

__all__ = ["pk_windows", "pk_windows_plain"]


def pk_windows_plain(words: torch.Tensor, starts: torch.Tensor, pk: int) -> torch.Tensor:
    """(m, W) keys + (m,) start bit positions -> (m,) pk-bit windows."""
    return _slice_bits(words, starts, pk)


def pk_windows(words: torch.Tensor, starts: torch.Tensor, pk: int) -> torch.Tensor:
    """(m, W) int64-carrier keys + (m,) int64 start bit positions -> (m,)
    windows.  A drop-in ``slice_fn`` for ``build_btree``.

    A CPU tensor takes :func:`pk_windows_plain`; a CUDA tensor launches
    the kernel (or raises).
    """
    if words.device.type == "cpu":
        return pk_windows_plain(words, starts, pk)
    if not 1 <= pk <= 32:
        raise ValueError(f"pk must be in [1, 32], got {pk}")
    dev = words.device
    cudalib.check_tensor("words", words, dev, torch.int64, 2)
    cudalib.check_tensor("starts", starts, dev, torch.int64, 1)
    m, w = words.shape
    if starts.shape[0] != m:
        raise ValueError(f"{starts.shape[0]} starts for {m} keys")
    out = torch.empty((m,), dtype=torch.int64, device=dev)
    if m == 0:
        return out
    cudalib.launch("pk_window", "repro_pk_window", dev, words, starts, out, m, w, pk)
    return out
