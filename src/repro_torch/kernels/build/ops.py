"""pk-window of the bulk build — the CUDA kernel's two forms, their
wrappers and their plain-PyTorch versions.

The kernel (``csrc/pk_window.cu``) replaces the TPU kernel
``repro/kernels/build/kernel.py::_pk_window_kernel`` /
``pk_window_planes``: the ``pk`` bits of each entry's full key starting at
a per-entry bit position, bit-identical to ``core.btree._slice_bits``.
Both forms are bound by bytes:

* :func:`gather_windows`, the leaf level: the build's own row gather
  ``table[rows]`` (whole rows, coalesced), with each entry's window taken
  from the gathered row on the way, so the window costs a start read and
  a window written per entry on top of the gather;
* :func:`pk_windows`, an upper level (``rows`` given): one thread per
  entry reads the two words of ``words[rows[i]]`` its window straddles, so
  ``words[rows]`` is never materialised.
"""

from __future__ import annotations

import torch

from repro_torch.core.btree import _gather_slice, _slice_rows
from repro_torch.kernels import cudalib

__all__ = ["gather_windows", "gather_windows_plain", "pk_windows", "pk_windows_plain"]


def _check_pk(pk: int) -> None:
    if not 1 <= pk <= 32:
        raise ValueError(f"pk must be in [1, 32], got {pk}")


def pk_windows_plain(words: torch.Tensor, starts: torch.Tensor, pk: int,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """(n, W) keys + (m,) start bit positions (+ (m,) row ids, else m = n)
    -> (m,) pk-bit windows of ``words[rows]``."""
    return _slice_rows(words, starts, pk, rows)


def pk_windows(words: torch.Tensor, starts: torch.Tensor, pk: int,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """(n, W) int64-carrier keys + (m,) int64 start bit positions -> (m,)
    windows of ``words[rows]`` (of ``words`` itself if ``rows`` is None,
    m = n).  A drop-in ``slice_fn`` for ``build_btree``.

    A CPU tensor takes :func:`pk_windows_plain`; a CUDA tensor launches
    the kernel (or raises).
    """
    if words.device.type == "cpu":
        return pk_windows_plain(words, starts, pk, rows)
    _check_pk(pk)
    dev = words.device
    cudalib.check_tensor("words", words, dev, torch.int64, 2)
    cudalib.check_tensor("starts", starts, dev, torch.int64, 1)
    m, w = int(starts.shape[0]), int(words.shape[1])
    if rows is None:
        if words.shape[0] != m:
            raise ValueError(f"{m} starts for {words.shape[0]} keys")
    else:
        cudalib.check_tensor("rows", rows, dev, torch.int64, 1)
        if rows.shape[0] != m:
            raise ValueError(f"{m} starts for {rows.shape[0]} rows")
    out = torch.empty((m,), dtype=torch.int64, device=dev)
    if m == 0:
        return out
    cudalib.launch("pk_window", "repro_pk_window", dev, words, rows, starts, out, m, w, pk)
    return out


def gather_windows_plain(table: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor,
                         pk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, W) keys by row + (m,) row ids + (m,) start bit positions ->
    ``(table[rows]`` (m, W), the (m,) pk-bit windows of those keys)."""
    return _gather_slice(table, rows, starts, pk)


def gather_windows(table: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor,
                   pk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The leaf level's gather and windows in one pass: ``(table[rows],
    windows)`` of int64 carriers.  A drop-in ``gather_slice_fn`` for
    ``build_btree``; ``rows`` must lie in ``[0, n)``.

    A CPU tensor takes :func:`gather_windows_plain`; a CUDA tensor
    launches the kernel (or raises).
    """
    if table.device.type == "cpu":
        return gather_windows_plain(table, rows, starts, pk)
    _check_pk(pk)
    dev = table.device
    cudalib.check_tensor("table", table, dev, torch.int64, 2)
    cudalib.check_tensor("rows", rows, dev, torch.int64, 1)
    cudalib.check_tensor("starts", starts, dev, torch.int64, 1)
    m, w = int(rows.shape[0]), int(table.shape[1])
    if starts.shape[0] != m:
        raise ValueError(f"{starts.shape[0]} starts for {m} rows")
    full = torch.empty((m, w), dtype=torch.int64, device=dev)
    out = torch.empty((m,), dtype=torch.int64, device=dev)
    if m == 0:
        return full, out
    cudalib.launch("pk_window", "repro_gather_window", dev, table, rows, starts, full, out,
                   m, w, pk)
    return full, out
