"""Adjacent distinction bits — the CUDA kernel's two forms, their wrappers
and their plain-PyTorch versions.

The kernel (``csrc/dbit.cu``) replaces the TPU kernel
``repro/kernels/dbit/kernel.py::_dbit_kernel`` / ``dbit_planes``: for
each adjacent pair of a sorted run, the position of the first differing
bit, ``32*w + clz(prev ^ cur)`` at the first word ``w`` that differs, or
``NO_DBIT`` for an equal pair.  Two forms of one template:

* :func:`adjacent_dbits`, the positions, (n-1,) int32: the bulk build's
  leaf dpos (``build_btree``'s ``dpos_fn``);
* :func:`adjacent_dbitmap`, the OR of every pair's bit, (W,) bitmap words
  in the run's own bit space, reduced on the card: the refresh's D-bitmap
  and ``meta_from_keys``'s, where only these W words cross to the host.

Both read the run in place, a lane a row and a 32-byte sector a step,
and compare a row's later sectors only where its first one equals its
predecessor's.  Both are bound by bytes.
"""

from __future__ import annotations

import torch

from repro_torch.core.dbits import adjacent_dbit_positions, positions_to_bitmap
from repro_torch.kernels import cudalib

__all__ = ["SECTOR_WORDS", "adjacent_dbits", "adjacent_dbits_plain",
           "adjacent_dbitmap", "adjacent_dbitmap_plain"]

#: words of a row the kernel compares a step (one 32-byte sector of int64
#: carriers, ``kSector`` in ``csrc/dbit.cu``); a row's later sectors are
#: read only where the earlier ones equal its predecessor's
SECTOR_WORDS = 4


def adjacent_dbits_plain(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) sorted keys -> (n-1,) int32 positions with plain tensor ops."""
    return adjacent_dbit_positions(sorted_words).to(torch.int32)


def adjacent_dbitmap_plain(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) sorted keys -> (W,) int64-carrier bitmap of the adjacent
    D-bits with plain tensor ops."""
    return positions_to_bitmap(adjacent_dbit_positions(sorted_words),
                               int(sorted_words.shape[1]))


def _launch(form: str, entry: str, sorted_words: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    n, w = sorted_words.shape
    if n >= 2:
        cudalib.launch("dbit", entry, sorted_words.device, sorted_words, out, n, w,
                       form=form)
    return out


def adjacent_dbits(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) int64-carrier sorted keys -> (n-1,) int32 adjacent D-bit
    positions (``NO_DBIT`` where a key equals its predecessor).

    A CPU tensor takes :func:`adjacent_dbits_plain`; a CUDA tensor
    launches the kernel's positions form (or raises).  ``n < 2`` gives an
    empty vector and launches nothing.
    """
    if sorted_words.device.type == "cpu":
        return adjacent_dbits_plain(sorted_words)
    dev = sorted_words.device
    cudalib.check_tensor("sorted_words", sorted_words, dev, torch.int64, 2)
    out = torch.empty((max(int(sorted_words.shape[0]) - 1, 0),), dtype=torch.int32,
                      device=dev)
    return _launch("positions", "repro_dbit", sorted_words, out)


def adjacent_dbitmap(sorted_words: torch.Tensor) -> torch.Tensor:
    """(n, W) int64-carrier sorted keys -> (W,) int64-carrier bitmap with
    the bit of every adjacent pair's D-bit set (MSB first; equal pairs set
    nothing).

    A CPU tensor takes :func:`adjacent_dbitmap_plain`; a CUDA tensor
    launches the kernel's bitmap form (or raises).  ``n < 2`` gives zeros
    and launches nothing.
    """
    if sorted_words.device.type == "cpu":
        return adjacent_dbitmap_plain(sorted_words)
    dev = sorted_words.device
    cudalib.check_tensor("sorted_words", sorted_words, dev, torch.int64, 2)
    n, w = sorted_words.shape
    out = (torch.empty if n >= 2 else torch.zeros)((w,), dtype=torch.int64, device=dev)
    return _launch("bitmap", "repro_dbitmap", sorted_words, out)
