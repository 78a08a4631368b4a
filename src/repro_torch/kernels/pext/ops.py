"""pext: compressed-key extraction — the CUDA kernel's wrapper, its
plain-PyTorch version, and the host compiler of the kernel's plan.

The kernel (``csrc/pext.cu``) replaces the TPU kernel
``repro/kernels/pext/kernel.py::_pext_kernel`` / ``pext_planes``.  It is
bound by bytes: one read of each key, one write of each compressed key.
It reads the row-major keys the pipeline already holds, so no (W, n)
plane transpose is needed.  It does not walk the plan bit by bit: the
host compiles the plan into per-source-byte segments (:func:`segment_plan`),
and the kernel spends one table read and one multiply-add per segment.
:func:`pext_segments` runs the kernel's segment loop with tensor ops; the
CPU tests hold it against the plain version and the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.compress import ExtractionPlan, extract_bits
from repro_torch.kernels import cudalib

__all__ = ["pext", "pext_plain", "pext_segments", "segment_plan"]


def pext_plain(words: torch.Tensor, plan: ExtractionPlan) -> torch.Tensor:
    """(n, W) keys -> (n, Wc) compressed keys with plain tensor ops."""
    return extract_bits(words, plan)


def _compact_tables(masks: np.ndarray) -> np.ndarray:
    """(m,) byte masks -> (m, 256) uint8: byte value v's bits under each
    mask, packed right-aligned in their order (most significant first)."""
    v = np.arange(256, dtype=np.int64)
    out = np.zeros((masks.size, 256), np.int64)
    for bit in range(7, -1, -1):
        kept = ((masks >> bit) & 1).astype(bool)[:, None]
        out = np.where(kept, (out << 1) | ((v[None, :] >> bit) & 1), out)
    return out.astype(np.uint8)


@lru_cache(maxsize=16)
def segment_plan(plan: ExtractionPlan) -> tuple[np.ndarray, np.ndarray]:
    """Compile ``plan`` into the kernel's segments and tables.

    A segment is a source byte with kept bits, split where those bits
    cross a destination word (output bit ``b`` is bit ``31 - b % 32`` of
    word ``b // 32``).  Returns ``(segments, tables)``: segments an (s, 4)
    int32 array of (byte address ``q ^ 3`` of source byte ``q`` in a
    little-endian row of u32 words, table offset, ``2**shift``, destination
    word), in output order; tables an (m, 256) uint8 array, one per
    distinct mask, entry ``v`` holding byte ``v``'s kept bits packed
    right-aligned.  A segment adds ``tables.flat[offset + byte] << shift``
    to its destination word.
    """
    pos = np.asarray(plan.positions, np.int64)
    rows, masks = [], []
    b = 0
    for q in np.unique(pos // 8):
        bits = (pos[pos // 8 == q] % 8).tolist()  # 0 = the byte's MSB
        while bits:
            room = 32 - b % 32
            take, bits = bits[:room], bits[room:]
            rows.append((int(q), len(take), 32 - b % 32 - len(take), b // 32))
            masks.append(sum(1 << (7 - o) for o in take))
            b += len(take)
    uniq, table_of = np.unique(np.asarray(masks, np.int64), return_inverse=True)
    segments = np.asarray(
        [(q ^ 3, int(t) * 256, 1 << shift, dw)
         for (q, _, shift, dw), t in zip(rows, table_of)], np.int64).reshape(-1, 4)
    return segments.astype(np.uint32).view(np.int32), _compact_tables(uniq)


def pext_segments(words: torch.Tensor, plan: ExtractionPlan) -> torch.Tensor:
    """The kernel's segment loop with tensor ops: (n, W) keys -> (n, Wc).
    Each key's words are read as little-endian u32 bytes, as the kernel
    reads its shared-memory row; used by the tests to check the plan
    format where there is no card."""
    segments, tables = segment_plan(plan)
    n = words.shape[0]
    row_bytes = words.to(torch.int32).contiguous().view(torch.uint8).reshape(n, -1)
    flat = torch.as_tensor(tables.reshape(-1).astype(np.int64), device=words.device)
    out = torch.zeros((n, plan.n_words_out), dtype=torch.int64, device=words.device)
    for addr, offset, mult, dw in segments.astype(np.uint32).astype(np.int64).tolist():
        out[:, dw] += flat[offset + row_bytes[:, addr].to(torch.int64)] * mult
    return out


@lru_cache(maxsize=16)
def _device_plan(plan: ExtractionPlan, device: torch.device) -> tuple[torch.Tensor, int, int]:
    """The segments, then the tables packed four bytes to an int32, as one
    device array, copied once per plan so that a launch moves no plan
    bytes; with the segment and table counts."""
    segments, tables = segment_plan(plan)
    packed = np.concatenate([segments.reshape(-1), tables.reshape(-1).view("<i4")])
    return torch.as_tensor(packed, device=device), len(segments), len(tables)


def pext(words: torch.Tensor, plan: ExtractionPlan) -> torch.Tensor:
    """(n, W) int64-carrier keys -> (n, Wc) compressed keys.

    A CPU tensor takes :func:`pext_plain`; a CUDA tensor launches the
    kernel (or raises).
    """
    if words.device.type == "cpu":
        return pext_plain(words, plan)
    cudalib.check_tensor("words", words, words.device, torch.int64, 2)
    n, w = words.shape
    if w != plan.n_words_in:
        raise ValueError(f"keys have {w} words, the plan expects {plan.n_words_in}")
    out = torch.empty((n, plan.n_words_out), dtype=torch.int64, device=words.device)
    if n == 0 or plan.n_bits == 0:
        return out
    dplan, n_seg, n_tables = _device_plan(plan, words.device)
    cudalib.launch("pext", "repro_pext", words.device,
                   words, dplan, out, n, w, plan.n_words_out, n_seg, n_tables)
    return out
