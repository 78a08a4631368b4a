"""pext: compressed-key extraction — the CUDA kernel's wrapper and its
plain-PyTorch version.

The kernel (``csrc/pext.cu``) replaces the TPU kernel
``repro/kernels/pext/kernel.py::_pext_kernel`` / ``pext_planes``.  It is
bound by bytes: one read of each key, one write of each compressed key.
One thread walks the plan for its own key, reading the row-major keys the
pipeline already holds, so no (W, n) plane transpose is needed.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.compress import ExtractionPlan, extract_bits
from repro_torch.kernels import cudalib

__all__ = ["pext", "pext_plain"]


def pext_plain(words: torch.Tensor, plan: ExtractionPlan) -> torch.Tensor:
    """(n, W) keys -> (n, Wc) compressed keys with plain tensor ops."""
    return extract_bits(words, plan)


@lru_cache(maxsize=16)
def _device_plan(plan: ExtractionPlan, device: torch.device) -> torch.Tensor:
    """The plan packed as ``src_word << 5 | src_shift`` (int32), copied to
    ``device`` once per plan, so that a launch moves no plan bytes."""
    a = plan.as_arrays()
    return torch.as_tensor((a["src_word"] << 5) | a["src_shift"], device=device)


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
    if plan.n_bits * 4 > 48 * 1024:
        raise ValueError(f"plan of {plan.n_bits} bits exceeds the kernel's shared memory")
    out = torch.empty((n, plan.n_words_out), dtype=torch.int64, device=words.device)
    if n == 0:
        return out
    cudalib.launch(
        "pext", "repro_pext", words.device,
        words, _device_plan(plan, words.device), out, n, w, plan.n_words_out, plan.n_bits,
    )
    return out
