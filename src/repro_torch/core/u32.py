"""The int64 carrier for 32-bit unsigned words.

The reference package holds key words, row ids and record ids as
``uint32``.  PyTorch cannot shift, compare, flip or ``searchsorted``
``uint32`` tensors, so the port holds every such value in an ``int64``
tensor whose values stay in ``0 .. 2**32 - 1``.  Ordering, equality and
right shifts then behave exactly as on ``uint32``; a *left* shift can
carry bits past bit 31 and must be masked with :data:`MASK32` (the
kernels reinterpret the low word as ``uint32_t`` instead).

These helpers are the only crossing points between the numpy ``uint32``
arrays the host side uses (``KeySet``, ``DSMeta``) and the carrier.
Beside them sit the port's two device helpers: :func:`resolve_device`
(CUDA unless the caller names a device) and :func:`sync_stream` (the one
wait for the card).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MASK32", "to_carrier", "to_u32", "resolve_device", "sync_stream"]

#: the low 32 bits — applied after every left shift of a carrier value
MASK32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    A missing GPU is an error, not a reason to run on the CPU: only an
    explicit ``device="cpu"`` selects the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


def sync_stream(device) -> None:
    """Wait for the work this thread queued on ``device``'s current stream.

    The port's one wait for the card.  It never synchronizes the whole
    device: a device-wide wait also waits on a stream that another thread
    is capturing into a CUDA graph, which invalidates that capture
    whatever its ``capture_error_mode``.  A no-op off CUDA."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def to_carrier(x, device: torch.device | str) -> torch.Tensor:
    """numpy ``uint32`` (or any integer array in 0..2**32-1) -> int64 tensor
    on ``device``.  ``uint32`` input crosses the bus at 4 bytes a word and
    widens on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    a = np.asarray(x)
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype == np.uint32:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
        return t.to(torch.int64) & MASK32
    return torch.as_tensor(a.astype(np.int64), device=device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int64 carrier tensor -> numpy ``uint32`` on the host."""
    return t.detach().cpu().numpy().astype(np.uint32)
