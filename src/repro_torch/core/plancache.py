"""Shape buckets and pad normalization for the reconstruction stages.

The reference compiles one program per shape bucket and caches it; the
port runs eagerly, so it has no program cache.  What it keeps are the
bucket shapes and the pad discipline, because they decide what the sort
kernels see and therefore which bytes come out:

* inputs of the sort are padded up to a **bucket** (a power of two with a
  per-op floor) and carry a dynamic valid count ``n_valid``;
* the sort first **normalizes** the pad lanes — every lane ``>= n_valid``
  becomes the all-ones sentinel key with a row id from a reserved range
  (``>= 2**31``, above any real row position) — so under the (key, row)
  determinism contract the pads sort strictly after every real pair,
  whatever the pad lanes held before;
* ``keep_padded`` returns the bucket-shaped sorted run so the pipeline
  chains it into the build and refresh stages, which read only the first
  ``n_valid`` lanes.

The chunked large-N sort, the merge buckets and the program counters wait
for later slices of the port (ROADMAP Queue 1 items 5 and 9).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "BUCKET_MIN",
    "SENTINEL",
    "ROW_PAD_A",
    "ROW_PAD_B",
    "bucket",
    "bucket_for",
    "set_bucket_floor",
    "get_bucket_floor",
    "iota",
    "pad_tail",
    "sort_padded",
    "adjacent_dpos_padded",
]

#: default bucket floor — tiny inputs share one shape
BUCKET_MIN = 256

#: sentinel key word for pad rows (sorts last; ties break on the row id)
SENTINEL = 0xFFFFFFFF

#: pad row-id bases: above any real row position (rows are in [0, n) with
#: n < 2**31) and distinct between the two runs of a merge
ROW_PAD_A = 0x80000000
ROW_PAD_B = 0xC0000000


def bucket(n: int, minimum: int = BUCKET_MIN) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()


#: per-op bucket floors (op -> floor); ops not listed use ``BUCKET_MIN``
_FLOORS: dict[str, int] = {}


def set_bucket_floor(op: str, floor: int | None) -> None:
    """Override the bucket floor for one op family (``None`` restores the
    ``BUCKET_MIN`` default)."""
    if floor is None:
        _FLOORS.pop(op, None)
        return
    if int(floor) < 1:
        raise ValueError(f"bucket floor must be >= 1, got {floor}")
    _FLOORS[op] = int(floor)


def get_bucket_floor(op: str) -> int:
    """The effective bucket floor for ``op``."""
    return _FLOORS.get(op, BUCKET_MIN)


def bucket_for(op: str, n: int) -> int:
    """Bucket of ``n`` under ``op``'s floor (see :func:`set_bucket_floor`)."""
    return bucket(n, get_bucket_floor(op))


def iota(n: int, device) -> torch.Tensor:
    """``arange(n)`` as int64-carrier row positions on ``device``."""
    return torch.arange(int(n), dtype=torch.int64, device=device)


def pad_tail(x: torch.Tensor, total: int, fill, dim: int = 0) -> torch.Tensor:
    """Grow ``x`` to ``total`` along ``dim`` with ``fill`` (identity when it
    is already ``total`` long)."""
    n = int(x.shape[dim])
    total = int(total)
    if n == total:
        return x
    if n > total:
        raise ValueError(f"cannot pad {n} rows down to {total}")
    shape = list(x.shape)
    shape[dim] = total - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)


def _mask_run(keys, rows, n_valid: int, row_base: int):
    """Pad normalization: lanes >= n_valid become (all-ones key, reserved
    row id) pairs that sort strictly last, whatever they held before."""
    lane = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    valid = lane < n_valid
    keys = torch.where(valid[:, None], keys, torch.full_like(keys, SENTINEL))
    rows = torch.where(valid, rows, row_base + lane)
    return keys, rows


def sort_padded(
    keys: torch.Tensor,
    rows: torch.Tensor,
    *,
    impl: Callable | None = None,
    n_valid: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed keyed sort.

    ``impl(keys_pad, rows_pad) -> (keys_sorted, rows_sorted)`` is the
    backend's sort body (default: the plain keyed sort); it runs over the
    bucket shape after the pad normalization.  ``n_valid`` marks the
    inputs as already bucket-shaped with ``n_valid`` real rows; without it
    the inputs are padded here.  ``keep_padded`` returns the full bucket
    (pads sorted to the tail) for callers that chain into another stage.
    """
    if n_valid is None:
        n = int(keys.shape[0])
        b = bucket_for("sort", n)
        keys = pad_tail(keys, b, SENTINEL)
        rows = pad_tail(rows, b, 0)
    else:
        n = int(n_valid)
    if impl is None:
        from .dbits import sort_words_keyed

        impl = sort_words_keyed
    ks, rs = impl(*_mask_run(keys, rows, n, ROW_PAD_A))
    if keep_padded:
        return ks, rs
    return ks[:n], rs[:n]


def adjacent_dpos_padded(comp_sorted: torch.Tensor, *, n_valid: int | None = None) -> np.ndarray:
    """Adjacent distinction-bit positions of a sorted run: (n-1,) int32 on
    the host with ``NO_DBIT`` at equal-key adjacencies.

    The refresh stage's device half; only the first ``n_valid`` lanes of
    a bucket-shaped run are read.  The host half (the scatter-OR into the
    bitmap words) is ``repro_torch.core.metadata.meta_on_rebuild``.
    """
    from .dbits import adjacent_dbit_positions

    n = int(comp_sorted.shape[0]) if n_valid is None else int(n_valid)
    if n < 2:
        return np.zeros((0,), np.int32)
    dpos = adjacent_dbit_positions(comp_sorted[:n])
    return dpos.to(torch.int32).cpu().numpy()
