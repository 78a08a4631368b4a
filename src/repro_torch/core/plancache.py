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

A merge normalizes the pads of its two runs the same way, with row ids
from two disjoint reserved ranges (``ROW_PAD_A`` for run a, ``ROW_PAD_B``
for run b), so the chunked sort's merge ladder chains bucket-shaped runs
from merge to merge.  ``tune_chunking`` measures the sort and merge costs
that pick the ladder's chunk size and threshold.
``fused_extract_sort_padded`` is the fused path's bucketed extract+sort.
The program cache and its counters (what a "program" and a "trace" are
on this card) wait for a later slice of the port (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .u32 import MASK32, to_carrier, to_u32

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
    "pad_run",
    "sort_padded",
    "merge_padded",
    "fused_extract_sort_padded",
    "adjacent_dpos_padded",
    "adjacent_dbitmap_padded",
    "ChunkPlan",
    "tune_chunking",
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


def pad_run(
    keys: torch.Tensor, rows: torch.Tensor, b: int, row_base: int = ROW_PAD_A
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a (key, row) run to ``b`` rows with sentinel pairs that sort last.

    Pad lane ``i`` gets the all-ones key and row id ``row_base + i``, the
    values the pad normalization writes, so eagerly padded runs and
    counted ones are interchangeable.
    """
    n = int(keys.shape[0])
    if n >= b:
        return keys, rows
    pad_ids = row_base + iota(b, rows.device)[n:]
    return pad_tail(keys, b, SENTINEL), torch.cat([rows, pad_ids])


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


def merge_padded(
    keys_a: torch.Tensor,
    rows_a: torch.Tensor,
    keys_b: torch.Tensor,
    rows_b: torch.Tensor,
    *,
    impl: Callable | None = None,
    n_valid_a: int | None = None,
    n_valid_b: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed two-run merge.

    ``impl(ka, ra, kb, rb) -> (keys, rows)`` is the backend's merge body
    (default: the plain ``merge_words_keyed``); it runs over the whole
    bucket-shaped runs after the pad normalization (run a's pads take row
    ids from ``ROW_PAD_A``, run b's from ``ROW_PAD_B``), so the first
    ``na + nb`` merged rows equal the unpadded merge whatever the pad
    lanes held.  ``n_valid_a``/``n_valid_b`` mark a run as already
    bucket-shaped; without them it is padded here.  ``keep_padded``
    returns the full ``(ba + bb,)`` outputs, pads sorted to the tail, for
    the ladder that chains them into the next merge.
    """
    if n_valid_a is None:
        na = int(keys_a.shape[0])
        ba = bucket_for("merge", na)
        keys_a, rows_a = pad_tail(keys_a, ba, SENTINEL), pad_tail(rows_a, ba, 0)
    else:
        na = int(n_valid_a)
    if n_valid_b is None:
        nb = int(keys_b.shape[0])
        bb = bucket_for("merge", nb)
        keys_b, rows_b = pad_tail(keys_b, bb, SENTINEL), pad_tail(rows_b, bb, 0)
    else:
        nb = int(n_valid_b)
    if impl is None:
        from .dbits import merge_words_keyed

        impl = merge_words_keyed
    km, rm = impl(*_mask_run(keys_a, rows_a, na, ROW_PAD_A),
                  *_mask_run(keys_b, rows_b, nb, ROW_PAD_B))
    if keep_padded:
        return km, rm
    return km[: na + nb], rm[: na + nb]


def fused_extract_sort_padded(
    words: torch.Tensor,
    plan,
    rows: torch.Tensor,
    *,
    n_valid: int | None = None,
    keep_padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed extract+sort in one call (the ``"torch"`` backend's fused
    path): the runtime-bitmap extraction under the plan's bitmap, then the
    keyed sort.

    All-ones pad keys extract to the all-ones compressed pattern, the
    maximum any real key can compress to, since the slack bits of the
    last compressed word are zero for every key; the reserved row range
    breaks the tie, so pads still sort strictly last.  The pads are
    normalized from the valid count before the extraction.
    ``n_valid``/``keep_padded`` behave as in :func:`sort_padded`.
    """
    from .compress import extract_bits_dynamic, plan_bitmap
    from .dbits import sort_words_keyed

    if n_valid is None:
        n = int(words.shape[0])
        b = bucket_for("sort", n)
        words = pad_tail(words, b, SENTINEL)
        rows = pad_tail(rows, b, 0)
    else:
        n = int(n_valid)
    wp, rp = _mask_run(words, rows, n, ROW_PAD_A)
    comp = extract_bits_dynamic(wp, plan_bitmap(plan), plan.n_words_out)
    ks, rs = sort_words_keyed(comp, rp)
    if keep_padded:
        return ks, rs
    return ks[:n], rs[:n]


def adjacent_dpos_padded(comp_sorted: torch.Tensor, *, n_valid: int | None = None) -> np.ndarray:
    """Adjacent distinction-bit positions of a sorted run: (n-1,) int32 on
    the host with ``NO_DBIT`` at equal-key adjacencies, the reference's
    refresh pass; only the first ``n_valid`` lanes of a bucket-shaped run
    are read.  The refresh itself takes :func:`adjacent_dbitmap_padded`,
    whose W words are all that cross to the host.
    """
    from .dbits import adjacent_dbit_positions

    n = int(comp_sorted.shape[0]) if n_valid is None else int(n_valid)
    if n < 2:
        return np.zeros((0,), np.int32)
    return adjacent_dbit_positions(comp_sorted[:n]).to(torch.int32).cpu().numpy()


def adjacent_dbitmap_padded(
    comp_sorted: torch.Tensor,
    *,
    n_valid: int | None = None,
    impl: Callable | None = None,
) -> np.ndarray:
    """The OR of a sorted run's adjacent distinction bits: (W,) uint32
    bitmap words on the host, in the run's own bit space (equal-key
    adjacencies set nothing).

    The refresh stage's device half in bitmap form: only the first
    ``n_valid`` lanes of a bucket-shaped run are read, and only the W
    words cross to the host.  ``impl(sorted_keys) -> (W,)`` is the
    backend's pass (default: the plain pass of ``compute_dbitmap``; the
    CUDA backend passes its dbit kernel's bitmap form).  The host half
    (each set bit mapped through D-offset) is
    ``repro_torch.core.metadata.meta_on_rebuild``.
    """
    from .dbits import compute_dbitmap

    n = int(comp_sorted.shape[0]) if n_valid is None else int(n_valid)
    return to_u32(compute_dbitmap(comp_sorted[:n], presorted=True, dbitmap_fn=impl))


# ---------------------------------------------------------------------------
# measured chunk tuning: chunk_threshold / chunk_size from the measured
# per-bucket sort and merge costs instead of static constructor knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChunkPlan:
    """A measured chunking policy for one backend.

    ``chunk_size`` minimizes the modeled *warm* cascade wall at ``ref_n``
    keys; ``chunk_threshold`` is the smallest power-of-two key count at
    which the chunked path's cold cost undercuts the extrapolated
    monolithic sort's.  The raw per-candidate samples ride along
    (seconds; ``*_cold`` is a first call, ``*_warm`` a repeat).
    """

    backend: str
    chunk_size: int
    chunk_threshold: int
    ref_n: int
    n_words: int
    sort_cold: dict[int, float]
    sort_warm: dict[int, float]
    merge_cold: dict[int, float]
    merge_warm: dict[int, float]


def _cascade_warm_model(n: int, c: int, sort_w: float, merge_w: float) -> float:
    """Modeled warm cascade wall: per-chunk sorts + per-level merges.

    The merge sample is one equal-halves merge at output bucket ``2c``;
    higher levels scale linearly in merged rows times the rank search's
    log(bucket) growth.
    """
    n_chunks = -(-n // c)
    cost = n_chunks * sort_w
    per_row = merge_w / (2 * c)
    base_steps = max(math.log2(c), 1.0)
    runs, size = n_chunks, c
    while runs > 1:
        merged_rows = (runs // 2) * 2 * size
        cost += per_row * merged_rows * (max(math.log2(size), 1.0) / base_steps)
        runs = -(-runs // 2)
        size *= 2
    return cost


def _median_wall(fn, iters: int, device: torch.device) -> float:
    """Median host wall of ``fn`` over ``iters`` calls, each ended by a
    device synchronize on a CUDA device."""
    walls = []
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2]


def tune_chunking(
    backend,
    *,
    candidates: tuple[int, ...] = (1 << 16, 1 << 17, 1 << 18),
    n_words: int = 2,
    ref_n: int = 1 << 20,
    iters: int = 1,
    seed: int = 0,
) -> ChunkPlan:
    """Calibrate ``chunk_size`` / ``chunk_threshold`` for one backend.

    For every candidate chunk bucket ``c`` this times the backend's sort
    at bucket ``c`` (cold = the first call, then warm repeats) and one
    equal-halves merge at output bucket ``2c``, on random keys made on
    the backend's device.  ``backend`` is duck-typed: anything with the
    ``sort`` / ``merge_sorted`` backend-op signatures and a ``device``.

    The model is the reference's.  The reference reads "cold minus warm"
    as compile time; the port runs eagerly and has no compile, so here it
    is the first-call cost (allocator growth, kernel library and cuBLAS /
    cub workspace set-up), and the plan's numbers differ from the
    reference's.

    * ``chunk_size`` — the candidate minimizing the modeled warm cascade
      wall at ``ref_n`` keys (``_cascade_warm_model``).
    * ``chunk_threshold`` — the smallest power of two ``N >= 2 *
      chunk_size`` where the extrapolated monolithic cold cost (first-call
      cost fitted as a power law over the two largest candidates + n·log n
      warm scaling) exceeds the chunked path's cold cost; ``ref_n`` if the
      model never crosses below it.
    """
    rng = np.random.default_rng(seed)
    cands = sorted(int(c) for c in candidates)
    if len(cands) < 2:
        raise ValueError("need at least two chunk-size candidates")
    for c in cands:
        if c & (c - 1):
            raise ValueError(f"chunk-size candidates must be powers of two: {c}")
    dev = backend.device

    sort_cold: dict[int, float] = {}
    sort_warm: dict[int, float] = {}
    merge_cold: dict[int, float] = {}
    merge_warm: dict[int, float] = {}

    for c in cands:
        keys = to_carrier(rng.integers(0, 2**32, size=(c, n_words), dtype=np.uint32), dev)
        rows = iota(c, dev)

        def sort_c():
            return backend.sort(keys, rows, n_valid=c, keep_padded=True)

        sort_cold[c] = _median_wall(sort_c, 1, dev)
        sort_warm[c] = _median_wall(sort_c, iters, dev)
        # equal-halves merge at output bucket 2c: two independently sorted
        # c/2-runs with disjoint row ranges (the cascade invariant)
        h = c // 2
        ka, ra = backend.sort(keys[:h], iota(h, dev), n_valid=h, keep_padded=True)
        kb, rb = backend.sort(keys[h:], iota(h, dev), n_valid=h, keep_padded=True)
        rb = (rb + h) & MASK32

        def merge_c():
            return backend.merge_sorted(ka, ra, kb, rb, n_valid_a=h, n_valid_b=h,
                                        keep_padded=True)

        merge_cold[c] = _median_wall(merge_c, 1, dev)
        merge_warm[c] = _median_wall(merge_c, iters, dev)

    chunk_size = min(
        cands, key=lambda c: _cascade_warm_model(ref_n, c, sort_warm[c], merge_warm[c])
    )

    # -- threshold: where the monolithic first-call cost stops being worth paying
    c1, c2 = cands[-2], cands[-1]
    comp1 = max(sort_cold[c1] - sort_warm[c1], 1e-6)
    comp2 = max(sort_cold[c2] - sort_warm[c2], 1e-6)
    # first-call cost growth exponent, clamped to a sane superlinear band
    alpha = math.log(comp2 / comp1) / math.log(c2 / c1)
    alpha = min(max(alpha, 1.0), 3.0)
    c_ref = chunk_size
    sort_first = max(sort_cold[c_ref] - sort_warm[c_ref], 1e-6)
    merge_first = max(merge_cold[c_ref] - merge_warm[c_ref], 1e-6)
    warm_rate = sort_warm[c2] / (c2 * max(math.log2(c2), 1.0))

    def mono_cold(n: int) -> float:
        return comp2 * (n / c2) ** alpha + warm_rate * n * math.log2(n)

    def chunked_cold(n: int) -> float:
        levels = max(math.ceil(math.log2(-(-n // c_ref))), 1)
        firsts = sort_first + sum(
            merge_first * (2**lvl) ** (alpha - 1.0) for lvl in range(levels)
        )
        return firsts + _cascade_warm_model(n, c_ref, sort_warm[c_ref], merge_warm[c_ref])

    threshold = ref_n
    n = 2 * chunk_size
    while n < ref_n:
        if chunked_cold(n) < mono_cold(n):
            threshold = n
            break
        n *= 2

    return ChunkPlan(
        backend=getattr(backend, "name", "?"),
        chunk_size=chunk_size,
        chunk_threshold=threshold,
        ref_n=int(ref_n),
        n_words=int(n_words),
        sort_cold=sort_cold,
        sort_warm=sort_warm,
        merge_cold=merge_cold,
        merge_warm=merge_warm,
    )
