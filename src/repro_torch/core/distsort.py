"""Distributed compressed-key sort: the row-column sort over a process group.

The paper's row-column sort (Appendix A) structures a parallel sort as
per-core block sorts, a per-core merge, a *perfect p-partition* across the
cores and a last per-core merge.  Over a ``torch.distributed`` group the
same roles are played by:

  CPU core          -> rank of the group
  L3-sized block    -> the local backend's block sort (the bitonic kernel
                       on CUDA, the plain keyed sort on the CPU)
  per-core merge    -> the local backend's keyed sort of the block runs
  perfect partition -> regular-sampling splitters + one bucketed
                       ``all_to_all_single``
  shared memory     -> the collective's transport: the step whose byte
                       volume key compression divides by the sort-key ratio

The phases of the reference's ``shard_fn`` (``repro/core/distsort.py``)
are kept step for step, so the global result equals the reference's
``DistSortResult`` byte for byte: the splitters, the buckets, the
capacity, the sentinel pad rows and the overflow count.

**The SPMD model.**  Every rank of the group calls the sort with the same
global ``(n, W)`` words and ``(n,)`` rids; rank ``r`` takes rows
``[r*n/p, (r+1)*n/p)``.  Every host-side decision (the ``p == 1`` early
return, the retry on overflow) depends only on values every rank holds
alike, the overflow count being all-reduced first, so no rank skips a
collective the others wait in.  Each rank's ``(p*cap, W)`` block is then
all-gathered in rank order, so every rank returns the *global* arrays.

**Capacity** (the reference's adaptation note): a bucket holds
``cap = ceil(n/p * capacity_factor / p)`` rows, so the exchange has equal
splits; rows past a full bucket are dropped and *counted*
(``overflow``), never lost silently.  ``backends.distributed`` retries
with doubled capacity until the count is 0.

**The wire.**  Key words, rids and the valid flag cross the group as
32-bit words (the int64 carriers' low halves reinterpreted as int32), so
an exchange moves the bytes the reference's ``uint32`` exchange moves.
Each exchange is one ``all_to_all_single`` of the packed rows: phase 0
packs the words and rids, phase 5 the keys, rids and valid flags.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .dbits import lex_compare_le, sort_words
from .u32 import MASK32, sync_stream

__all__ = ["DistSortResult", "group_layout", "make_sample_sort", "sample_sort",
           "all_gather_rows", "to_wire", "from_wire"]

#: pad key word and rid of the capacity buckets' empty slots: all-ones
#: words sort after every real key; the valid mask, not the sentinel, is
#: authoritative
SENTINEL = 0xFFFFFFFF

#: ``all_gather_single`` where this torch has it (it replaces
#: ``all_gather_into_tensor``), else the older name: one call either way
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclass
class DistSortResult:
    """Globally sorted keys, shard-padded (the reference's layout).

    keys:     (p * cap_rows, W) int64 carriers; rank i's rows are
              [i*cap_rows, (i+1)*cap_rows), sorted, with sentinel rows at
              the tail.  The valid prefixes of the ranks' blocks, in rank
              order, are the global (key, rid) order.
    rids:     (p * cap_rows,) permuted rids (sentinel rows: 0xFFFFFFFF).
    valid:    (p * cap_rows,) bool, True for real rows.
    overflow: rows dropped by full buckets, summed over the group (0 in a
              healthy run; the backend retries with more capacity).
    stats:    this rank's walls (``sort_s``, ``spread_s``, ``exchange_s``,
              ``gather_s``) and the bytes it sent in the two exchanges
              (``spread_bytes``, ``exchange_bytes``).
    """

    keys: torch.Tensor
    rids: torch.Tensor
    valid: torch.Tensor
    overflow: int
    stats: dict = field(default_factory=dict)


def group_layout(group=None) -> tuple[int, int]:
    """``(size, rank)`` of ``group`` (the default group when ``None``);
    ``(1, 0)`` without an initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a group was given but no process group is initialised")
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """int64 carriers (0..2**32-1) -> int32 holding the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def from_wire(x: torch.Tensor) -> torch.Tensor:
    """int32 wire words -> int64 carriers."""
    return x.to(torch.int64) & MASK32


def _sync(t: torch.Tensor) -> None:
    sync_stream(t.device)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split ``all_to_all_single`` along dim 0: block i goes to rank
    i, and block j of the output came from rank j (the reference's
    ``all_to_all`` with split and concat axis 0)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather_rows(x: torch.Tensor, p: int, group) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) stacked along dim 0 in
    rank order: ``(p * x.shape[0],) + x.shape[1:]``."""
    out = x.new_empty((p * int(x.shape[0]),) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def _keyed_sort(keys: torch.Tensor, local) -> torch.Tensor:
    """Rows of ``keys`` in ascending order over every column, through the
    local backend's sort with the lane positions as its rows: rows equal
    on every column are identical bytes, so their order cannot show."""
    lanes = torch.arange(int(keys.shape[0]), dtype=torch.int64, device=keys.device)
    return local.sort(keys, lanes)[0]


def make_sample_sort(group, n_per_shard: int, n_words: int, capacity_factor: float = 1.5,
                     *, local):
    """The distributed sample sort over ``group`` (``None``: the default
    group, or one rank without a process group).

    Returns ``fn(words (n, W), rids (n,)) -> DistSortResult`` with ``n =
    p * n_per_shard``; every rank passes the same global inputs (int64
    carriers on the local backend's device) and gets the global result.
    ``local`` is the backend that runs the shard-local sorts.
    """
    p, rank = group_layout(group)
    cap = int(np.ceil(n_per_shard * capacity_factor / max(p, 1)))  # per bucket
    recv = p * cap  # rows per rank after the exchange
    w = int(n_words)
    ln = int(n_per_shard)

    def run(words: torch.Tensor, rids: torch.Tensor) -> DistSortResult:
        dev = words.device
        stats = {"spread_s": 0.0, "exchange_s": 0.0, "gather_s": 0.0,
                 "spread_bytes": 0, "exchange_bytes": 0}
        _sync(words)
        t_run = time.perf_counter()
        mine = slice(rank * ln, (rank + 1) * ln)
        words, rids = words[mine], rids[mine]

        # -- phase 0: the spread exchange ----------------------------------
        # a range-partitioned input (already sorted, say) would put every
        # row of a shard into one bucket; a fixed block exchange first
        # gives every rank a cross-section of the global range
        if p > 1 and ln % p == 0:
            packed = to_wire(torch.cat([words, rids[:, None]], dim=1))
            t0 = time.perf_counter()
            packed = _all_to_all(packed, group)
            _sync(packed)
            stats["spread_s"] = time.perf_counter() - t0
            stats["spread_bytes"] = packed.numel() * 4
            packed = from_wire(packed)
            words, rids = packed[:, :w], packed[:, w]

        # -- phase 1: the keyed local sort ---------------------------------
        keyed = _keyed_sort(torch.cat([words, rids[:, None]], dim=1), local)  # (ln, W+1)
        sw, srid = keyed[:, :w], keyed[:, w]

        if p == 1:
            pad = max(recv - ln, 0)
            keys = torch.cat([sw, torch.full((pad, w), SENTINEL, dtype=torch.int64,
                                             device=dev)])[:recv]
            out_r = torch.cat([srid, torch.full((pad,), SENTINEL, dtype=torch.int64,
                                                device=dev)])[:recv]
            valid = torch.arange(recv, device=dev) < ln
            _sync(keys)
            stats["sort_s"] = time.perf_counter() - t_run
            return DistSortResult(keys.contiguous(), out_r.contiguous(), valid, 0, stats)

        # -- phase 2: regular sampling -> global splitters -----------------
        # the splitters carry the rid as their last word, which splits runs
        # of equal keys across ranks as the perfect partition does
        step = max(ln // p, 1)
        samp_idx = (torch.arange(p, device=dev) * step + step // 2).clamp(max=ln - 1)
        samples = keyed[samp_idx]  # (p, W+1)
        all_samples = from_wire(all_gather_rows(to_wire(samples), p, group))  # (p*p, W+1)
        (sorted_samples,) = sort_words(all_samples)
        splitters = sorted_samples[torch.arange(1, p, device=dev) * p]  # (p-1, W+1)

        # -- phase 3: bucket = #splitters <= keyed row; buckets are
        # contiguous runs of the sorted shard -------------------------------
        bucket = lex_compare_le(splitters[None, :, :], keyed[:, None, :]).sum(dim=1)
        start = torch.searchsorted(bucket, torch.arange(p, device=dev), side="left")
        within = torch.arange(ln, device=dev) - start[bucket]
        overflow = (within >= cap).sum()

        # -- phase 4: scatter into the capacity buckets (full ones drop) ---
        send = torch.full((p, cap, w + 2), -1, dtype=torch.int32, device=dev)  # sentinel
        send[..., w + 1] = 0  # valid flag
        ok = within < cap
        rows = to_wire(torch.cat([sw, srid[:, None], torch.ones_like(srid)[:, None]], dim=1))
        send[bucket[ok], within[ok]] = rows[ok]
        del rows, keyed

        # -- phase 5: the "shared memory" step -> all_to_all ---------------
        _sync(send)
        t0 = time.perf_counter()
        got = _all_to_all(send.reshape(recv, w + 2), group)
        _sync(got)
        stats["exchange_s"] = time.perf_counter() - t0
        stats["exchange_bytes"] = send.numel() * 4
        del send

        # -- phase 6: the keyed merge-sort of the received rows, by (key,
        # rid, valid); then the overflow summed over the group -------------
        merged = _keyed_sort(from_wire(got), local)  # (recv, W+2)
        dist.all_reduce(overflow, group=group)
        total_overflow = int(overflow)

        # every rank returns the global arrays: the blocks in rank order
        _sync(merged)
        t0 = time.perf_counter()
        glob = from_wire(all_gather_rows(to_wire(merged), p, group))
        _sync(glob)
        stats["gather_s"] = time.perf_counter() - t0
        stats["sort_s"] = time.perf_counter() - t_run
        return DistSortResult(glob[:, :w].contiguous(), glob[:, w].contiguous(),
                              glob[:, w + 1] != 0, total_overflow, stats)

    return run


def sample_sort(words: torch.Tensor, rids: torch.Tensor, group=None,
                capacity_factor: float = 1.5, *, local=None) -> DistSortResult:
    """Build and run the distributed sort once.  ``local`` defaults to the
    ``"cuda"`` backend on a CUDA tensor and ``"torch"`` otherwise."""
    n, w = (int(s) for s in words.shape)
    p, _ = group_layout(group)
    if n % p:
        raise ValueError(f"n={n} must divide evenly over a group of {p}")
    if local is None:
        from repro_torch.backends import get_backend

        local = get_backend("cuda" if words.device.type == "cuda" else "torch",
                            device=words.device)
    return make_sample_sort(group, n // p, w, capacity_factor, local=local)(words, rids)
