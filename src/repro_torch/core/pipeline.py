"""Unified reconstruction pipeline (paper §5, Figure 7) over pluggable backends.

    table (memory-resident) --scan--> extract compressed keys + rids
        --parallel sort--> sorted (comp key, rid) pairs
        --bottom-up build--> partial-key B+tree
        (+ recompute DS-metadata for next time, §4.3)

One pipeline, four explicit stages — ``extract``, ``sort``, ``build``,
``refresh_meta`` — with per-stage wall timings (the paper's Figure 9
breakdown) and per-run stats.  The stages dispatch to an
``ExecutionBackend`` (``repro_torch.backends``): ``torch`` (the plain
oracle), ``cuda`` (the hand-written kernels) or ``distributed`` (the
sample sort over a ``torch.distributed`` group, each rank's stages on
``cuda`` or ``torch``).  By default every stage
ends in a wait for the caller's stream (``u32.sync_stream``), which holds
all the stage's device work, so each timing covers it; ``async_dispatch``
waits once at the end instead.

* **chunked large-N sort** — above ``chunk_threshold`` keys the sort runs
  chunk by chunk and folds the sorted chunks with a binary-counter ladder
  of ``merge_sorted`` calls;
* **incremental delta-merge reconstruction** — ``run_incremental`` folds a
  change set (deletions as a keep-mask, insertions as a delta keyset)
  into a previous result without re-sorting the base: filter the
  surviving base run, extract and sort only the delta, merge the two
  runs, rebuild the tree.  The output is byte-identical to a full ``run``
  over the folded keyset with the same DS-metadata.

* **fused fast path** — ``fused=True`` on a backend that supports it
  runs extract+sort as one call (``stats["fused"]``);
* **batched multi-index reconstruction** — ``run_many`` groups
  same-bucket keysets and runs their extract+sort as one stacked call of
  the backend (``batched_extract_sort``), then builds each member; every
  member equals its own single ``run`` byte for byte.

``publish_to=<repro_torch.core.snapshot.SnapshotCell>`` freezes the
finished result into the cell as its next epoch, on every return path of
``run`` and ``run_incremental``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace as _dc_replace

import numpy as np
import torch

from repro_torch.backends import ExecutionBackend, get_backend

from .btree import BTree, BTreeConfig
from .keyformat import KeySet
from .metadata import DSMeta, meta_from_keys
from .sortkeys import word_comparison_counts
from .u32 import MASK32, sync_stream, to_carrier

__all__ = [
    "ReconstructionResult",
    "ReconstructionPipeline",
    "identity_meta",
    "fold_keyset",
]


@dataclass
class ReconstructionResult:
    """What a reconstruction returns: the tree, refreshed DS-metadata, the
    sorted compressed keys + rid permutation, and per-stage timings/stats.

    ``extract_bitmap`` is the D-bitmap the compressed keys were *actually*
    extracted under (the input metadata's bitmap — ``meta`` holds the
    refreshed bitmap, which may have shed bits).  ``run_incremental``
    merges against ``comp_sorted`` only when the current bitmap still
    equals it.
    """

    tree: BTree
    meta: DSMeta
    comp_sorted: torch.Tensor
    rid_sorted: torch.Tensor
    timings: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    row_sorted: torch.Tensor | None = None
    extract_bitmap: np.ndarray | None = None
    #: LSN watermark this result is current through (``None`` = not
    #: log-driven)
    watermark: int | None = None


def identity_meta(keyset: KeySet) -> DSMeta:
    """All-ones metadata: every bit position is a distinction bit — the
    full-key baseline (Figure 1 top flow) expressed as a degenerate plan."""
    return DSMeta(
        dbitmap=np.full((keyset.n_words,), 0xFFFFFFFF, np.uint32),
        varbitmap=np.full((keyset.n_words,), 0xFFFFFFFF, np.uint32),
        refkey=np.asarray(keyset.words[0], np.uint32),
        n_words=keyset.n_words,
    )


def fold_keyset(
    base: KeySet,
    keep_rows: np.ndarray | None = None,
    delta: KeySet | None = None,
) -> KeySet:
    """The folded table: surviving base rows, then delta rows appended.

    ``keep_rows`` is a (base.n,) bool mask over base *row positions*;
    ``delta`` rows keep their own rids.
    """
    words = np.asarray(base.words, np.uint32)
    lengths = np.asarray(base.lengths, np.int32)
    rids = np.asarray(base.rids, np.uint32)
    if keep_rows is not None:
        keep = np.asarray(keep_rows, bool)
        if keep.shape != (base.n,):
            raise ValueError(f"keep_rows must be ({base.n},), got {keep.shape}")
        words, lengths, rids = words[keep], lengths[keep], rids[keep]
    if delta is not None and delta.n:
        words = np.concatenate([words, np.asarray(delta.words, np.uint32)], axis=0)
        lengths = np.concatenate([lengths, np.asarray(delta.lengths, np.int32)])
        rids = np.concatenate([rids, np.asarray(delta.rids, np.uint32)])
    if words.shape[0] == 0:
        raise ValueError("folded keyset is empty (all rows deleted, no delta)")
    return KeySet(words=words, lengths=lengths, rids=rids)


class ReconstructionPipeline:
    """The scan → extract → sort → build → refresh flow, backend-dispatched.

    Parameters
    ----------
    backend:       a registered backend name (``"cuda"``, ``"torch"``,
                   ``"distributed"``) or an ``ExecutionBackend`` instance.
    config:        B-tree geometry.
    chunk_threshold: key counts above this take the chunked large-N sort:
                   ``chunk_size`` chunks, each sorted on its own, folded
                   by a binary-counter ladder of ``merge_sorted`` calls.
    chunk_size:    chunk length for the large-N path (power of two).
    async_dispatch: no wait for the card between stages, one at the end
                   of ``run``/``run_incremental``.  Stage timings then
                   measure the host's enqueue; ``stage_timings=True``
                   restores the barriers for one call.  Results are
                   identical either way.
    auto_tune_chunks: calibrate ``chunk_size``/``chunk_threshold`` from
                   measured sort and merge costs
                   (:func:`repro_torch.core.plancache.tune_chunking`) the
                   first time a run crosses the current threshold; the
                   :class:`~repro_torch.core.plancache.ChunkPlan` persists
                   on the pipeline.
    fused:         run extract+sort as one call when the backend supports
                   it (``supports_fused``); outputs are identical either way.
    device:        where the backend runs (CUDA unless named; ignored when
                   ``backend`` is an instance, which carries its own).
    backend_opts:  forwarded to the backend constructor when ``backend`` is
                   a name (e.g. ``{"capacity_factor": 2.0}`` for
                   ``"distributed"``).
    """

    def __init__(
        self,
        backend: str | ExecutionBackend = "cuda",
        config: BTreeConfig = BTreeConfig(),
        chunk_threshold: int = 1 << 19,
        chunk_size: int = 1 << 17,
        async_dispatch: bool = False,
        auto_tune_chunks: bool = False,
        fused: bool = False,
        device=None,
        backend_opts: dict | None = None,
    ) -> None:
        if isinstance(backend, ExecutionBackend):
            self.backend = backend
        else:
            self.backend = get_backend(backend, device=device, **(backend_opts or {}))
        self.device = self.backend.device
        self.config = config
        self.chunk_threshold = int(chunk_threshold)
        self.chunk_size = int(chunk_size)
        self.async_dispatch = bool(async_dispatch)
        self.auto_tune_chunks = bool(auto_tune_chunks)
        self.fused = bool(fused)
        self.chunk_plan = None
        self._last_cascade: dict = {}
        if self.chunk_size & (self.chunk_size - 1):
            raise ValueError(f"chunk_size must be a power of two, got {chunk_size}")

    # ------------------------------------------------------------- stages
    def extract(self, words: torch.Tensor, plan) -> torch.Tensor:
        """Stage 1 (§5.1): full keys -> compressed keys via the D-bitmap."""
        return self.backend.extract(words, plan)

    def sort(self, comp: torch.Tensor, rows: torch.Tensor, *,
             n_valid: int | None = None, keep_padded: bool = False):
        """Stage 2 (§5.2): parallel sort of (comp key, row) pairs."""
        return self.backend.sort(comp, rows, n_valid=n_valid, keep_padded=keep_padded)

    def build(self, comp_sorted, row_sorted, meta, words, lengths, rids,
              n_valid: int | None = None) -> BTree:
        """Stage 3 (§5.3): bottom-up bulk build (backend-dispatched)."""
        return self.backend.build(comp_sorted, row_sorted, meta, words, lengths,
                                  self.config, rids=rids, n_valid=n_valid)

    def refresh_meta(self, comp_sorted, meta: DSMeta, ref_key,
                     n_valid: int | None = None) -> DSMeta:
        """Stage 4 (§4.3): recompute DS-metadata at the opportune time."""
        return self.backend.refresh_meta(comp_sorted, meta, ref_key, n_valid=n_valid)

    def tune_chunking(self, **kwargs):
        """Measure this backend's sort and merge costs and adopt the
        resulting :class:`~repro_torch.core.plancache.ChunkPlan`
        (``chunk_size`` + ``chunk_threshold``).  Keyword args forward to
        :func:`repro_torch.core.plancache.tune_chunking`."""
        from . import plancache

        plan = plancache.tune_chunking(self.backend, **kwargs)
        self.chunk_size = plan.chunk_size
        self.chunk_threshold = plan.chunk_threshold
        self.chunk_plan = plan
        return plan

    def _sync(self) -> float:
        """Wait for the device; returns the blocked wall."""
        t0 = time.perf_counter()
        sync_stream(self.device)
        return time.perf_counter() - t0

    def _stage(self, sync: bool, fn, *args):
        """Run one stage, waiting for the device only when ``sync``;
        returns (out, wall).  Without the barrier the wall is the host's
        enqueue time."""
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            self._sync()
        return out, time.perf_counter() - t0

    def _sort_chunked(self, comp: torch.Tensor, n: int, b: int):
        """Large-N sort: bucket-aligned chunks + a binary-counter ladder of
        merges.

        Each chunk sorts with *local* rows (every chunk is one small
        bucket and keeps the [0, m) row contract); the chunk offset is
        added afterwards, which keeps the sorted (key, row) order because
        it is monotone within the chunk.  The offset also lands on the pad
        rows (``ROW_PAD_A + lane``); the sum stays below 2**32 because
        ``offset + lane < 2**31``, and it is masked to 32 bits all the
        same, as the reference's uint32 sum wraps.

        The fold is a binary counter: a run of 2^k merged chunks merges
        with its equal-sized neighbour the moment that neighbour
        completes, so at most O(log n_chunks) runs are live at once
        (``cascade_peak_live_runs``), and popping merged runs off the
        stack drops their last references.  A merge of sorted runs under
        the total (key, row) order has exactly one output, so any
        association of merges equals one monolithic sort byte for byte.

        Runs stay bucket-padded end to end (``keep_padded`` + ``n_valid``
        chaining); one final ``pad_tail`` aligns the cascade total to the
        build bucket ``b``.  Returns ``(b,)``-padded buffers.
        """
        from . import plancache

        c = self.chunk_size
        # stack of live runs: (chunks_merged, n_valid, keys, rows); the
        # chunk counts are strictly decreasing, adjacent equals merge
        stack: list = []
        peak = 0
        merges = 0

        def _merge_top():
            nonlocal merges
            cb, nvb, kb, rb = stack.pop()
            ca, nva, ka, ra = stack.pop()
            mk, mr = self.backend.merge_sorted(ka, ra, kb, rb, n_valid_a=nva,
                                               n_valid_b=nvb, keep_padded=True)
            stack.append((ca + cb, nva + nvb, mk, mr))
            merges += 1

        for s in range(0, n, c):
            m = min(c, n - s)
            chunk = comp[s : s + c]
            ck, cr = self.backend.sort(chunk, plancache.iota(int(chunk.shape[0]), comp.device),
                                       n_valid=m, keep_padded=True)
            stack.append((1, m, ck, (cr + s) & MASK32))
            peak = max(peak, len(stack))
            while len(stack) >= 2 and stack[-1][0] == stack[-2][0]:
                _merge_top()
        while len(stack) > 1:  # fold the leftover ragged tail, smallest first
            _merge_top()
        _, _, ks, rs = stack[0]
        self._last_cascade = {
            "cascade_peak_live_runs": peak,
            "cascade_merges": merges,
        }
        # pad content is irrelevant: downstream stages read n_valid lanes
        ks = plancache.pad_tail(ks, b, plancache.SENTINEL)
        rs = plancache.pad_tail(rs, b, 0)
        return ks, rs

    # ---------------------------------------------------------------- run
    def run(
        self,
        keyset: KeySet,
        meta: DSMeta | None = None,
        full_keys: bool = False,
        watermark: int | None = None,
        publish_to=None,
        stage_timings: bool | None = None,
    ) -> ReconstructionResult:
        """Reconstruct one index.

        ``full_keys=True`` runs the uncompressed baseline (Figure 1 top
        flow): identity metadata, extraction skipped, the sort sees the full
        key width.  DS-metadata is then left as-is (the baseline has none to
        refresh).  ``watermark`` stamps the result with the LSN it is
        current through.  ``publish_to`` (a
        :class:`~repro_torch.core.snapshot.SnapshotCell`) receives the
        result as its next epoch.  ``stage_timings`` overrides the pipeline's
        sync policy for this call: ``True`` restores the per-stage
        barriers even under ``async_dispatch``; ``False`` forces one
        end-of-run sync.  Either way ``timings["sync"]`` reports the final
        barrier's wall.
        """
        from . import plancache

        t_run0 = time.perf_counter()
        sync = stage_timings if stage_timings is not None else not self.async_dispatch
        n = keyset.n
        dev = self.device
        rids = to_carrier(keyset.rids, dev)
        lengths = torch.as_tensor(np.asarray(keyset.lengths), device=dev)
        # enter the bucket world once: the full keys padded to the sort
        # bucket, the iota as the row ids; pad content is irrelevant from
        # here on (the sort renormalizes its pads from the valid count)
        b = plancache.bucket_for("sort", n)
        words_dev = plancache.pad_tail(to_carrier(keyset.words, dev), b, plancache.SENTINEL)
        rows_dev = plancache.iota(b, dev)

        t_meta = 0.0
        if full_keys:
            meta = identity_meta(keyset)
        elif meta is None:
            t0 = time.perf_counter()
            meta = meta_from_keys(keyset.words, dev, dbitmap_fn=self.backend.dbitmap_fn)
            t_meta = time.perf_counter() - t0
        plan = meta.plan()

        if (self.auto_tune_chunks and self.chunk_plan is None
                and n > self.chunk_threshold):
            self.tune_chunking()

        chunks = 0
        fused_used = (self.fused and self.backend.supports_fused and not full_keys
                      and n <= self.chunk_threshold)
        if fused_used:
            t_extract = 0.0
            (comp_sorted_p, row_sorted_p), t_sort = self._stage(
                sync, lambda: self.backend.fused_extract_sort(
                    words_dev, plan, rows_dev, n_valid=n, keep_padded=True))
        else:
            if full_keys:
                comp, t_extract = words_dev, 0.0
            else:
                comp, t_extract = self._stage(sync, self.extract, words_dev, plan)
            if n > self.chunk_threshold:
                # large-N path: extraction stays one bucket-shaped pass; the
                # sort splits into chunk sorts + the merge ladder
                chunks = -(-n // self.chunk_size)
                (comp_sorted_p, row_sorted_p), t_sort = self._stage(
                    sync, lambda: self._sort_chunked(comp, n, b))
            else:
                (comp_sorted_p, row_sorted_p), t_sort = self._stage(
                    sync, lambda: self.sort(comp, rows_dev, n_valid=n, keep_padded=True))
            del comp
        comp_sorted = comp_sorted_p[:n]
        row_sorted = row_sorted_p[:n]
        rid_sorted = rids[row_sorted]

        # -- build (the padded buffers chain straight in; n_valid carries
        # -- the real count) ----------------------------------------------
        tree, t_build = self._stage(
            sync, lambda: self.build(comp_sorted_p, row_sorted_p, meta, words_dev,
                                     lengths, rids, n_valid=n))

        # -- refresh DS-metadata (opportune time, §4.3); it ends on the
        # -- host, so it is complete when it returns -----------------------
        t_refresh = 0.0
        new_meta = meta
        if not full_keys:
            t0 = time.perf_counter()
            new_meta = self.refresh_meta(comp_sorted_p, meta, keyset.words[0], n_valid=n)
            t_refresh = time.perf_counter() - t0

        t_sync = 0.0 if sync else self._sync()
        timings = {
            "meta": t_meta,
            "extract": t_extract,
            "sort": t_sort,
            "build": t_build,
            "refresh_meta": t_refresh,
            "sync": t_sync,
            "total": (t_extract + t_sort + t_build) if sync
            else time.perf_counter() - t_run0,
        }
        stats = self._stats(keyset, meta, comp_sorted, row_sorted, tree, fused_used)
        stats["chunked"] = chunks
        stats["async_dispatch"] = not sync
        stats["chunk_size"] = self.chunk_size
        stats["chunk_threshold"] = self.chunk_threshold
        stats["chunk_tuned"] = self.chunk_plan is not None
        if chunks:
            stats.update(self._last_cascade)
        res = ReconstructionResult(
            tree=tree,
            meta=new_meta,
            comp_sorted=comp_sorted,
            rid_sorted=rid_sorted,
            timings=timings,
            stats=stats,
            row_sorted=row_sorted,
            extract_bitmap=np.array(meta.dbitmap, np.uint32, copy=True),
            watermark=watermark,
        )
        if publish_to is not None:
            publish_to.publish(res)
        return res

    # -------------------------------------------------- incremental (delta)
    def run_incremental(
        self,
        prev: ReconstructionResult,
        base_keyset: KeySet,
        delta_keyset: KeySet | None = None,
        *,
        keep_rows: np.ndarray | None = None,
        meta: DSMeta | None = None,
        watermark: int | None = None,
        publish_to=None,
        stage_timings: bool | None = None,
    ) -> tuple[ReconstructionResult, KeySet]:
        """Fold a change set into ``prev`` without re-sorting the base.

        ``base_keyset`` must be the keyset ``prev`` was reconstructed from;
        ``keep_rows`` masks deleted base row positions; ``delta_keyset``
        holds inserted rows (appended after the surviving base rows, which
        is exactly the row numbering a full ``run`` over the folded keyset
        sees).  ``meta`` is the *current* DS-metadata (defaults to
        ``prev.meta``).

        Returns ``(result, folded_keyset)``.  The result is byte-identical —
        sorted compressed keys, rid permutation, tree levels — to
        ``self.run(folded_keyset, meta=meta)``:

        * surviving base rows keep their relative (key, row) order because
          deletion renumbers rows monotonically;
        * the delta is extracted and sorted through the normal backend
          stages, with row ids offset past the surviving base rows;
        * ``backend.merge_sorted`` interleaves the two runs under the same
          (key, row) contract the sort stage obeys.

        Falls back to the full path (``stats["incremental"] = False``, the
        reason in ``stats["incremental_fallback"]``) when ``prev`` carries
        no extraction bitmap or the D-bitmap changed since ``prev``'s
        extraction (the compressed projection moved).  An *empty* change
        set under unchanged metadata returns ``prev`` re-stamped at
        ``watermark`` without touching the device (``stats["noop"]``).
        ``publish_to`` publishes the result — whichever path produced it,
        fallback and no-op included.
        """
        if meta is None:
            meta = prev.meta
        folded = fold_keyset(base_keyset, keep_rows, delta_keyset)
        n_delta = 0 if delta_keyset is None else delta_keyset.n

        fallback = None
        if prev.extract_bitmap is None:
            fallback = "no_extract_bitmap"
        elif not np.array_equal(np.asarray(meta.dbitmap, np.uint32), prev.extract_bitmap):
            fallback = "dbitmap_changed"
        t_run0 = time.perf_counter()
        sync = stage_timings if stage_timings is not None else not self.async_dispatch
        if fallback is not None:
            res = self.run(folded, meta=meta, watermark=watermark,
                           stage_timings=stage_timings)
            res.stats["incremental"] = False
            res.stats["incremental_fallback"] = fallback
            if publish_to is not None:
                publish_to.publish(res)
            return res, folded

        # -- empty change set: advance the watermark, skip the rebuild -----
        if (
            n_delta == 0
            and (keep_rows is None or bool(np.asarray(keep_rows, bool).all()))
            and (meta is prev.meta or np.array_equal(meta.varbitmap, prev.meta.varbitmap))
        ):
            stats = dict(prev.stats)
            stats.update(incremental=True, noop=True, n_delta=0, n_deleted=0)
            stats.pop("incremental_fallback", None)
            timings = {
                k: 0.0
                for k in ("meta", "filter", "extract", "sort", "merge",
                          "build", "refresh_meta", "sync", "total")
            }
            res = _dc_replace(prev, timings=timings, stats=stats, watermark=watermark)
            if publish_to is not None:
                publish_to.publish(res)
            return res, folded

        from . import plancache

        dev = self.device
        plan = meta.plan()

        # -- filter the surviving base run (a device-side mask, no re-sort;
        # -- the boolean index syncs with the host for its size) -----------
        def _filter():
            if keep_rows is None:
                return prev.comp_sorted, prev.row_sorted
            keep = torch.as_tensor(np.asarray(keep_rows, bool), device=dev)
            keep_sorted = keep[prev.row_sorted]
            # deletion renumbers surviving rows monotonically, so the kept
            # run stays ascending in (key, new row)
            new_row = torch.cumsum(keep.to(torch.int64), 0) - 1
            return prev.comp_sorted[keep_sorted], new_row[prev.row_sorted][keep_sorted]

        (base_comp, base_rows), t_filter = self._stage(sync, _filter)
        n_kept = int(base_comp.shape[0])

        # -- extract + sort only the delta ---------------------------------
        t_extract = t_sort = 0.0
        if n_delta:
            delta_words = to_carrier(delta_keyset.words, dev)
            comp_delta, t_extract = self._stage(sync, self.extract, delta_words, plan)
            (comp_delta_sorted, rows_delta), t_sort = self._stage(
                sync, lambda: self.sort(comp_delta, plancache.iota(n_delta, dev)))
            # delta rows live after every surviving base row in the folded
            # numbering; the offset keeps the sorted (key, row) order
            rows_delta = rows_delta + n_kept
        else:
            comp_delta_sorted = base_comp.new_zeros((0, int(base_comp.shape[1])))
            rows_delta = base_rows.new_zeros((0,))

        # -- merge the runs (the backend op) -------------------------------
        (comp_sorted, row_sorted), t_merge = self._stage(
            sync, self.backend.merge_sorted, base_comp, base_rows,
            comp_delta_sorted, rows_delta)
        rids = to_carrier(folded.rids, dev)
        rid_sorted = rids[row_sorted]

        # -- build + refresh (identical to the full path) ------------------
        words = to_carrier(folded.words, dev)
        lengths = torch.as_tensor(np.asarray(folded.lengths), device=dev)
        tree, t_build = self._stage(sync, self.build, comp_sorted, row_sorted, meta,
                                    words, lengths, rids)
        t0 = time.perf_counter()
        new_meta = self.refresh_meta(comp_sorted, meta, folded.words[0])
        t_refresh = time.perf_counter() - t0

        t_sync = 0.0 if sync else self._sync()
        timings = {
            "meta": 0.0,
            "filter": t_filter,
            "extract": t_extract,
            "sort": t_sort,
            "merge": t_merge,
            "build": t_build,
            "refresh_meta": t_refresh,
            "sync": t_sync,
            "total": (t_filter + t_extract + t_sort + t_merge + t_build)
            if sync else time.perf_counter() - t_run0,
        }
        stats = self._stats(folded, meta, comp_sorted, row_sorted, tree)
        stats["incremental"] = True
        stats["n_delta"] = n_delta
        stats["n_deleted"] = base_keyset.n - n_kept
        stats["async_dispatch"] = not sync
        res = ReconstructionResult(
            tree=tree,
            meta=new_meta,
            comp_sorted=comp_sorted,
            rid_sorted=rid_sorted,
            timings=timings,
            stats=stats,
            row_sorted=row_sorted,
            extract_bitmap=np.array(meta.dbitmap, np.uint32, copy=True),
            watermark=watermark,
        )
        if publish_to is not None:
            publish_to.publish(res)
        return res, folded

    # ----------------------------------------------------- batched (many)
    def run_many(
        self,
        keysets: list[KeySet],
        metas: list[DSMeta | None] | None = None,
    ) -> list[ReconstructionResult]:
        """Reconstruct many independent indexes (the replication scenario).

        The metadata comes first (it fixes the compressed width); keysets
        that share ``(bucket_for("run_many", n), n_words, Wc)`` form a
        group whose extract+sort is one stacked ``batched_extract_sort``
        call, then each member is built and refreshed on its own
        (``stats["batched"]`` = the group's size).  A group of one, and
        every keyset on a backend without ``supports_batched``, takes
        ``run``.  Each result equals the member's own ``run`` byte for
        byte.
        """
        if metas is None:
            metas = [None] * len(keysets)
        if len(metas) != len(keysets):
            raise ValueError("metas must align with keysets")
        if not self.backend.supports_batched:
            return [self.run(ks, meta=m) for ks, m in zip(keysets, metas)]

        from . import plancache

        t0 = time.perf_counter()
        metas = [
            m if m is not None
            else meta_from_keys(ks.words, self.device, dbitmap_fn=self.backend.dbitmap_fn)
            for ks, m in zip(keysets, metas)
        ]
        t_meta = (time.perf_counter() - t0) / max(len(keysets), 1)
        groups: dict[tuple[int, int, int], list[int]] = {}
        for i, (ks, m) in enumerate(zip(keysets, metas)):
            key = (plancache.bucket_for("run_many", ks.n), ks.n_words, m.plan().n_words_out)
            groups.setdefault(key, []).append(i)

        results: list = [None] * len(keysets)
        for idxs in groups.values():
            if len(idxs) < 2:
                for i in idxs:
                    results[i] = self.run(keysets[i], meta=metas[i])
                continue
            batched = self._run_batched([keysets[i] for i in idxs],
                                        [metas[i] for i in idxs], t_meta)
            for i, res in zip(idxs, batched):
                results[i] = res
        return results

    def _run_batched(self, keysets, metas, t_meta) -> list[ReconstructionResult]:
        """One group of ``run_many``: members padded to the shared bucket
        with all-ones keys (they extract to the maximal compressed
        pattern) and reserved row ids (``plancache.pad_run``), so each
        member's pads sort strictly last and its first ``n`` rows are its
        own single run."""
        from . import plancache

        k, dev = len(keysets), self.device
        plans = [m.plan() for m in metas]
        b = plancache.bucket_for("run_many", max(ks.n for ks in keysets))
        padded = [plancache.pad_run(to_carrier(ks.words, dev), plancache.iota(ks.n, dev), b)
                  for ks in keysets]
        words = torch.stack([w for w, _ in padded])
        rows = torch.stack([r for _, r in padded])
        del padded
        bitmaps = torch.stack([to_carrier(m.dbitmap, dev) for m in metas])
        (comp_sorted, row_sorted), t_xs = self._stage(
            True, self.backend.batched_extract_sort, words, bitmaps, rows, plans)

        out = []
        for i, (ks, meta) in enumerate(zip(keysets, metas)):
            cs, rs = comp_sorted[i, : ks.n], row_sorted[i, : ks.n]
            rids = to_carrier(ks.rids, dev)
            lengths = torch.as_tensor(np.asarray(ks.lengths), device=dev)
            tree, t_build = self._stage(True, self.build, cs, rs, meta, words[i, : ks.n],
                                        lengths, rids)
            t0 = time.perf_counter()
            new_meta = self.refresh_meta(cs, meta, ks.words[0])
            t_refresh = time.perf_counter() - t0
            timings = {
                "meta": t_meta,
                "extract": 0.0,
                "sort": t_xs / k,
                "build": t_build,
                "refresh_meta": t_refresh,
                "total": t_xs / k + t_build,
            }
            # "batched" carries the batching fact; "fused" stays the
            # backend's fused_extract_sort path
            stats = self._stats(ks, meta, cs, rs, tree, fused_used=False)
            stats["batched"] = k
            out.append(ReconstructionResult(
                tree=tree,
                meta=new_meta,
                comp_sorted=cs,
                rid_sorted=rids[rs],
                timings=timings,
                stats=stats,
                row_sorted=rs,
                extract_bitmap=np.array(meta.dbitmap, np.uint32, copy=True),
            ))
        return out

    def _stats(self, keyset, meta, comp_sorted, row_sorted, tree, fused_used=False):
        full_bits = keyset.n_bits
        # wcc over the *row*-permuted full keys (the tree's sorted_full):
        # row_sorted indexes rows of the table; rids are labels, not positions
        full_sorted = tree.sorted_full
        wc = int(comp_sorted.shape[1])
        stats = {
            "backend": self.backend.name,
            "device": str(self.device),
            "fused": fused_used,
            "n_keys": keyset.n,
            "full_key_bits": full_bits,
            "distinction_bits": meta.n_dbits,
            "compression_ratio": full_bits / max(meta.n_dbits, 1),
            "full_sort_key_words": keyset.n_words + 1,  # + rid word
            "comp_sort_key_words": wc + 1,
            "sort_key_ratio": (keyset.n_words + 1) / (wc + 1),
            "wcc_full": word_comparison_counts(full_sorted),
            "wcc_comp": word_comparison_counts(comp_sorted),
            "tree_height": tree.height,
            "tree_bytes": tree.memory_bytes(),
        }
        stats["word_comparison_ratio"] = stats["wcc_full"] / max(stats["wcc_comp"], 1e-9)
        stats.update(self.backend.last_info)
        return stats
