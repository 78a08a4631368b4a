"""Unified reconstruction pipeline (paper §5, Figure 7) over pluggable backends.

    table (memory-resident) --scan--> extract compressed keys + rids
        --parallel sort--> sorted (comp key, rid) pairs
        --bottom-up build--> partial-key B+tree
        (+ recompute DS-metadata for next time, §4.3)

One pipeline, four explicit stages — ``extract``, ``sort``, ``build``,
``refresh_meta`` — with per-stage wall timings (the paper's Figure 9
breakdown) and per-run stats.  The stages dispatch to an
``ExecutionBackend`` (``repro_torch.backends``): ``torch`` (the plain
oracle) or ``cuda`` (the hand-written kernels).  Every stage ends in a
device synchronize, so each timing covers the stage's device work.

This slice of the port covers ``run`` for key sets up to
``chunk_threshold``; the chunked large-N sort, ``run_incremental`` and
``run_many`` raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.backends import ExecutionBackend, get_backend
from repro_torch.backends.base import not_ported

from .btree import BTree, BTreeConfig
from .keyformat import KeySet
from .metadata import DSMeta, meta_from_keys
from .sortkeys import word_comparison_counts
from .u32 import to_carrier

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
    refreshed bitmap, which may have shed bits).
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
    backend:       a registered backend name (``"cuda"``, ``"torch"``) or
                   an ``ExecutionBackend`` instance.
    config:        B-tree geometry.
    chunk_threshold: the largest key count a run takes; above it the
                   reference switches to its chunked sort, which the port
                   has not reached yet, so a larger run raises.
    device:        where the backend runs (CUDA unless named; ignored when
                   ``backend`` is an instance, which carries its own).
    """

    def __init__(
        self,
        backend: str | ExecutionBackend = "cuda",
        config: BTreeConfig = BTreeConfig(),
        chunk_threshold: int = 1 << 19,
        device=None,
    ) -> None:
        if isinstance(backend, ExecutionBackend):
            self.backend = backend
        else:
            self.backend = get_backend(backend, device=device)
        self.device = self.backend.device
        self.config = config
        self.chunk_threshold = int(chunk_threshold)

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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, fn, *args):
        """Run one stage to completion on the device; returns (out, wall)."""
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        return out, time.perf_counter() - t0

    # ---------------------------------------------------------------- run
    def run(
        self,
        keyset: KeySet,
        meta: DSMeta | None = None,
        full_keys: bool = False,
        watermark: int | None = None,
    ) -> ReconstructionResult:
        """Reconstruct one index.

        ``full_keys=True`` runs the uncompressed baseline (Figure 1 top
        flow): identity metadata, extraction skipped, the sort sees the full
        key width.  DS-metadata is then left as-is (the baseline has none to
        refresh).  ``watermark`` stamps the result with the LSN it is
        current through.
        """
        from . import plancache

        n = keyset.n
        if n > self.chunk_threshold:
            raise not_ported(
                f"the chunked sort of {n} keys (chunk_threshold "
                f"{self.chunk_threshold})", "Queue 1 item 5",
            )
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
            meta = meta_from_keys(keyset.words, dev)
            t_meta = time.perf_counter() - t0
        plan = meta.plan()

        if full_keys:
            t_extract = 0.0
            (comp_sorted_p, row_sorted_p), t_sort = self._stage(
                lambda: self.sort(words_dev, rows_dev, n_valid=n, keep_padded=True)
            )
        else:
            comp, t_extract = self._stage(self.extract, words_dev, plan)
            (comp_sorted_p, row_sorted_p), t_sort = self._stage(
                lambda: self.sort(comp, rows_dev, n_valid=n, keep_padded=True)
            )
            del comp
        comp_sorted = comp_sorted_p[:n]
        row_sorted = row_sorted_p[:n]
        rid_sorted = rids[row_sorted]

        # -- build (the padded buffers chain straight in; n_valid carries
        # -- the real count) ----------------------------------------------
        tree, t_build = self._stage(
            lambda: self.build(comp_sorted_p, row_sorted_p, meta, words_dev,
                               lengths, rids, n_valid=n)
        )

        # -- refresh DS-metadata (opportune time, §4.3) --------------------
        t_refresh = 0.0
        new_meta = meta
        if not full_keys:
            new_meta, t_refresh = self._stage(
                lambda: self.refresh_meta(comp_sorted_p, meta, keyset.words[0], n_valid=n)
            )

        timings = {
            "meta": t_meta,
            "extract": t_extract,
            "sort": t_sort,
            "build": t_build,
            "refresh_meta": t_refresh,
            "total": t_extract + t_sort + t_build,
        }
        stats = self._stats(keyset, meta, comp_sorted, row_sorted, tree)
        stats["chunked"] = 0
        stats["chunk_threshold"] = self.chunk_threshold
        return ReconstructionResult(
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

    def run_incremental(self, *args, **kwargs):
        """Fold a change set into a previous result — not ported yet."""
        raise not_ported("run_incremental", "Queue 1 item 5")

    def run_many(self, *args, **kwargs):
        """Batched multi-index reconstruction — not ported yet."""
        raise not_ported("run_many", "Queue 1 item 9")

    def _stats(self, keyset, meta, comp_sorted, row_sorted, tree):
        full_bits = keyset.n_bits
        # wcc over the *row*-permuted full keys (the tree's sorted_full):
        # row_sorted indexes rows of the table; rids are labels, not positions
        full_sorted = tree.sorted_full
        wc = int(comp_sorted.shape[1])
        stats = {
            "backend": self.backend.name,
            "device": str(self.device),
            "fused": False,
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
