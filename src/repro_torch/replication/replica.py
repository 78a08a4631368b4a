"""A replica that consumes change-log batches and rebuilds incrementally.

The semantics are the reference's ``replication/replica.py``, state for
state: the same bring-up, the same folds, the same DS-metadata after
every batch, byte for byte.

The paper's replication premise: the wire carries the table (here: the base
keyset once, then ``ChangeLog`` batches) and the DS-metadata — never an
index image.  ``Replica`` keeps the reconstructed index current by folding
each log batch through ``ReconstructionPipeline.run_incremental``: delete
entries become a keep-mask over the base rows, surviving inserts become the
delta keyset, and only the delta is extracted and sorted before the backend
``merge_sorted`` splices it into the standing run.  When a batch's keys add
new distinction bits the pipeline transparently falls back to the full
rebuild (same result, full cost) — the replica's answer is byte-identical
either way.

DS-metadata upkeep is the §4.3 insert rule, vectorized: every inserted key
finds its neighbors (A, B) in the standing sorted order with one batched
rank search, and D(A,K) / D(K,B) are OR-scattered into the D-bitmap in one
shot.  Setting both is exactly the paper's "set max(D(A,K), D(K,B))"
because the min equals D(A,B), which Lemma 1 guarantees is already set.
Delta-internal adjacency is covered by the delta's own D-bitmap.

On ``"cuda"`` the rank search is the merge-rank kernel (the backend's
``rank_fn``) and the delta's D-bitmap the dbit kernel's bitmap form (its
``dbitmap_fn``).  The searched run is the tree's sorted full keys with
their row ids, which is strictly ascending in (key, row) even where keys
repeat; each query carries row 0, so its rank counts the keys strictly
below it, as the reference's strict-key rank does.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.btree import BTreeConfig
from repro_torch.core.dbits import (
    NO_DBIT,
    compute_dbitmap,
    dbit_position_pairwise,
    positions_to_bitmap,
)
from repro_torch.core.keyformat import KeySet  # noqa: F401  (public API type)
from repro_torch.core.metadata import DSMeta, shed_or_pin
from repro_torch.core.pipeline import ReconstructionPipeline, ReconstructionResult
from repro_torch.core.snapshot import SnapshotCell
from repro_torch.core.u32 import to_carrier, to_u32
from repro_torch.kernels.merge import merge_ranks_plain

from .log import ChangeLog

__all__ = ["Replica"]


class Replica:
    """One replicated index: base bring-up + incremental log consumption.

    Parameters
    ----------
    keyset:             the base table rows (bring-up reconstructs from it).
    meta:               DS-metadata to extract under; ``None`` derives it
                        from the keys.  A catch-up bootstrap passes the
                        checkpointed *working* metadata here, which is what
                        makes the bootstrapped state byte-identical to a
                        never-lagged replica's (see ``stream.StreamReplica``).
    backend:            execution backend name for all rebuilds
                        (``"cuda"`` or ``"torch"``).
    config:             B-tree geometry.
    device:             where the index lives and rebuilds run (CUDA unless
                        named).
    shed_delete_frac:   bitmap shed threshold (``None`` = always pin).
    applied_lsn:        LSN watermark this base state is current through
                        (``-1`` = nothing applied; a bootstrap resumes at
                        the checkpoint's watermark).
    deletes_since_shed: resume value for the shed-policy volume counter.
    snapshot_epoch:     epoch the bring-up snapshot is published at (a
                        checkpoint bootstrap resumes the primary's
                        numbering; the default starts at 0).
    """

    def __init__(
        self,
        keyset: KeySet,
        meta: DSMeta | None = None,
        backend: str = "cuda",
        config: BTreeConfig = BTreeConfig(),
        device=None,
        shed_delete_frac: float | None = None,
        applied_lsn: int = -1,
        deletes_since_shed: int = 0,
        snapshot_epoch: int = 0,
    ) -> None:
        self.pipeline = ReconstructionPipeline(backend=backend, config=config, device=device)
        self.device = self.pipeline.device
        self.keyset = keyset
        # the versioned read path: every rebuild publishes the next epoch
        # here and every search pins the current one (double buffering)
        self.snapshots = SnapshotCell(start_epoch=int(snapshot_epoch) - 1)
        self.result: ReconstructionResult = self.pipeline.run(
            keyset, meta=meta, watermark=applied_lsn if applied_lsn >= 0 else None,
            publish_to=self.snapshots,
        )
        # the working metadata mirrors the *extraction* bitmap (plus insert
        # bits as batches arrive): keeping it pinned to what comp_sorted was
        # extracted under is what lets consecutive batches stay incremental
        self._meta = replace(
            self.result.meta,
            dbitmap=np.array(self.result.extract_bitmap, np.uint32, copy=True),
        )
        # bitmap shed policy: pinning keeps rebuilds incremental but lets
        # delete-stale distinction bits accumulate (wider compressed keys).
        # When the delete volume since the bits were last re-derived crosses
        # ``shed_delete_frac`` of the index size, adopt the refreshed
        # (shed) bitmap instead — the next batch pays one full resort under
        # the narrower projection, then pinning resumes.  ``None`` never
        # sheds.
        self.shed_delete_frac = shed_delete_frac
        self._deletes_since_shed = int(deletes_since_shed)
        self.applied_lsn = int(applied_lsn)
        self.n_applied_batches = 0

    @property
    def tree(self):
        """The standing partial-key B+tree (current reconstruction)."""
        return self.result.tree

    @property
    def meta(self) -> DSMeta:
        """The working DS-metadata (pinned/shed per the bitmap policy)."""
        return self._meta

    @property
    def deletes_since_shed(self) -> int:
        """Delete volume since the D-bitmap was last re-derived (shed
        policy bookkeeping; snapshotted into checkpoint frames)."""
        return self._deletes_since_shed

    @property
    def stats(self) -> dict:
        """Health snapshot of the standing index: watermark, size, shed
        bookkeeping, snapshot epoch — the inner-replica half of the
        counters a stream consumer (or its supervisor) surfaces."""
        return {
            "applied_lsn": self.applied_lsn,
            "n_applied_batches": self.n_applied_batches,
            "n_keys": self.keyset.n,
            "watermark": self.result.watermark,
            "deletes_since_shed": self._deletes_since_shed,
            "shed_delete_frac": self.shed_delete_frac,
            "snapshot_epoch": self.snapshots.epoch,
        }

    # ------------------------------------------------------------- lookup
    def search_batch(
        self, query_words: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookup: (q, W) keys -> ((q,) found, (q,) rid).

        Pins the current snapshot epoch and probes it with the backend's
        ``lookup`` op (on ``"cuda"`` the probe kernel's leaf stage) — a
        query stream interleaved with ``apply`` keeps answering from the
        pre-rebuild epoch until the new one is published, never a torn
        mixture.  Miss lanes carry ``repro_torch.core.btree.NOT_FOUND_RID``.
        """
        q = to_carrier(
            np.asarray(query_words, np.uint32).reshape(-1, self.keyset.n_words),
            self.device,
        )
        with self.snapshots.pin() as snap:
            found, rid = self.pipeline.backend.lookup(snap.tree, q)
        return found.cpu().numpy().astype(bool), to_u32(rid)

    def search(self, query_words: np.ndarray) -> tuple[bool, int]:
        """Point lookup through the pinned snapshot: ``(found, rid)``.

        A thin wrapper over :meth:`search_batch` (one implementation for
        scalar and batched lookups).
        """
        found, rid = self.search_batch(
            np.asarray(query_words, np.uint32)[None, :]
        )
        return bool(found[0]), int(rid[0])

    # -------------------------------------------------------------- apply
    def apply_many(self, logs: "list[ChangeLog]") -> dict:
        """Fold several LSN-contiguous batches through ONE rebuild.

        The watermark-triggered form of ``apply``: a consumer that drained
        multiple pending stream batches stitches them (``ChangeLog.concat``
        checks contiguity) and pays one fold + one incremental
        reconstruction for the whole span, instead of one rebuild per
        batch.  Returns the same stats dict as ``apply``.

        As in the reference, the insert rule then finds every insert's
        neighbors in the tree as it stood before the whole span, so the
        D-bitmap (and with it ``comp_sorted``) can differ from that of a
        replica that applied the same batches one by one; both bitmaps
        hold every true distinction bit (Theorem 2), so lookups agree.
        """
        return self.apply(ChangeLog.concat(logs))

    def apply(self, log: ChangeLog) -> dict:
        """Fold one log batch into the standing index.

        Deletes become a keep-mask over the base rows, surviving inserts
        the delta keyset; DS-metadata advances by the vectorized §4.3
        insert rule *before* the rebuild so the extraction plan covers the
        batch.  The rebuild runs ``ReconstructionPipeline.run_incremental``
        — byte-identical to a full ``run`` over the folded keyset (empty
        batches short-circuit through the pipeline's no-op fast path and
        only advance the watermark).  Returns apply stats: which path ran
        (``incremental`` / ``fallback`` / ``noop``), churn counts, shed
        policy state, the new ``applied_lsn``, and per-stage timings.
        """
        if log.n_words != self.keyset.n_words:
            raise ValueError(
                f"log key width {log.n_words} != index width {self.keyset.n_words}"
            )
        keep_rows, delta = log.fold_keyset(self.keyset)
        n_delta = 0 if delta is None else delta.n
        n_deleted = 0 if keep_rows is None else int(self.keyset.n - keep_rows.sum())
        meta = self._insert_rule(delta.words) if n_delta else self._meta

        res, folded = self.pipeline.run_incremental(
            self.result, self.keyset, delta, keep_rows=keep_rows, meta=meta,
            watermark=log.next_lsn - 1, publish_to=self.snapshots,
        )
        self.keyset, self.result = folded, res
        self._meta, shed, self._deletes_since_shed = shed_or_pin(
            res.meta, res.extract_bitmap,
            self._deletes_since_shed + n_deleted,
            self.shed_delete_frac, folded.n,
        )
        self.applied_lsn = log.next_lsn - 1
        self.n_applied_batches += 1
        return {
            "incremental": bool(res.stats.get("incremental")),
            "fallback": res.stats.get("incremental_fallback"),
            "noop": bool(res.stats.get("noop", False)),
            "n_delta": n_delta,
            "n_deleted": n_deleted,
            "n_keys": folded.n,
            "shed_bits": shed,
            "deletes_since_shed": self._deletes_since_shed,
            "applied_lsn": self.applied_lsn,
            "timings": dict(res.timings),
        }

    # ------------------------------------------------------- shed adoption
    def adopt_shed(self) -> bool:
        """Adopt the refreshed (shed) D-bitmap of the last rebuild *now*.

        The stream-driven form of the shed policy: instead of evaluating
        ``shed_delete_frac`` locally (whose per-rebuild cadence diverges
        between replicas that poll at different rates), a consumer adopts
        sheds exactly where the primary logged them — the shed control
        frame in the stream names the watermark, and this call flips the
        working metadata from the pinned extraction bitmap to the
        refreshed one, so the next rebuild pays the one full resort under
        the narrower projection just as the primary's did.  Returns
        whether the bitmap actually changed (idempotent on a replica that
        already shed locally).
        """
        refreshed = self.result.meta
        changed = not np.array_equal(
            np.asarray(self._meta.dbitmap, np.uint32),
            np.asarray(refreshed.dbitmap, np.uint32),
        )
        self._meta = refreshed
        self._deletes_since_shed = 0
        return changed

    # ---------------------------------------------------- metadata upkeep
    def _insert_rule(self, ins_words: np.ndarray) -> DSMeta:
        """§4.3 insert rule for a whole batch, no host loop."""
        meta = self._meta
        backend = self.pipeline.backend
        sf = self.result.tree.sorted_full  # standing sorted full keys
        rows_s = self.result.row_sorted  # their rows: (sf, rows) ascends strictly
        n = int(sf.shape[0])
        k = to_carrier(np.asarray(ins_words, np.uint32), self.device)
        m = int(k.shape[0])
        zeros_q = torch.zeros((m,), dtype=torch.int64, device=self.device)
        rank_fn = backend.rank_fn or merge_ranks_plain
        rank = rank_fn(k, zeros_q, sf, rows_s).to(torch.int64)
        has_a = rank > 0
        has_b = rank < n
        a = sf[(rank - 1).clamp(0, n - 1)]
        b = sf[rank.clamp(0, n - 1)]
        no_dbit = torch.full((m,), NO_DBIT, dtype=torch.int64, device=self.device)
        d_ak = torch.where(has_a, dbit_position_pairwise(a, k), no_dbit)
        d_kb = torch.where(has_b, dbit_position_pairwise(k, b), no_dbit)
        nw = meta.n_words
        bm = positions_to_bitmap(torch.cat([d_ak, d_kb]), nw)
        # delta-internal adjacency (keys that end up next to each other)
        bm = bm | compute_dbitmap(k, dbitmap_fn=backend.dbitmap_fn)
        dbitmap = to_u32(bm) | meta.dbitmap
        var = meta.varbitmap | np.bitwise_or.reduce(
            np.asarray(ins_words, np.uint32) ^ meta.refkey[None, :], axis=0
        )
        return replace(meta, dbitmap=dbitmap, varbitmap=var)
