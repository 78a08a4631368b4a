"""Paged KV-cache manager whose page index is a reconstructable B-tree.

Pages of ``page_tokens`` KV slots are allocated from a free list; the page
table maps ``(seq_id, page_no) -> physical page``.  Exactly like the
paper's main-memory indexes, the *search index* over the page table is
never persisted: on engine restart (or replica bring-up) it is rebuilt from
the table rows with the compressed key sort — `(seq_id << bits) || page_no`
keys compress to their few distinction bits, and the bulk build produces
the lookup tree.

Every mutation is also journaled into a
:class:`~repro_torch.replication.ChangeLog` (alloc = INSERT of the packed
key with the physical page as rid, free = DELETE by physical page), and
DS-metadata is kept current with the §4.3 insert rule.  A restart
therefore *replays the pager's log*: the log folds onto the keyset of the
previous build and ``ReconstructionPipeline.run_incremental`` merges just
the churn into the standing sorted run — paying the full resort only when
an alloc introduced a new distinction bit.  ``rebuild_index`` *is* the
paper's recovery path on this table.  The journal's entries, and so the
frames :meth:`PagedKVManager.attach_stream` ships, are the same entry for
entry as the JAX package's pager writes for the same operations.

Gets are versioned: every rebuild publishes an epoch-stamped snapshot into
a :class:`~repro_torch.core.snapshot.SnapshotCell` and ``lookup`` /
``lookup_batch`` pin the current epoch around the backend's ``lookup`` (on
``"cuda"`` the probe kernel's leaf stage) — page gets racing a restart
rebuild answer from the pre-rebuild index.  The pager runs on ``device``:
CUDA unless the caller names another, resolved when it is built, so a
missing GPU raises at once.

Concurrency contract: **single-writer, multi-reader**.  Mutations
(``alloc``/``free_seq``/``pages_for``) and ``rebuild_index`` belong to
one writer thread; ``lookup``/``lookup_batch`` may run from any number
of reader threads concurrently with both, because they only touch the
snapshot cell (thread-safe) and the backend's stateless ``lookup``.
Readers default to *rebuild-on-read* when the index is dirty — the
single-threaded convenience — which is serialized under an internal
rebuild mutex; a concurrent serving deployment sets
``read_through_dirty=True`` so readers keep answering from the current
epoch while the writer folds the journal, and (optionally) bounds
staleness with the ``max_lag_epochs`` admission-control knob (journal
backlog is converted to epochs at ``lag_entries_per_epoch`` entries per
rebuild; over the bound, reads shed or park — see
``repro_torch.core.snapshot``).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.btree import NOT_FOUND_RID  # noqa: F401  (re-export for callers)
from repro_torch.core.keyformat import KeySet
from repro_torch.core.metadata import DSMeta, meta_on_insert, shed_or_pin
from repro_torch.core.pipeline import ReconstructionPipeline, ReconstructionResult
from repro_torch.core.snapshot import SnapshotCell
from repro_torch.core.u32 import resolve_device, to_carrier, to_u32
from repro_torch.replication import ChangeLog

__all__ = ["PagedKVManager"]


def _pack_key(seq_id: int, page_no: int) -> np.ndarray:
    """(seq_id, page_no) -> (2,) uint32 key words (word 0 most significant)."""
    return np.asarray([seq_id, page_no], dtype=np.uint32)


@dataclass
class PagedKVManager:
    """Paged KV allocator whose page index rebuilds via compressed key sort.

    Tracks ``(seq_id, page_no) -> physical page`` with a journaled free
    list; ``rebuild_index`` is the paper's recovery path over this table
    and every rebuild publishes a versioned snapshot that ``lookup`` /
    ``lookup_batch`` pin (see the module docstring for the lifecycle and
    the single-writer/multi-reader concurrency contract).
    """

    n_pages: int
    page_tokens: int
    backend: str = "cuda"  # execution backend for index reconstruction
    #: where rebuilds and gets run: CUDA unless the caller names one
    device: object = None
    #: shed delete-stale distinction bits when frees since the last shed
    #: exceed this fraction of the live index (None = always pin; see
    #: Replica for the policy rationale)
    shed_delete_frac: float | None = None
    #: serving mode: readers answer from the current published epoch even
    #: while the journal is dirty, instead of triggering a rebuild from
    #: the read path (required when lookups run on reader threads
    #: concurrent with a writer — see the module concurrency contract)
    read_through_dirty: bool = False
    #: admission control: bound on rebuild lag (in epochs) before reads
    #: shed or park; None disables (see repro_torch.core.snapshot.SnapshotCell)
    max_lag_epochs: int | None = None
    admission: str = "shed"
    park_timeout: float | None = None
    #: journal entries that count as one epoch of lag when converting the
    #: pending-log backlog into the cell's lag metric
    lag_entries_per_epoch: int = 64
    _deletes_since_shed: int = 0
    _free: list = field(default_factory=list)
    _table: dict = field(default_factory=dict)  # (seq, page_no) -> phys page
    _index: ReconstructionResult | None = None
    _index_dirty: bool = True
    # replication journal + incremental-rebuild state
    _log: ChangeLog = field(default_factory=lambda: ChangeLog(2), repr=False)
    _stream: object | None = field(default=None, repr=False)
    _base_keyset: KeySet | None = field(default=None, repr=False)
    _meta: DSMeta | None = field(default=None, repr=False)
    _sorted_keys: list | None = field(default=None, repr=False)
    _last_rebuild: dict = field(default_factory=dict, repr=False)
    # versioned read path: rebuilds publish epochs here, gets pin them
    _snapshots: SnapshotCell = field(default_factory=SnapshotCell, repr=False)
    _lookup_backend: object | None = field(default=None, repr=False)
    # serializes rebuild_index (rebuild-on-read racing an explicit rebuild)
    _rebuild_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._snapshots = SnapshotCell(
            max_lag_epochs=self.max_lag_epochs,
            admission=self.admission,
            park_timeout=self.park_timeout,
        )

    # ------------------------------------------------------------- mutation
    def alloc(self, seq_id: int, page_no: int) -> int:
        """Map ``(seq_id, page_no)`` to a fresh physical page (journaled).

        A re-alloc of a mapped slot retires the old physical page first;
        genuinely new keys advance DS-metadata with the §4.3 insert rule.
        Returns the physical page id.
        """
        if not self._free:
            raise MemoryError("KV pager out of pages")
        phys = self._free.pop()
        key_t = (int(seq_id), int(page_no))
        if key_t in self._table:
            # re-alloc of a mapped slot: retire the old physical page so the
            # log replay (delete old rid, insert new) matches the table
            old = self._table[key_t]
            self._free.append(old)
            self._log.append_deletes([old])
        elif self._meta is not None:
            # §4.3 insert rule against the current sorted key population
            # (only genuinely new keys extend it)
            keys = self._sorted_view()
            i = bisect.bisect_left(keys, key_t)
            a = np.asarray(keys[i - 1], np.uint32) if i > 0 else None
            b = np.asarray(keys[i], np.uint32) if i < len(keys) else None
            self._meta = meta_on_insert(self._meta, a, _pack_key(*key_t), b)
            keys.insert(i, key_t)
        self._table[key_t] = phys
        self._log.append_inserts(_pack_key(*key_t)[None, :], [phys])
        self._index_dirty = True
        self._report_lag()
        return phys

    def free_seq(self, seq_id: int) -> int:
        """Free every page of ``seq_id`` (lazy deletes: metadata untouched).

        The deletes are journaled in the table's insertion order, as the
        JAX package's pager journals them.  Returns the number of pages
        released back to the free list.
        """
        gone = [k for k in self._table if k[0] == seq_id]
        freed = []
        for k in gone:
            phys = self._table.pop(k)
            self._free.append(phys)
            freed.append(phys)
            if self._sorted_keys is not None:
                j = bisect.bisect_left(self._sorted_keys, k)
                if j < len(self._sorted_keys) and self._sorted_keys[j] == k:
                    self._sorted_keys.pop(j)
        if freed:
            # DS-metadata untouched: the lazy delete rule (Theorem 2)
            self._log.append_deletes(freed)
            self._deletes_since_shed += len(freed)
        self._index_dirty = True
        self._report_lag()
        return len(gone)

    def _report_lag(self) -> None:
        """Writer-side: convert journal backlog into the cell's lag metric."""
        if self.max_lag_epochs is not None:
            self._snapshots.report_lag(len(self._log) // self.lag_entries_per_epoch)

    def pages_for(self, seq_id: int, n_tokens: int) -> list[int]:
        """Ensure pages covering n_tokens exist; returns physical page list."""
        need = -(-n_tokens // self.page_tokens)
        out = []
        for p in range(need):
            if (seq_id, p) not in self._table:
                self.alloc(seq_id, p)
            out.append(self._table[(seq_id, p)])
        return out

    def _sorted_view(self) -> list:
        if self._sorted_keys is None:
            self._sorted_keys = sorted(self._table)
        return self._sorted_keys

    # ---------------------------------------------------------- streaming
    def attach_stream(self, primary) -> None:
        """Ship this pager's journal over a replication stream.

        ``primary`` is a fire-and-forget
        :class:`~repro_torch.replication.StreamPrimary` (``keyset=None,
        n_words=2``) over any transport.  From then on, every
        ``rebuild_index`` also publishes the log batch it drains — a
        standby following the stream with a ``StreamReplica`` keeps a warm
        copy of the page index.  Attach before the first mutation so the
        stream carries the table from LSN 0.
        """
        if primary.n_words != 2:
            raise ValueError("page-table stream must carry 2-word keys")
        if primary.next_lsn != self._log.start_lsn:
            raise ValueError(
                f"stream at LSN {primary.next_lsn} cannot carry a journal "
                f"starting at {self._log.start_lsn}"
            )
        self._stream = primary

    # ---------------------------------------------------------------- index
    def rebuild_index(self, backend: str | None = None) -> ReconstructionResult:
        """Reconstruct the page-table B-tree (the paper's recovery path).

        After the first build, the rebuild replays the mutation log: it
        folds onto the previous build's keyset and goes through the
        pipeline's incremental delta-merge path (byte-identical full-path
        fallback when the D-bitmap grew).  Serialized under an internal
        mutex so rebuild-on-read racing an explicit rebuild folds the
        journal exactly once.
        """
        with self._rebuild_lock:
            return self._rebuild_index_locked(backend)

    def _table_keyset(self) -> KeySet:
        """The page table as a keyset in ascending key order (rids follow
        the sorted keys, as ``sorted(self._table.items())`` orders them)."""
        keys = np.fromiter(
            (v for k in self._table for v in k), np.int64, 2 * len(self._table)
        ).reshape(-1, 2)
        phys = np.fromiter(self._table.values(), np.int64, len(self._table))
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        n = len(order)
        return KeySet(
            words=keys[order].astype(np.uint32),
            lengths=np.full(n, 8, np.int32),
            rids=phys[order].astype(np.uint32),
        )

    def _rebuild_index_locked(self, backend: str | None) -> ReconstructionResult:
        """Body of :meth:`rebuild_index`; caller holds ``_rebuild_lock``."""
        if not self._table:
            raise ValueError("empty page table")
        pipe = ReconstructionPipeline(backend=backend or self.backend, device=self.device)
        if self._index is None or self._base_keyset is None:
            ks = self._table_keyset()
            res = pipe.run(ks, publish_to=self._snapshots)
            folded = ks
        else:
            keep_rows, delta = self._log.fold_keyset(self._base_keyset)
            res, folded = pipe.run_incremental(
                self._index, self._base_keyset, delta,
                keep_rows=keep_rows, meta=self._meta,
                publish_to=self._snapshots,
            )
        self._index, self._base_keyset = res, folded
        # pin the working bitmap to the extraction bitmap so the next
        # restart can merge instead of resort — unless enough frees
        # accumulated to shed the delete-stale widened bits (shed_or_pin)
        self._meta, shed, self._deletes_since_shed = shed_or_pin(
            res.meta, res.extract_bitmap, self._deletes_since_shed,
            self.shed_delete_frac, folded.n,
        )
        self._last_rebuild = {
            "incremental": bool(res.stats.get("incremental", False)),
            "fallback": res.stats.get("incremental_fallback"),
            "log_entries_replayed": len(self._log),
            "shed_bits": shed,
        }
        if self._stream is not None and len(self._log):
            # ship the drained journal batch before resetting it: a standby
            # following the stream replays exactly what this rebuild folded
            self._stream.publish(self._log)
        self._log = ChangeLog(2, start_lsn=self._log.next_lsn)
        self._index_dirty = False
        self._report_lag()
        return res

    def _backend_obj(self):
        """The lookup backend instance (lazy; matches ``self.backend``)."""
        if self._lookup_backend is None:
            from repro_torch.backends import get_backend

            self._lookup_backend = get_backend(self.backend, device=self.device)
        return self._lookup_backend

    def lookup_batch_versioned(
        self, pairs: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Batched page gets with the answering epoch: ``(found, rid, epoch)``.

        Routes through the snapshot protocol: the current epoch is pinned
        for the whole probe, so gets racing a ``rebuild_index`` (a restart
        folding the journal) answer from the pre-rebuild index — never a
        torn one.  The probe is the backend's ``lookup``; its copy to the
        host, inside the pin, is the wait for the device.  With
        ``read_through_dirty`` a dirty journal does *not* trigger a
        rebuild from the read path (only the very first build does);
        callers use the returned epoch to know which published state
        answered.  May raise ``repro_torch.core.snapshot.AdmissionShed``
        when admission control is on and rebuild lag exceeds the bound.
        """
        if self._index is None or (self._index_dirty and not self.read_through_dirty):
            self.rebuild_index()
        q = to_carrier(np.asarray(pairs, np.uint32).reshape(-1, 2), self.device)
        with self._snapshots.pin() as snap:
            found, rid = self._backend_obj().lookup(snap.tree, q)
            found, rid = found.cpu().numpy().astype(bool), to_u32(rid)
            epoch = snap.epoch
        return found, rid, epoch

    def lookup_batch(self, pairs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched page gets: (q, 2) (seq_id, page_no) rows -> (found, rid).

        A thin wrapper over :meth:`lookup_batch_versioned` that drops the
        epoch stamp.
        """
        found, rid, _ = self.lookup_batch_versioned(pairs)
        return found, rid

    def lookup(self, seq_id: int, page_no: int) -> int | None:
        """Index-backed point lookup (tree search, not the dict).

        A thin wrapper over :meth:`lookup_batch` — one implementation for
        scalar and batched gets.
        """
        found, rid = self.lookup_batch(
            _pack_key(seq_id, page_no)[None, :]
        )
        return int(rid[0]) if bool(found[0]) else None

    @property
    def stats(self) -> dict:
        """Pager health: page occupancy, index state, journal backlog,
        last-rebuild breakdown, and the snapshot cell's exact counters."""
        return {
            "pages_used": self.n_pages - len(self._free),
            "pages_free": len(self._free),
            "index_keys": len(self._table),
            "compression_ratio": (
                self._index.stats.get("compression_ratio") if self._index else None
            ),
            "last_rebuild": dict(self._last_rebuild),
            "log_entries_pending": len(self._log),
            "snapshot_epoch": self._snapshots.epoch,
            "snapshot": self._snapshots.stats(),
        }
