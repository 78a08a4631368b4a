"""Online index wrapper: search / insert / delete + DS-metadata upkeep (§4.3).

The bulk-built tree is immutable; online mutations follow the
main-memory-DBMS recipe the paper assumes: inserts land in a small sorted
delta, deletes set tombstones, DS-metadata is updated incrementally
(insert rule) or not at all (delete rule — lazy, valid by Theorem 2), and
a rebuild folds everything down via the compressed key sort.  The
semantics are the reference's ``repro.core.index.OnlineIndex``, answer for
answer and bit for bit.

Reads go through the versioned snapshot protocol: the standing
reconstruction is published into a
:class:`~repro_torch.core.snapshot.SnapshotCell` and every lookup probes
*this instance's* epoch with the backend's ``lookup`` (on ``"cuda"`` the
probe kernel's leaf stage), then overlays the delta/tombstone view.
``rebuild`` publishes the *next* epoch into the shared cell; the
pre-rebuild instance, and any reader that pinned the old epoch, keep
their pre-rebuild answers.  ``search`` is a thin wrapper over
``search_batch``, so single and batched answers cannot diverge.

The host side is arrays, not Python tuples, so it holds at 10M keys:

* the **neighbor view** of an insert (the keys A and B around the new
  key K) is the tree's sorted full keys, fetched once per
  reconstruction as big-endian rows of one ``V`` (raw bytes) element
  each, whose byte order is the lexicographic word order, so
  ``np.searchsorted`` is the lower bound; beside it the sorted delta is
  searched the same way.  Tombstoned base rows stay in the view, as in
  the reference: stale neighbors only ever *extend* the distinction bit
  set, which Theorem 2 permits, and dropping them would set other bits;
* the **delta** is one sorted array of big-endian ``(key, rid)`` rows,
  so the query overlay is one tombstone mask (``np.isin``) and one lower
  bound for the whole batch.

Mutations are double-entried: the delta and tombstones serve point
lookups and neighbor queries, while a
:class:`~repro_torch.replication.ChangeLog` keeps the same mutations as
LSN-stamped columnar arrays.  ``rebuild`` folds the log and goes through
``ReconstructionPipeline.run_incremental``: an unchanged D-bitmap merges
only the delta into the standing run, a changed one falls back to the
full resort; either way the output is byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .btree import BTreeConfig
from .keyformat import KeySet
from .metadata import DSMeta, meta_on_delete, meta_on_insert
from .pipeline import ReconstructionPipeline
from .reconstruct import ReconstructionResult, reconstruct_index
from .snapshot import SnapshotCell
from .u32 import resolve_device, to_carrier, to_u32

__all__ = ["OnlineIndex"]


def _rows_v(rows: np.ndarray) -> np.ndarray:
    """(m, W) uint32 -> (m,) ``V{4W}`` big-endian rows: ``np.sort`` and
    ``np.searchsorted`` order them as the lexicographic word order."""
    rows = np.ascontiguousarray(rows, dtype=">u4")
    return rows.view(f"V{rows.shape[1] * 4}").reshape(-1)


def _v_rows(v: np.ndarray, w: int) -> np.ndarray:
    """Inverse of :func:`_rows_v`: (m,) ``V`` rows -> (m, w) uint32."""
    return np.ascontiguousarray(v).view(">u4").reshape(-1, w).astype(np.uint32)


@dataclass
class OnlineIndex:
    """A reconstructable index with an insert delta and delete tombstones."""

    keyset: KeySet
    result: ReconstructionResult
    config: BTreeConfig = field(default_factory=BTreeConfig)
    backend: str = "cuda"
    #: where lookups and rebuilds run: CUDA unless the caller names one
    device: object = None
    #: the versioned read path: the standing reconstruction is published
    #: here and every lookup pins an epoch; ``rebuild`` hands the same
    #: cell to its successor so epochs keep increasing across rebuilds
    snapshots: SnapshotCell = field(default_factory=SnapshotCell, repr=False)
    #: big-endian (key words, rid) rows of the inserts, ascending
    _delta: np.ndarray | None = field(default=None, repr=False)
    _tombstones: set = field(default_factory=set)  # rids
    # the tree's sorted full keys as V rows, fetched at the first insert
    _base_view: np.ndarray | None = field(default=None, repr=False)
    _log: object | None = field(default=None, repr=False)
    _lookup_backend: object | None = field(default=None, repr=False)
    # THIS instance's epoch: searches probe it, not the cell head
    _snapshot: object | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        w = self.keyset.n_words
        if self._delta is None:
            self._delta = _rows_v(np.zeros((0, w + 1), np.uint32))
        # publish the standing result unless the cell already carries it
        # (the rebuild path publishes before constructing the successor),
        # then bind this instance to its own epoch's snapshot
        cur = self.snapshots.current
        if cur is None or cur.tree is not self.result.tree:
            cur = self.snapshots.publish(self.result)
        self._snapshot = cur

    @property
    def log(self):
        from repro_torch.replication import ChangeLog

        if self._log is None:
            self._log = ChangeLog(self.keyset.n_words)
        return self._log

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(keyset: KeySet, meta: DSMeta | None = None,
              config: BTreeConfig = BTreeConfig(), backend: str = "cuda",
              device=None) -> "OnlineIndex":
        res = reconstruct_index(keyset, meta=meta, config=config, backend=backend,
                                device=device)
        return OnlineIndex(keyset=keyset, result=res, config=config, backend=backend,
                           device=device)

    @property
    def meta(self) -> DSMeta:
        return self.result.meta

    # ----------------------------------------------------------------- search
    def _backend_obj(self):
        """The lookup backend instance (lazy; matches ``self.backend``)."""
        if self._lookup_backend is None:
            from repro_torch.backends import get_backend

            self._lookup_backend = get_backend(self.backend, device=self.device)
        return self._lookup_backend

    def _delta_lower_bound(self, keys: np.ndarray) -> np.ndarray:
        """Index of the first delta row whose key is >= each (m, W) key
        (rids are >= 0, so (key, 0) bounds every row of that key)."""
        probe = np.concatenate([keys, np.zeros((keys.shape[0], 1), np.uint32)], axis=1)
        return np.searchsorted(self._delta, _rows_v(probe), side="left")

    def _delta_rows(self) -> np.ndarray:
        """The delta as (m, W + 1) uint32 rows: key words, then the rid."""
        return _v_rows(self._delta, self.keyset.n_words + 1)

    def search_batch(
        self, query_words: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookup: (q, W) keys -> ((q,) found, (q,) rid).

        The tree probe runs the backend's ``lookup`` against *this
        instance's* snapshot epoch; the overlay then masks tombstoned
        rids (the rid is kept, the lane reads not found) and answers the
        lanes still missing from the delta, the smallest rid of a key
        first.  Miss lanes carry ``NOT_FOUND_RID`` unless a tombstone or
        the delta answers them.
        """
        w = self.keyset.n_words
        q = np.asarray(query_words, np.uint32).reshape(-1, w)
        found_t, rid_t = self._backend_obj().lookup(
            self._snapshot.tree, to_carrier(q, self.device))
        found = found_t.cpu().numpy().astype(bool)
        rid = to_u32(rid_t)
        if self._tombstones or self._delta.shape[0]:
            # only a mutated instance pays the host-side overlay
            if self._tombstones:
                dead = np.fromiter(self._tombstones, np.uint32, len(self._tombstones))
                found &= ~np.isin(rid, dead)
            miss = np.flatnonzero(~found)
            if miss.size and self._delta.shape[0]:
                rows = self._delta_rows()
                j = self._delta_lower_bound(q[miss])
                jc = np.minimum(j, rows.shape[0] - 1)
                hit = (j < rows.shape[0]) & (rows[jc, :w] == q[miss]).all(axis=1)
                found[miss[hit]] = True
                rid[miss[hit]] = rows[jc[hit], w]
        return found, rid

    def search(self, query_words: np.ndarray) -> tuple[bool, int]:
        """Point lookup for a single (W,) key; consults tree + delta - tombstones.

        A thin wrapper over :meth:`search_batch`.
        """
        found, rid = self.search_batch(np.asarray(query_words, np.uint32)[None, :])
        return bool(found[0]), int(rid[0])

    # ----------------------------------------------------------------- insert
    def insert(self, key_words: np.ndarray, rid: int) -> None:
        """Insert K; update DS-metadata per §4.3 (set max(D(A,K), D(K,B)))."""
        key = np.asarray(key_words, np.uint32).reshape(self.keyset.n_words)
        # neighbors A, B in the *current* sorted order (tree + delta view)
        a, b = self._neighbors(key)
        self.result.meta = meta_on_insert(self.meta, a, key, b)
        item = _rows_v(np.append(key, np.uint32(rid))[None, :])
        pos = np.searchsorted(self._delta, item, side="right")
        self._delta = np.insert(self._delta, pos, item)
        self.log.append_inserts(key[None, :], [int(rid)])

    def delete(self, key_words: np.ndarray) -> bool:
        """Delete K; DS-metadata untouched (lazy rule, valid by Theorem 2)."""
        key = np.asarray(key_words, np.uint32).reshape(self.keyset.n_words)
        found, rid = self.search(key)
        if not found:
            return False
        w = self.keyset.n_words
        i = int(self._delta_lower_bound(key[None, :])[0])
        row = _v_rows(self._delta[i : i + 1], w + 1)
        if row.shape[0] and (row[0, :w] == key).all():
            # a delta key leaves the delta (and the neighbor view with it)
            rid = int(row[0, w])
            self._delta = np.delete(self._delta, i)
        else:
            # tombstoned base rows stay in the neighbor view: stale
            # neighbors only ever *extend* the distinction bit set, which
            # Theorem 2 permits
            self._tombstones.add(rid)
        self.log.append_deletes([int(rid)])
        self.result.meta = meta_on_delete(self.meta)
        return True

    def _neighbors(self, key: np.ndarray) -> tuple[np.ndarray | None, np.ndarray | None]:
        """The keys just below and at-or-above ``key`` in the sorted
        (base + delta) view: the largest of the two arrays' predecessors
        and the smallest of their successors."""
        w = self.keyset.n_words
        base = self._neighbor_view()
        kv = _rows_v(key[None, :])
        i = int(np.searchsorted(base, kv, side="left")[0])
        j = int(self._delta_lower_bound(key[None, :])[0])
        delta = self._delta_rows()[:, :w]
        before = [_v_rows(base[i - 1 : i], w)[0]] if i > 0 else []
        if j > 0:
            before.append(delta[j - 1])
        after = [_v_rows(base[i : i + 1], w)[0]] if i < base.shape[0] else []
        if j < delta.shape[0]:
            after.append(delta[j])
        a = max(before, key=lambda r: r.tolist()) if before else None
        b = min(after, key=lambda r: r.tolist()) if after else None
        return a, b

    def _neighbor_view(self) -> np.ndarray:
        """The tree's sorted full keys as ``V`` rows (fetched once from the
        device, then static until the next reconstruction).

        The words are byte-swapped on the device and cross as 32-bit
        values, so the host receives the big-endian rows as they are: half
        the carrier's bytes, no conversion pass on the host.
        """
        if self._base_view is None:
            sf = self.result.tree.sorted_full
            x = (((sf & 0xFF) << 24) | ((sf & 0xFF00) << 8) | ((sf >> 8) & 0xFF00)
                 | (sf >> 24))
            # into int32 range first: the cast then keeps the low 32 bits
            x = (x - ((x >> 31) << 32)).to(torch.int32)
            self._base_view = x.cpu().numpy().view(f"V{4 * self.keyset.n_words}").reshape(-1)
        return self._base_view

    # ---------------------------------------------------------------- rebuild
    def rebuild(self, backend: str | None = None) -> "OnlineIndex":
        """Fold the change log into the base table and reconstruct with the
        *current* (possibly stale-bit) DS-metadata — the paper's recovery
        path.

        The fold is one vectorized mask + concatenate over the log's
        columnar arrays, and reconstruction goes through
        ``run_incremental``: unchanged D-bitmap ⇒ only the delta is
        extracted/sorted and merged into the standing run; otherwise the
        pipeline falls back to the byte-identical full resort.  The
        result's bitmap is then pinned to what the run was extracted under
        (a superset of the refreshed one, valid by Theorem 2), so a quiet
        follow-up rebuild can merge instead of resort.
        """
        keep_rows, delta = self.log.fold_keyset(self.keyset)
        name = backend or self.backend
        pipe = ReconstructionPipeline(backend=name, config=self.config, device=self.device)
        res, folded = pipe.run_incremental(
            self.result, self.keyset, delta, keep_rows=keep_rows, meta=self.meta,
            publish_to=self.snapshots,
        )
        res.meta = replace(
            res.meta, dbitmap=np.array(res.extract_bitmap, np.uint32, copy=True)
        )
        # the successor shares the cell; each instance stays bound to its
        # own epoch's snapshot
        return OnlineIndex(
            keyset=folded, result=res, config=self.config, backend=name,
            device=self.device, snapshots=self.snapshots,
        )
