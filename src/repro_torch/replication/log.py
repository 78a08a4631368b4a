"""Record-level change log for replication and delta reconstruction.

A numpy-only copy of the reference's ``replication/log.py``: the same
columns, LSNs, fold semantics and archive layout, so the arrays of a log
equal the reference's for the same appends.

The paper's replication story (§1, §6) ships the *table* and the tiny
DS-metadata — never an index image — and the replica reconstructs.  This
module adds the missing piece for *incremental* bring-up: a record-level
**change log** a primary can stream to replicas (or a checkpoint can store
next to a base step), so a consumer folds a small delta instead of paying a
full O(n log n) resort.

Entries are columnar, LSN-stamped, and **device-friendly**: appends take
(m, W) key-word arrays + rid vectors and are kept as array chunks — there is
no per-record Python object anywhere, so a million-entry log is five arrays,
and ``fold`` is pure vectorized masking.

Fold semantics (replay in LSN order, vectorized):

* a base row is dropped iff any DELETE entry names its rid;
* an INSERT survives iff no DELETE with the same rid has a larger LSN
  (so delete-then-reinsert of a rid works, and rid reuse after free — the
  KV-pager's pattern — replays correctly);
* surviving INSERTs keep log order — they become the delta keyset appended
  after the surviving base rows, exactly the row numbering
  ``ReconstructionPipeline.run_incremental`` expects.

Live rows must have unique rids (the usual record-id contract); two live
INSERTs of the same rid both survive the fold and both land in the index.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np

__all__ = ["OP_INSERT", "OP_DELETE", "ChangeLog"]

OP_INSERT = np.uint8(1)
OP_DELETE = np.uint8(2)


class ChangeLog:
    """Columnar LSN-stamped insert/delete log over (n_words)-word keys.

    Besides the five entry columns the log can carry the **shed-policy
    state** of its owner (the ``shed_delete_frac`` configuration and the
    owner's ``deletes_since_shed`` counter, both set at construction): a
    consumer that snapshots its apply state by serializing a log — the
    stream checkpoint frames do exactly this — must resume the bitmap shed
    policy where it left off, or a caught-up replica's future shed
    decisions diverge from a never-lagged one's.  Both fields are *pure
    carried state* (appends do not touch them; the owner tracks its own
    volume) and round-trip through ``to_npz_dict``/``from_npz_dict`` — and
    therefore through ``save``/``load`` and the wire framing.

    Parameters
    ----------
    n_words:            key width in uint32 words; every appended key must
                        reshape to ``(m, n_words)``.
    start_lsn:          LSN of the first entry this log will hold (logs are
                        contiguous: entry *i* has LSN ``start_lsn + i``).
    shed_delete_frac:   the owner's shed threshold (carried, not enforced
                        here — ``repro_torch.core.metadata.shed_or_pin`` applies
                        it); ``None`` = never shed.
    deletes_since_shed: resume value for the delete-volume counter.
    """

    def __init__(
        self,
        n_words: int,
        start_lsn: int = 0,
        shed_delete_frac: float | None = None,
        deletes_since_shed: int = 0,
    ) -> None:
        self.n_words = int(n_words)
        self.start_lsn = int(start_lsn)
        self._next_lsn = int(start_lsn)
        self.shed_delete_frac = (
            None if shed_delete_frac is None else float(shed_delete_frac)
        )
        self.deletes_since_shed = int(deletes_since_shed)
        # parallel column chunks; concatenated lazily by arrays()
        self._ops: list[np.ndarray] = []
        self._lsns: list[np.ndarray] = []
        self._words: list[np.ndarray] = []
        self._rids: list[np.ndarray] = []
        self._lengths: list[np.ndarray] = []
        self._cache: dict | None = None

    # ------------------------------------------------------------- append
    def append_inserts(
        self,
        words: np.ndarray,
        rids: np.ndarray,
        lengths: np.ndarray | None = None,
    ) -> tuple[int, int]:
        """Append m INSERT entries; returns their [lsn0, lsn1) range."""
        words = np.asarray(words, np.uint32).reshape(-1, self.n_words)
        m = words.shape[0]
        rids = np.asarray(rids, np.uint32).reshape(m)
        if lengths is None:
            lengths = np.full(m, self.n_words * 4, np.int32)
        return self._append(OP_INSERT, words, rids, np.asarray(lengths, np.int32))

    def append_deletes(self, rids: np.ndarray) -> tuple[int, int]:
        """Append DELETE entries (by rid; keys are not needed to fold).

        Returns the entries' ``[lsn0, lsn1)`` range.
        """
        rids = np.asarray(rids, np.uint32).reshape(-1)
        m = rids.shape[0]
        return self._append(
            OP_DELETE,
            np.zeros((m, self.n_words), np.uint32),
            rids,
            np.zeros(m, np.int32),
        )

    def _append(self, op, words, rids, lengths) -> tuple[int, int]:
        m = words.shape[0]
        if m == 0:
            return self._next_lsn, self._next_lsn
        lsn0 = self._next_lsn
        self._ops.append(np.full(m, op, np.uint8))
        self._lsns.append(np.arange(lsn0, lsn0 + m, dtype=np.uint64))
        self._words.append(words)
        self._rids.append(rids)
        self._lengths.append(lengths)
        self._next_lsn = lsn0 + m
        self._cache = None
        return lsn0, self._next_lsn

    # ------------------------------------------------------------- access
    def __len__(self) -> int:
        return self._next_lsn - self.start_lsn

    @property
    def next_lsn(self) -> int:
        """LSN the next appended entry will receive (= end of this log)."""
        return self._next_lsn

    def arrays(self) -> dict[str, np.ndarray]:
        """The whole log as five columns (concatenated once, then cached)."""
        if self._cache is None:
            if self._ops:
                self._cache = {
                    "ops": np.concatenate(self._ops),
                    "lsns": np.concatenate(self._lsns),
                    "words": np.concatenate(self._words, axis=0),
                    "rids": np.concatenate(self._rids),
                    "lengths": np.concatenate(self._lengths),
                }
            else:
                self._cache = {
                    "ops": np.zeros(0, np.uint8),
                    "lsns": np.zeros(0, np.uint64),
                    "words": np.zeros((0, self.n_words), np.uint32),
                    "rids": np.zeros(0, np.uint32),
                    "lengths": np.zeros(0, np.int32),
                }
        return self._cache

    # --------------------------------------------------------------- fold
    def fold(
        self, base_rids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Replay the log against base rows, fully vectorized.

        Returns ``(keep, ins_words, ins_lengths, ins_rids)``: a bool mask
        over base row positions plus the surviving inserts in log order —
        the exact inputs of ``fold_keyset`` / ``run_incremental``.
        """
        a = self.arrays()
        ops, lsns = a["ops"], a["lsns"]
        dmask = ops == OP_DELETE
        del_rids, del_lsns = a["rids"][dmask], lsns[dmask]
        base_rids = np.asarray(base_rids, np.uint32)

        if del_rids.size == 0:
            keep = np.ones(base_rids.shape[0], bool)
            imask = ops == OP_INSERT
            return keep, a["words"][imask], a["lengths"][imask], a["rids"][imask]

        uniq, inv = np.unique(del_rids, return_inverse=True)
        max_del_lsn = np.zeros(uniq.shape[0], np.uint64)
        np.maximum.at(max_del_lsn, inv, del_lsns)

        keep = ~np.isin(base_rids, uniq)

        imask = ops == OP_INSERT
        ins_rids, ins_lsns = a["rids"][imask], lsns[imask]
        pos = np.searchsorted(uniq, ins_rids)
        posc = np.minimum(pos, uniq.shape[0] - 1)
        hit = (pos < uniq.shape[0]) & (uniq[posc] == ins_rids)
        dead = hit & (max_del_lsn[posc] > ins_lsns)
        live = ~dead
        return (
            keep,
            a["words"][imask][live],
            a["lengths"][imask][live],
            a["rids"][imask][live],
        )

    def fold_keyset(self, base) -> tuple[np.ndarray | None, "object | None"]:
        """``fold`` packaged for the pipeline: (keep_rows, delta keyset).

        ``keep_rows`` is None when nothing was deleted and ``delta`` is None
        when no insert survived — exactly the argument conventions of
        ``ReconstructionPipeline.run_incremental``.  Every incremental call
        site (OnlineIndex, Replica, pager, checkpoint restore) goes through
        this one helper.
        """
        from repro_torch.core.keyformat import KeySet

        keep, ins_words, ins_lengths, ins_rids = self.fold(np.asarray(base.rids))
        delta = (
            KeySet(words=ins_words, lengths=ins_lengths, rids=ins_rids)
            if ins_words.shape[0]
            else None
        )
        return (None if bool(keep.all()) else keep), delta

    # ------------------------------------------------- slicing / stitching
    def slice_lsn(self, lsn0: int, lsn1: int) -> "ChangeLog":
        """The sub-log of entries with LSN in ``[lsn0, lsn1)``.

        The stream layer's replay primitive: a replica that already applied
        part of a shipped batch (its watermark sits inside the batch's LSN
        range) slices off the prefix it has seen and applies the rest —
        which is what makes duplicate/overlapping delivery idempotent.
        Entries keep their original LSNs; the slice's ``start_lsn`` is the
        clamped ``lsn0``.  Shed state is *not* carried (a slice is a wire
        batch, not an owner snapshot).
        """
        lsn0 = max(int(lsn0), self.start_lsn)
        lsn1 = min(int(lsn1), self._next_lsn)
        out = ChangeLog(self.n_words, start_lsn=lsn0)
        if lsn1 <= lsn0:
            out._next_lsn = max(lsn0, lsn1)
            return out
        a = self.arrays()
        m = (a["lsns"] >= np.uint64(lsn0)) & (a["lsns"] < np.uint64(lsn1))
        out._ops = [a["ops"][m]]
        out._lsns = [a["lsns"][m]]
        out._words = [a["words"][m]]
        out._rids = [a["rids"][m]]
        out._lengths = [a["lengths"][m]]
        out._next_lsn = lsn1
        return out

    @staticmethod
    def concat(logs: "list[ChangeLog]") -> "ChangeLog":
        """Stitch LSN-contiguous logs into one (replay order preserved).

        The watermark-triggered rebuild primitive: a replica that drained
        several pending stream batches folds them through **one**
        ``run_incremental`` instead of paying one rebuild per batch.  Each
        ``logs[i+1].start_lsn`` must equal ``logs[i].next_lsn``; key widths
        must agree.  Shed state is *not* carried (wire batches, not owner
        snapshots).
        """
        if not logs:
            raise ValueError("concat of no logs")
        out = ChangeLog(logs[0].n_words, start_lsn=logs[0].start_lsn)
        expect = logs[0].start_lsn
        for log in logs:
            if log.n_words != out.n_words:
                raise ValueError(
                    f"key width mismatch: {log.n_words} != {out.n_words}"
                )
            if log.start_lsn != expect:
                raise ValueError(
                    f"non-contiguous logs: expected lsn {expect}, "
                    f"got {log.start_lsn}"
                )
            a = log.arrays()
            if a["ops"].size:
                out._ops.append(a["ops"])
                out._lsns.append(a["lsns"])
                out._words.append(a["words"])
                out._rids.append(a["rids"])
                out._lengths.append(a["lengths"])
            expect = log.next_lsn
        out._next_lsn = expect
        return out

    # ------------------------------------------------------ serialization
    def to_npz_dict(self) -> dict[str, np.ndarray]:
        """The log as a flat dict of ``log_``-prefixed arrays.

        Embeddable into a larger npz (the delta-checkpoint and stream-frame
        formats do) — includes the shed-policy state, which must survive
        the round trip (``shed_delete_frac`` is encoded as NaN when unset).
        """
        a = self.arrays()
        frac = np.nan if self.shed_delete_frac is None else self.shed_delete_frac
        return {
            "log_ops": a["ops"],
            "log_lsns": a["lsns"],
            "log_words": a["words"],
            "log_rids": a["rids"],
            "log_lengths": a["lengths"],
            "log_n_words": np.asarray(self.n_words, np.int32),
            "log_start_lsn": np.asarray(self.start_lsn, np.int64),
            "log_shed_frac": np.asarray(frac, np.float64),
            "log_deletes_since_shed": np.asarray(
                self.deletes_since_shed, np.int64
            ),
        }

    @staticmethod
    def from_npz_dict(d: dict[str, np.ndarray]) -> "ChangeLog":
        """Inverse of ``to_npz_dict`` (tolerates pre-shed-state archives).

        A dict missing required ``log_*`` columns raises the typed
        :class:`repro_torch.replication.wire.FrameSchemaError` (not a raw
        ``KeyError``) so stream consumers can classify the failure.
        """
        from .wire import FrameSchemaError

        try:
            frac = float(d.get("log_shed_frac", np.nan))
            log = ChangeLog(
                int(d["log_n_words"]),
                start_lsn=int(d["log_start_lsn"]),
                shed_delete_frac=None if np.isnan(frac) else frac,
                deletes_since_shed=int(d.get("log_deletes_since_shed", 0)),
            )
            ops = np.asarray(d["log_ops"], np.uint8)
            if ops.size:
                log._ops = [ops]
                log._lsns = [np.asarray(d["log_lsns"], np.uint64)]
                log._words = [np.asarray(d["log_words"], np.uint32)]
                log._rids = [np.asarray(d["log_rids"], np.uint32)]
                log._lengths = [np.asarray(d["log_lengths"], np.int32)]
                log._next_lsn = int(d["log_lsns"][-1]) + 1
        except (KeyError, ValueError, TypeError) as e:
            raise FrameSchemaError(f"malformed change-log archive: {e!r}") from e
        return log

    def save(self, path: str | os.PathLike) -> Path:
        """Persist as an npz file; inverse of ``load``."""
        path = Path(path)
        np.savez(path, **self.to_npz_dict())
        return path

    @staticmethod
    def load(path: str | os.PathLike) -> "ChangeLog":
        """Load a log persisted by ``save``."""
        with np.load(path) as z:
            return ChangeLog.from_npz_dict(dict(z))

    # ------------------------------------------------------- wire framing
    def to_wire(self) -> bytes:
        """Serialize for a stream transport (the npz archive as bytes).

        The stream layer wraps this payload in a typed frame (its
        ``encode_frame``, ROADMAP Queue 1 item 10); the bytes themselves
        are a standard npz, so any npz reader can inspect a captured frame.
        """
        buf = io.BytesIO()
        np.savez(buf, **self.to_npz_dict())
        return buf.getvalue()

    @staticmethod
    def from_wire(payload: bytes) -> "ChangeLog":
        """Inverse of ``to_wire``.

        A payload that is not an npz archive (torn copy, foreign bytes)
        raises the typed :class:`repro_torch.replication.wire.FrameSchemaError`
        instead of a raw zipfile exception.
        """
        from .wire import FrameSchemaError

        try:
            with np.load(io.BytesIO(payload)) as z:
                d = dict(z)
        except Exception as e:  # zipfile.BadZipFile, OSError, ValueError
            raise FrameSchemaError(
                f"wire payload is not an npz archive: {e}"
            ) from e
        return ChangeLog.from_npz_dict(d)
