"""Async streaming replication: primary → N replicas over a transport.

The port of the reference's ``replication/stream.py``: the same frames
(a frame encoded by either package decodes in the other), the same
protocol and the same poll cadence.  Every rebuild runs on the
replica's backend and device (``"cuda"`` and the GPU unless named).

The paper's headline scenario (§1, §6) run end to end: the wire carries
the **table and its change log — never an index image** — and every
consumer keeps its index current by *reconstructing*, incrementally, with
the compressed key sort.  This module turns the in-process ``Replica``
into a real primary/replica topology over a pluggable
:mod:`~repro_torch.replication.transport`:

* :class:`StreamPrimary` appends LSN-ordered ``ChangeLog`` batches to the
  transport (optionally **coalescing** small batches up to a plan-cache
  bucket boundary so every replica's delta sort sees one padded shape),
  keeps its own index current through the same ``Replica``
  apply path, periodically snapshots its state through the checkpoint
  layer (``save_checkpoint`` / ``save_checkpoint_delta`` chains), and
  publishes the checkpoint *manifest* as a stream frame so laggards can
  find their catch-up base.
* :class:`StreamReplica` tails the transport by position: contiguous
  batches are stitched (``ChangeLog.concat``) and folded through **one**
  watermark-triggered ``run_incremental`` per poll; duplicate or
  overlapping delivery is idempotent (LSN watermark check +
  ``slice_lsn``); a gap with no checkpoint frame is a protocol error; a
  replica that fell behind a retention truncation **bootstraps from the
  checkpoint chain** and then resumes tailing.

Backpressure is bounded-lag: with ``max_lag_batches`` set, the primary
checkpoints and truncates the transport once that many batches pile up
after the last checkpoint frame, which caps both transport growth and the
worst-case catch-up replay any replica can face.

Determinism: a replica driven only through the stream — including one
that bootstrapped from a checkpoint — holds the same byte-identity
contract as ``Replica`` itself: its standing result always equals a full
``ReconstructionPipeline.run`` over its folded keyset under its working
metadata, on every backend.  Its D-bitmap equals the primary's when it
applies the stream batch by batch; a poll that drains several batches
folds them through one ``Replica.apply_many``, whose insert rule sees
the tree as it stood before the span, so its bitmap (and ``comp_sorted``)
can differ from the primary's while every lookup agrees — the reference's
behavior, kept as it is.  Shed adoption is a **logged event**: when
the primary's tracked index sheds its D-bitmap, a :class:`ShedFrame`
lands in the stream at that watermark and every consumer adopts the shed
exactly there (``Replica.adopt_shed``) — so tailing, lagging, and
checkpoint-bootstrapped replicas are byte-identical to the primary at
*every* watermark, whatever their poll cadence (see docs/replication.md
§Determinism).

Reads are versioned: every inner ``Replica`` publishes each rebuild into
a ``repro_torch.core.snapshot.SnapshotCell`` and serves lookups from the
pinned epoch, so queries interleaved with ``poll`` answer from the
pre-watermark snapshot — never a torn mixture of two reconstructions.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.keyformat import KeySet
from repro_torch.core.metadata import DSMeta
from repro_torch.core.u32 import resolve_device

from .log import ChangeLog
from .replica import Replica
from .transport import FrameTruncated, Transport
from .wire import (
    FrameCorrupt,
    FrameHeader,
    FrameSchemaError,
    is_framed,
    pack_frame,
    unpack_frame,
)

__all__ = [
    "BatchFrame",
    "CheckpointFrame",
    "ShedFrame",
    "encode_frame",
    "decode_frame",
    "peek_header",
    "StreamPrimary",
    "StreamReplica",
    "StreamError",
    "LsnGapError",
    "BackpressureError",
    "FrameCorrupt",
    "FrameSchemaError",
]


class StreamError(RuntimeError):
    """Base class for stream protocol violations."""


class LsnGapError(StreamError):
    """A batch frame skipped past the expected LSN with no checkpoint to
    bridge the gap — out-of-order or lost delivery, rejected."""


class BackpressureError(StreamError):
    """Bounded-lag backpressure misconfigured: ``max_lag_batches`` needs a
    tracked index and a checkpoint directory to shed lag into — rejected
    at construction, before any frame could be torn mid-publish."""


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchFrame:
    """One shipped change-log batch: entries ``[lsn0, lsn1)`` in LSN order.

    ``bucket`` tags the plan-cache bucket the batch size falls in — a
    coalescing primary aims successive batches at one bucket so the
    replica-side delta extract/sort replays a cached program.
    """

    log: ChangeLog
    bucket: int

    @property
    def lsn0(self) -> int:
        """First LSN in the batch."""
        return self.log.start_lsn

    @property
    def lsn1(self) -> int:
        """One past the last LSN in the batch."""
        return self.log.next_lsn


@dataclass(frozen=True)
class ShedFrame:
    """A control frame: the primary's index shed its D-bitmap at ``lsn``.

    Shed adoption used to be a local, volume-triggered decision — which
    meant a replica folding several batches through one rebuild checked
    the threshold once for the span and could shed at a different
    watermark than the primary (docs/replication.md §Determinism, the old
    caveat).  Logging the adoption as a stream frame makes it part of the
    replay: consumers treat the frame as a span boundary (pending batches
    through ``lsn`` fold first) and then adopt the refreshed bitmap via
    ``Replica.adopt_shed`` — so a tailing replica and a caught-up one are
    identical at *every* watermark, whatever their poll cadence.
    """

    lsn: int


@dataclass(frozen=True)
class CheckpointFrame:
    """A checkpoint manifest: where a catch-up base lives on disk.

    ``base_lsn`` is the first LSN **not** covered by the checkpointed
    state — the state is current through ``base_lsn - 1`` and a
    bootstrapped replica resumes tailing *at* ``base_lsn``.
    ``log_state`` is the primary's empty log tail starting at
    ``base_lsn``, carrying the shed-policy bookkeeping
    (``shed_delete_frac`` / ``deletes_since_shed``) a bootstrapped
    replica must resume with.
    """

    ckpt_dir: str
    step: int
    base_lsn: int
    log_state: ChangeLog


#: numeric frame-kind tags for the wire header (0 is reserved)
_KIND_CODES = {"batch": 1, "shed": 2, "checkpoint": 3}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}


def encode_frame(
    frame: "BatchFrame | CheckpointFrame | ShedFrame", seq: int = 0
) -> bytes:
    """Serialize a frame for a transport: integrity header + npz payload.

    The payload is a self-describing npz archive (the frame kind, the
    frame-specific fields, and — for batch/checkpoint frames — the
    ``log_``-prefixed change-log columns), wrapped in the fixed
    :mod:`~repro_torch.replication.wire` header: magic, format version, frame
    kind tag, the publisher's monotonic sequence number ``seq``, payload
    length, and a CRC32C covering both.  A bit flip anywhere on the wire
    surfaces as a typed :class:`~repro_torch.replication.wire.FrameCorrupt`
    instead of a garbage decode.
    """
    buf = io.BytesIO()
    if isinstance(frame, BatchFrame):
        np.savez(
            buf,
            frame_kind=np.asarray("batch"),
            frame_bucket=np.asarray(frame.bucket, np.int64),
            **frame.log.to_npz_dict(),
        )
    elif isinstance(frame, ShedFrame):
        np.savez(
            buf,
            frame_kind=np.asarray("shed"),
            frame_lsn=np.asarray(frame.lsn, np.int64),
        )
    elif isinstance(frame, CheckpointFrame):
        np.savez(
            buf,
            frame_kind=np.asarray("checkpoint"),
            frame_ckpt_dir=np.asarray(frame.ckpt_dir),
            frame_step=np.asarray(frame.step, np.int64),
            frame_base_lsn=np.asarray(frame.base_lsn, np.int64),
            **frame.log_state.to_npz_dict(),
        )
    else:
        raise TypeError(f"not a stream frame: {type(frame).__name__}")
    kind = type(frame).__name__.replace("Frame", "").lower()
    return pack_frame(_KIND_CODES[kind], buf.getvalue(), seq=int(seq))


def peek_header(payload: bytes) -> FrameHeader | None:
    """The verified wire header of a framed payload; ``None`` for legacy
    v0 frames (raw npz, no header).  Raises the same typed errors as
    :func:`decode_frame` on a damaged header."""
    return unpack_frame(payload)[0] if is_framed(payload) else None


def _load_npz(body: bytes) -> dict:
    """Decode an npz payload defensively (typed error, never garbage)."""
    try:
        with np.load(io.BytesIO(body)) as z:
            return dict(z)
    except Exception as e:  # zipfile.BadZipFile, OSError, ValueError, ...
        raise FrameSchemaError(
            f"frame payload is not an npz archive: {e}"
        ) from e


def decode_frame(payload: bytes) -> "BatchFrame | CheckpointFrame | ShedFrame":
    """Inverse of :func:`encode_frame`, with verification.

    Framed (v1) payloads have their length and CRC32C checked and the
    header's kind tag cross-checked against the npz body; payloads
    without the frame magic decode through the **legacy v0 fallback**
    (raw npz — pre-header spools keep working).  All failure modes raise
    typed errors: :class:`~repro_torch.replication.wire.FrameCorrupt` for
    damaged bytes, :class:`~repro_torch.replication.wire.FrameSchemaError` for
    intact-but-malformed payloads (unknown kind, missing fields,
    not-an-npz) — never a raw ``KeyError`` or zipfile exception.
    """
    if is_framed(payload):
        hdr, body = unpack_frame(payload)
        expect_kind = _KIND_NAMES.get(hdr.kind)
        if expect_kind is None:
            raise FrameSchemaError(f"unknown frame kind tag {hdr.kind}")
    else:
        hdr, body, expect_kind = None, payload, None  # legacy v0 frame
    d = _load_npz(body)
    if "frame_kind" not in d:
        raise FrameSchemaError("frame payload has no 'frame_kind' field")
    kind = str(d["frame_kind"])
    if expect_kind is not None and kind != expect_kind:
        raise FrameSchemaError(
            f"header kind {expect_kind!r} != payload kind {kind!r}"
        )
    try:
        if kind == "batch":
            return BatchFrame(
                log=ChangeLog.from_npz_dict(d), bucket=int(d["frame_bucket"])
            )
        if kind == "shed":
            return ShedFrame(lsn=int(d["frame_lsn"]))
        if kind == "checkpoint":
            return CheckpointFrame(
                ckpt_dir=str(d["frame_ckpt_dir"]),
                step=int(d["frame_step"]),
                base_lsn=int(d["frame_base_lsn"]),
                log_state=ChangeLog.from_npz_dict(d),
            )
    except (KeyError, ValueError, TypeError) as e:
        raise FrameSchemaError(f"malformed {kind!r} frame: {e!r}") from e
    raise FrameSchemaError(f"unknown frame kind {kind!r}")


# ---------------------------------------------------------------------------
# checkpointed state <-> tree (rides the repro_torch.ckpt manifest machinery)
# ---------------------------------------------------------------------------


def _state_tree(rep: Replica) -> dict:
    """A replica's base state as a tree the checkpoint layer can diff."""
    ks, meta = rep.keyset, rep.meta
    return {
        "keyset": {
            "words": np.asarray(ks.words, np.uint32),
            "lengths": np.asarray(ks.lengths, np.int32),
            "rids": np.asarray(ks.rids, np.uint32),
        },
        "meta": {
            "dbitmap": np.asarray(meta.dbitmap, np.uint32),
            "varbitmap": np.asarray(meta.varbitmap, np.uint32),
            "refkey": np.asarray(meta.refkey, np.uint32),
            "n_words": np.asarray(meta.n_words, np.int32),
        },
    }


def _state_like() -> dict:
    """Structure-only template for ``restore_checkpoint`` (shapes are
    taken from the stored arrays, only the leaf names must match)."""
    z32 = np.zeros(0, np.uint32)
    return {
        "keyset": {"words": z32, "lengths": z32, "rids": z32},
        "meta": {"dbitmap": z32, "varbitmap": z32, "refkey": z32,
                 "n_words": z32},
    }


# ---------------------------------------------------------------------------
# primary
# ---------------------------------------------------------------------------


class StreamPrimary:
    """The publishing side: appends batches, checkpoints, bounds lag.

    Parameters
    ----------
    transport:        where frames go (any :class:`Transport`).
    keyset:           base table at stream origin.  When given, the primary
                      keeps its **own** index current (it applies every
                      batch it ships through the same ``Replica`` path a
                      consumer runs — the primary *is* the never-lagged
                      replica) and publishes the base rows as a genesis
                      batch so replicas can bring up from LSN 0.  ``None``
                      makes a fire-and-forget publisher (e.g. the serve
                      pager shipping its journal): no tracked index, no
                      checkpoints — ``n_words`` is then required.
    n_words:          key width; inferred from ``keyset`` when present.
    backend:          execution backend for the tracked index.
    device:           where the tracked index lives (CUDA unless named);
                      the checkpoints' manifest metadata is derived there.
    shed_delete_frac: bitmap shed policy of the tracked index (carried to
                      replicas in checkpoint frames).
    ckpt_dir:         directory for state checkpoints (full step first,
                      ``save_checkpoint_delta`` chain after).
    max_lag_batches:  bounded-lag backpressure — after this many batch
                      frames pile up past the last checkpoint frame, the
                      primary checkpoints and truncates the transport,
                      capping retention and worst-case catch-up replay.
    coalesce_min:     buffer published logs until this many entries are
                      pending, then ship them as one batch whose size tags
                      a plan-cache bucket; ``None`` ships every publish
                      immediately.  ``flush()`` forces the buffer out.
    """

    def __init__(
        self,
        transport: Transport,
        keyset: KeySet | None = None,
        *,
        n_words: int | None = None,
        backend: str = "cuda",
        device=None,
        shed_delete_frac: float | None = None,
        ckpt_dir: "str | None" = None,
        max_lag_batches: int | None = None,
        coalesce_min: int | None = None,
    ) -> None:
        if keyset is None and n_words is None:
            raise ValueError("need a base keyset or an explicit n_words")
        if max_lag_batches is not None and (keyset is None or ckpt_dir is None):
            raise BackpressureError(
                "max_lag_batches needs a tracked index (keyset) and a "
                "ckpt_dir to shed lag into"
            )
        self.transport = transport
        self.backend = backend
        self.device = resolve_device(device)
        self.shed_delete_frac = shed_delete_frac
        self.ckpt_dir = ckpt_dir
        self.max_lag_batches = max_lag_batches
        self.coalesce_min = coalesce_min
        self.n_words = int(keyset.n_words if keyset is not None else n_words)
        self._pending: list[ChangeLog] = []
        self._next_lsn = 0
        self._wire_seq = 0
        self._ckpt_step = 0
        self._prev_ckpt_pos: int | None = None
        self._batches_since_ckpt = 0
        self._in_checkpoint = False
        self.n_batches_published = 0
        self.n_shed_frames = 0
        self.replica: Replica | None = None
        if keyset is not None:
            genesis = ChangeLog(self.n_words, start_lsn=0)
            genesis.append_inserts(
                np.asarray(keyset.words, np.uint32),
                np.asarray(keyset.rids, np.uint32),
                lengths=np.asarray(keyset.lengths, np.int32),
            )
            self._next_lsn = genesis.next_lsn
            self.replica = Replica(
                keyset,
                backend=backend,
                device=device,
                shed_delete_frac=shed_delete_frac,
                applied_lsn=genesis.next_lsn - 1,
            )
            self._ship(genesis)

    # -------------------------------------------------------------- write
    def _publish_frame(self, frame) -> int:
        """Encode with the next monotonic wire sequence number and publish."""
        pos = self.transport.publish(encode_frame(frame, seq=self._wire_seq))
        self._wire_seq += 1
        return pos

    @property
    def next_lsn(self) -> int:
        """LSN the next published log must start at (contiguity check)."""
        return self._next_lsn

    def publish(self, log: ChangeLog) -> None:
        """Enqueue one LSN-contiguous log for shipment.

        With coalescing off the log ships immediately; with
        ``coalesce_min`` set it is buffered until enough entries are
        pending (``flush()`` forces shipment).  Raises ``StreamError`` on
        an LSN discontinuity — the primary is the stream's single writer
        and its sequence must be gap-free.
        """
        if log.n_words != self.n_words:
            raise ValueError(
                f"log key width {log.n_words} != stream width {self.n_words}"
            )
        if log.start_lsn != self._next_lsn:
            raise StreamError(
                f"publish out of order: log starts at {log.start_lsn}, "
                f"stream is at {self._next_lsn}"
            )
        self._next_lsn = log.next_lsn
        self._pending.append(log)
        pending_entries = sum(len(p) for p in self._pending)
        if self.coalesce_min is None or pending_entries >= self.coalesce_min:
            self.flush()

    def flush(self) -> int:
        """Ship the coalesced pending buffer as one batch frame.

        Returns the number of entries shipped (0 when nothing pending).
        """
        if not self._pending:
            return 0
        merged = (
            self._pending[0]
            if len(self._pending) == 1
            else ChangeLog.concat(self._pending)
        )
        self._pending = []
        self._ship(merged)
        return len(merged)

    def _ship(self, log: ChangeLog) -> None:
        """Apply to the tracked index, publish the frame, apply backpressure."""
        from repro_torch.core import plancache

        shed = False
        if self.replica is not None and log.next_lsn - 1 > self.replica.applied_lsn:
            # skip only spans the tracked index already covers (the genesis
            # batch, which the Replica constructor consumed) — compare
            # watermarks, not "is this LSN 0"
            shed = bool(self.replica.apply(log).get("shed_bits"))
        self._publish_frame(BatchFrame(log=log, bucket=plancache.bucket(len(log))))
        if shed:
            # shed adoption is a logged event: the control frame pins the
            # watermark the bitmap shed at, so every consumer adopts it at
            # exactly that point regardless of its poll cadence
            self._publish_frame(ShedFrame(lsn=log.next_lsn - 1))
            self.n_shed_frames += 1
        self.n_batches_published += 1
        self._batches_since_ckpt += 1
        if (
            self.max_lag_batches is not None
            and self._batches_since_ckpt > self.max_lag_batches
            # a checkpoint's own flush must not re-enter checkpointing:
            # the snapshot about to be taken covers this batch anyway
            and not self._in_checkpoint
        ):
            # the constructor guarantees a tracked index + ckpt_dir here
            self.checkpoint(truncate=True)

    # --------------------------------------------------------- checkpoint
    def checkpoint(self, truncate: bool = False) -> dict:
        """Snapshot the tracked state through the checkpoint layer and
        publish its manifest as a stream frame.

        The first call writes a full ``save_checkpoint`` step; every later
        call writes a ``save_checkpoint_delta`` step chained onto the
        previous one (restore folds the chain).  ``truncate=True`` applies
        the bounded-lag retention policy: frames before the *previous*
        checkpoint frame are dropped, so the transport always retains one
        full checkpoint cycle — a replica within one cycle of the head
        still tails batches, anything older must bootstrap from the
        (≤ one cycle old) checkpoint it finds at the stream's start.
        Returns the published ``repro_torch.ckpt.step_manifest``.
        """
        if self.replica is None or self.ckpt_dir is None:
            raise StreamError("checkpointing needs a tracked index + ckpt_dir")
        self._in_checkpoint = True
        try:
            return self._checkpoint(truncate)
        finally:
            self._in_checkpoint = False

    def _checkpoint(self, truncate: bool) -> dict:
        """The checkpoint body (re-entrancy guarded by ``checkpoint``)."""
        from repro_torch.ckpt.checkpoint import (
            save_checkpoint,
            save_checkpoint_delta,
            step_manifest,
        )

        self.flush()
        rep = self.replica
        if not np.array_equal(
            np.asarray(rep.meta.dbitmap, np.uint32),
            np.asarray(rep.result.extract_bitmap, np.uint32),
        ):
            # a shed just adopted a narrower bitmap: realign the standing
            # run to it (one full resort) so the snapshot is
            # self-consistent — state and extraction agree at the watermark
            rep.apply(ChangeLog(self.n_words, start_lsn=rep.applied_lsn + 1))
        step = self._ckpt_step + 1
        state = _state_tree(rep)
        extra = {
            "applied_lsn": rep.applied_lsn,
            "stream_state": True,
            # the snapshot epoch rides the checkpoint: a bootstrapped
            # replica resumes the primary's epoch numbering (round-trip
            # asserted in tests/test_snapshot.py)
            "snapshot_epoch": rep.snapshots.epoch,
        }
        if self._ckpt_step == 0:
            save_checkpoint(self.ckpt_dir, step, state, extra_meta=extra,
                            device=rep.device)
        else:
            save_checkpoint_delta(
                self.ckpt_dir, step, state, base_step=self._ckpt_step,
                extra_meta=extra,
            )
        self._ckpt_step = step
        manifest = step_manifest(self.ckpt_dir, step)
        base_lsn = rep.applied_lsn + 1
        frame = CheckpointFrame(
            ckpt_dir=str(self.ckpt_dir),
            step=step,
            base_lsn=base_lsn,
            log_state=ChangeLog(
                self.n_words,
                start_lsn=base_lsn,
                shed_delete_frac=rep.shed_delete_frac,
                deletes_since_shed=rep.deletes_since_shed,
            ),
        )
        pos = self._publish_frame(frame)
        self._batches_since_ckpt = 0
        if truncate and self._prev_ckpt_pos is not None:
            self.transport.truncate_before(self._prev_ckpt_pos)
        self._prev_ckpt_pos = pos
        return manifest

    @property
    def stats(self) -> dict:
        """Publisher-side counters (shipment, retention, checkpoints)."""
        return {
            "next_lsn": self._next_lsn,
            "wire_seq": self._wire_seq,
            "n_batches_published": self.n_batches_published,
            "n_shed_frames": self.n_shed_frames,
            "batches_since_ckpt": self._batches_since_ckpt,
            "ckpt_step": self._ckpt_step,
            "pending_entries": sum(len(p) for p in self._pending),
            "transport_retained": len(self.transport),
        }


# ---------------------------------------------------------------------------
# replica
# ---------------------------------------------------------------------------


class StreamReplica:
    """The consuming side: tail the transport, stay byte-identical.

    Holds a cursor into the transport and an inner :class:`Replica` (built
    lazily: from the genesis batch, or from a checkpoint frame during
    catch-up).  ``poll()`` drains available frames and folds all pending
    batches through one watermark-triggered incremental rebuild.

    The LSN watermark check makes delivery faults safe: duplicate batches
    are skipped, overlapping batches are sliced to the unseen suffix, and
    a forward gap raises :class:`LsnGapError` unless a checkpoint frame
    bridges it (the retention/catch-up path).

    ``shed_delete_frac`` configures a *local* volume-based shed policy
    and defaults to ``None`` — the recommended mode, where shed adoption
    is driven entirely by the stream's logged :class:`ShedFrame` control
    frames (a shed frame splits the drained span at its watermark and
    the inner replica adopts the refreshed bitmap there).

    ``backend`` and ``device`` (CUDA unless named) are where the inner
    replica rebuilds, and where a bootstrap reconstructs the checkpoint's
    manifest index.

    ``reorder_window`` (default 0 = strict) makes the poller tolerant of
    a reordering wire: a batch arriving *ahead* of the expected LSN is
    held back (up to that many frames) instead of raising
    :class:`LsnGapError` immediately, and is spliced in once the missing
    frames arrive — so a chaos transport that swaps frames within a small
    window heals in-protocol, without a checkpoint bootstrap.  Only when
    the holdback fills without connecting does the gap surface.
    """

    def __init__(
        self,
        transport: Transport,
        backend: str = "cuda",
        device=None,
        shed_delete_frac: float | None = None,
        start_pos: int = 0,
        reorder_window: int = 0,
    ) -> None:
        self.transport = transport
        self.backend = backend
        self.device = resolve_device(device)
        self.shed_delete_frac = shed_delete_frac
        self.pos = int(start_pos)
        self.reorder_window = int(reorder_window)
        self.replica: Replica | None = None
        self._genesis: ChangeLog | None = None
        # holdback buffer for out-of-order batches: start_lsn -> ChangeLog
        self._held: dict[int, ChangeLog] = {}
        self.n_polls = 0
        self.n_batches_applied = 0
        self.n_duplicates = 0
        self.n_rebuilds = 0
        self.n_catchups = 0
        self.n_truncation_jumps = 0
        self.n_shed_adoptions = 0
        self.n_frames_rejected = 0
        self.n_reorder_heals = 0
        self.n_resyncs = 0
        #: walls of the last checkpoint bootstrap: ``restore_s`` (the
        #: checkpoint read, manifest index included) and ``rebuild_s``
        self.last_bootstrap: dict | None = None

    # ------------------------------------------------------------- state
    @property
    def applied_lsn(self) -> int:
        """LSN watermark the standing index is current through (-1 = none)."""
        if self.replica is not None:
            return self.replica.applied_lsn
        if self._genesis is not None:
            return self._genesis.next_lsn - 1
        return -1

    def lag_frames(self) -> int:
        """How many published frames this replica has not read yet."""
        return max(0, self.transport.end() - self.pos)

    def search(self, query_words) -> tuple[bool, int]:
        """Point lookup through the standing index: ``(found, rid)``."""
        if self.replica is None:
            raise StreamError("replica has no index yet (nothing consumed)")
        return self.replica.search(query_words)

    def search_batch(self, query_words):
        """Batched point lookup through the inner replica's pinned
        snapshot: (q, W) keys -> ((q,) found, (q,) rid) — the read
        scale-out form of :meth:`search` (see ``Replica.search_batch``)."""
        if self.replica is None:
            raise StreamError("replica has no index yet (nothing consumed)")
        return self.replica.search_batch(query_words)

    # -------------------------------------------------------------- poll
    def poll(self, max_frames: int | None = None) -> dict:
        """Drain available frames; one incremental rebuild for the span.

        Reads frames from the cursor until the transport runs dry (or
        ``max_frames``): batch frames accumulate into a pending list after
        the LSN watermark check; a checkpoint frame triggers bootstrap
        when the replica is behind its ``base_lsn`` (or has no state yet)
        and is skipped otherwise; a shed control frame splits the span at
        its watermark (flush, adopt, continue).  Each span's batches are
        stitched and folded through ONE ``Replica.apply`` — the
        applied-batch watermark, not the frame count, triggers the
        rebuild.  Returns poll stats (frames seen, batches applied,
        duplicates, catch-ups, shed adoptions, the new watermark;
        ``applies`` lists every span's apply stats, ``apply`` keeps the
        last one).
        """
        seen = 0
        pending: list[ChangeLog] = []
        fail: Exception | None = None
        out = {
            "frames": 0, "applied_batches": 0, "duplicates": 0,
            "catchup": False, "truncated_jump": False, "apply": None,
            "applies": [], "shed_adopted": 0, "frames_rejected": 0,
            "reorder_heals": 0,
        }

        def _flush_pending():
            # a shed frame can split one poll into several spans; "apply"
            # keeps the last span's stats (compat), "applies" all of them
            if pending:
                out["applied_batches"] += len(pending)
                st = self._apply_pending(pending)
                if st is not None:
                    out["applies"].append(st)
                out["apply"] = st
                pending.clear()

        while max_frames is None or seen < max_frames:
            try:
                raw = self.transport.read(self.pos)
            except FrameTruncated:
                # retention passed us by: jump to the oldest retained
                # frame — the protocol guarantees a checkpoint frame leads
                # the retained suffix after a truncation
                self.pos = self.transport.first_pos()
                self.n_truncation_jumps += 1
                out["truncated_jump"] = True
                continue
            if raw is None:
                break
            try:
                frame = decode_frame(raw)
            except (FrameCorrupt, FrameSchemaError) as err:
                # a damaged/undecodable frame: apply the drained good
                # prefix, leave the cursor ON the frame (a re-read may
                # heal transient wire corruption), surface the typed error
                self.n_frames_rejected += 1
                out["frames_rejected"] += 1
                err.pos = self.pos
                fail = err
                break
            seen += 1
            out["frames"] += 1
            if isinstance(frame, ShedFrame):
                # a shed is a span boundary: the state at frame.lsn must
                # adopt the refreshed bitmap *before* later batches fold,
                # or the post-shed full resort lands at the wrong watermark
                _flush_pending()
                if self.replica is not None and self.applied_lsn == frame.lsn:
                    if self.replica.adopt_shed():
                        self.n_shed_adoptions += 1
                        out["shed_adopted"] += 1
                # a frame at a watermark we are already past is stale (the
                # checkpoint state we bootstrapped from was realigned) —
                # skip; one ahead of us cannot happen on a contiguous read
                self.pos += 1
                continue
            if isinstance(frame, CheckpointFrame):
                eff = pending[-1].next_lsn - 1 if pending else self.applied_lsn
                no_state = (
                    self.replica is None
                    and self._genesis is None
                    and not pending
                )
                if no_state or eff + 1 < frame.base_lsn:
                    pending.clear()  # superseded by the checkpoint state
                    self._bootstrap(frame)
                    out["catchup"] = True
                self._drain_held(pending, out)
                self.pos += 1
                continue
            log = frame.log
            expected = self._expected_lsn(pending)
            if expected is None:
                # no state at all: only the stream origin (LSN 0) may start
                # us — anything later means our base was truncated away and
                # a checkpoint frame should have led the retained suffix
                if log.start_lsn != 0:
                    if self._hold(log):
                        self.pos += 1
                        continue
                    fail = LsnGapError(
                        f"no base state and the stream starts at LSN "
                        f"{log.start_lsn}, not 0 — checkpoint frame missing"
                    )
                    break
                pending.append(log)
                self._drain_held(pending, out)
            elif len(log) == 0 and log.start_lsn == expected:
                pass  # heartbeat: empty batch at the watermark, nothing to do
            elif log.next_lsn <= expected:
                self.n_duplicates += 1
                out["duplicates"] += 1
            elif log.start_lsn > expected:
                # ahead of the watermark: an out-of-order wire (or a real
                # gap).  With a reorder window, hold the batch back and
                # keep draining — the missing frames may be right behind
                # it; only a full holdback surfaces as a gap.
                if self._hold(log):
                    self.pos += 1
                    continue
                fail = LsnGapError(
                    f"batch [{log.start_lsn}, {log.next_lsn}) skips past "
                    f"expected LSN {expected} with no checkpoint to bridge"
                )
                break  # apply what we drained first; pos stays on the frame
            else:
                if log.start_lsn < expected:
                    log = log.slice_lsn(expected, log.next_lsn)
                pending.append(log)
                self._drain_held(pending, out)
            self.pos += 1
        _flush_pending()
        self.n_polls += 1
        out["applied_lsn"] = self.applied_lsn
        out["lag_frames"] = self.lag_frames()
        if fail is not None:
            # raised only after the drained good prefix was applied and
            # with the cursor parked on the offending frame — the replica's
            # state is current through every contiguous batch it saw
            raise fail
        return out

    def _hold(self, log: ChangeLog) -> bool:
        """Park an ahead-of-watermark batch in the reorder holdback.

        Returns ``False`` when the window is disabled or full (the caller
        surfaces the gap).  A batch already held at the same start LSN is
        absorbed as a duplicate.
        """
        if self.reorder_window <= 0:
            return False
        if log.start_lsn in self._held:
            self.n_duplicates += 1
            return True
        if len(self._held) >= self.reorder_window:
            return False
        self._held[log.start_lsn] = log
        return True

    def _drain_held(self, pending: list[ChangeLog], out: dict) -> None:
        """Splice held batches that now connect to the watermark."""
        while self._held:
            expected = self._expected_lsn(pending)
            if expected is None:
                return
            lsn0 = min(self._held)
            log = self._held[lsn0]
            if log.start_lsn > expected:
                return
            del self._held[lsn0]
            if log.next_lsn <= expected:
                self.n_duplicates += 1
                out["duplicates"] += 1
                continue
            if log.start_lsn < expected:
                log = log.slice_lsn(expected, log.next_lsn)
            pending.append(log)
            self.n_reorder_heals += 1
            out["reorder_heals"] += 1

    def _expected_lsn(self, pending: list[ChangeLog]) -> int | None:
        """Next LSN the stream must hand us (None before the origin)."""
        if pending:
            return pending[-1].next_lsn
        if self.replica is not None:
            return self.replica.applied_lsn + 1
        if self._genesis is not None:
            return self._genesis.next_lsn
        return None

    def _apply_pending(self, pending: list[ChangeLog]) -> dict | None:
        """Fold drained batches: genesis bring-up or one incremental apply."""
        if self.replica is not None:
            st = (
                self.replica.apply(pending[0])
                if len(pending) == 1
                else self.replica.apply_many(pending)
            )
            self.n_batches_applied += len(pending)
            self.n_rebuilds += 1
            return st
        # no index yet: accumulate the genesis prefix until a row survives
        logs = ([self._genesis] if self._genesis is not None else []) + pending
        genesis = logs[0] if len(logs) == 1 else ChangeLog.concat(logs)
        keep, words, lengths, rids = genesis.fold(np.zeros(0, np.uint32))
        del keep
        if words.shape[0] == 0:
            self._genesis = genesis
            return None
        self.replica = Replica(
            KeySet(words=words, lengths=lengths, rids=rids),
            backend=self.backend,
            device=self.device,
            shed_delete_frac=self.shed_delete_frac,
            applied_lsn=genesis.next_lsn - 1,
        )
        self._genesis = None
        self.n_batches_applied += len(pending)
        self.n_rebuilds += 1
        return {"bring_up": True, "n_keys": words.shape[0]}

    # ----------------------------------------------------------- catch-up
    def _bootstrap(self, frame: CheckpointFrame) -> None:
        """Restore the checkpoint chain; resume tailing at its watermark.

        The restored state is the primary's keyset + *working* metadata at
        ``base_lsn`` plus the shed-volume counter carried in the frame's
        ``log_state`` — constructing the replica from them reproduces,
        byte for byte, the state a never-lagged replica holds at that
        watermark.  The shed *policy* is the replica's own configuration
        (by default ``None``): shed decisions arrive as logged control
        frames, so a bootstrapped consumer and a tailing one adopt them
        at the same watermarks instead of re-deriving them locally.  The
        checkpointed snapshot epoch is resumed, so the bootstrapped
        replica's epoch history continues the primary's numbering.
        """
        from repro_torch.ckpt.checkpoint import restore_checkpoint

        t0 = time.perf_counter()
        state, _stats = restore_checkpoint(
            frame.ckpt_dir, frame.step, _state_like(), backend=self.backend,
            index_device=self.device,
        )
        keyset = KeySet(
            words=np.asarray(state["keyset"]["words"], np.uint32),
            lengths=np.asarray(state["keyset"]["lengths"], np.int32),
            rids=np.asarray(state["keyset"]["rids"], np.uint32),
        )
        meta = DSMeta(
            dbitmap=np.asarray(state["meta"]["dbitmap"], np.uint32),
            varbitmap=np.asarray(state["meta"]["varbitmap"], np.uint32),
            refkey=np.asarray(state["meta"]["refkey"], np.uint32),
            n_words=int(state["meta"]["n_words"]),
        )
        ls = frame.log_state
        t1 = time.perf_counter()
        self.replica = Replica(
            keyset,
            meta=meta,
            backend=self.backend,
            device=self.device,
            shed_delete_frac=self.shed_delete_frac,
            applied_lsn=frame.base_lsn - 1,
            deletes_since_shed=ls.deletes_since_shed,
            snapshot_epoch=int(_stats["meta"].get("snapshot_epoch", 0)),
        )
        self.last_bootstrap = {"restore_s": t1 - t0,
                               "rebuild_s": time.perf_counter() - t1}
        self._genesis = None
        self.n_catchups += 1

    def resync(self) -> bool:
        """Advance the cursor to the next visible checkpoint frame.

        The degradation-ladder escape hatch: when polling is stuck on a
        position that keeps failing (persistent corruption, or a gap the
        reorder window could not bridge because the frame was dropped
        outright), the LSNs parked between the cursor and the next
        checkpoint frame are unrecoverable from the wire — but the
        checkpoint state covers them.  Scan forward from the cursor,
        skipping undecodable frames, and park ON the first checkpoint
        frame found; the next ``poll`` then either bootstraps from it
        (watermark behind its ``base_lsn``) or skips it as stale and
        resumes tailing, both byte-identical paths.  Any held-back
        reordered batches are discarded (the checkpoint supersedes or
        re-covers them).  Returns ``False`` when no checkpoint frame is
        visible yet — the caller should back off and retry after the
        primary's next checkpoint lands.
        """
        pos = max(self.pos, self.transport.first_pos())
        while pos < self.transport.end():
            try:
                raw = self.transport.read(pos)
            except FrameTruncated:
                pos = max(pos + 1, self.transport.first_pos())
                continue
            if raw is None:
                pos += 1  # delayed visibility: scan past, it may firm up
                continue
            try:
                frame = decode_frame(raw)
            except (FrameCorrupt, FrameSchemaError):
                pos += 1
                continue
            if isinstance(frame, CheckpointFrame):
                self.pos = pos
                self._held.clear()
                self.n_resyncs += 1
                return True
            pos += 1
        return False

    @property
    def stats(self) -> dict:
        """Consumer-side counters (applies, duplicates, catch-ups, lag,
        fault-path health: rejected frames, reorder heals, resyncs)."""
        return {
            "applied_lsn": self.applied_lsn,
            "pos": self.pos,
            "lag_frames": self.lag_frames(),
            "n_polls": self.n_polls,
            "n_batches_applied": self.n_batches_applied,
            "n_rebuilds": self.n_rebuilds,
            "n_duplicates": self.n_duplicates,
            "n_catchups": self.n_catchups,
            "n_truncation_jumps": self.n_truncation_jumps,
            "n_shed_adoptions": self.n_shed_adoptions,
            "n_frames_rejected": self.n_frames_rejected,
            "n_reorder_heals": self.n_reorder_heals,
            "n_resyncs": self.n_resyncs,
            "held_batches": len(self._held),
        }
