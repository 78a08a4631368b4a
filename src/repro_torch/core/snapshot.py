"""Versioned, immutable index snapshots with epoch-based publish (reads).

The write path produces: every ``ReconstructionPipeline.run`` /
``run_incremental`` yields a fresh set of device tensors (tree levels,
sorted compressed keys, rid permutation) plus host metadata.  The *read*
path must never observe a half-swapped mixture of two reconstructions —
a tenant's reads in ``repro_torch.serve.tenants`` while its next
``run_incremental`` publishes, or any reader racing a rebuild.  This module
is the seam between the two:

* :class:`IndexSnapshot` freezes one reconstruction into an immutable,
  epoch-stamped artifact: the tree, the DS-metadata, the sorted run, the
  extraction bitmap, and the LSN watermark the state is current through.
  The tensors are the device buffers the pipeline produced, shared, not
  copied: torch tensors are mutable, but no code of this package writes
  a result's tensors in place (every stage, ``run_incremental``
  included, allocates its outputs), so sharing is safe as long as
  callers keep to that.  The host-side metadata is copied at freeze time
  so later in-place mutation by the producer cannot leak in.
* :class:`SnapshotCell` is the publish/acquire protocol — a one-slot
  double buffer.  ``publish`` atomically swaps the current snapshot to
  the next epoch; readers ``acquire`` (pin) the current epoch and
  ``release`` it when done.  A publish never invalidates a pinned
  snapshot: the previous epoch is *retired* and kept alive until its
  last pin drops, so a reader that pinned epoch ``e`` keeps getting
  epoch-``e`` answers even if rebuilds publish ``e+1, e+2, …``
  underneath it — the double-buffering the replica read scale-out needs.

Epochs are dense and monotonically increasing.  Consumers that persist
state (the checkpoint layer) record the epoch next to the watermark and
resume the cell at it, so a bootstrapped replica's snapshot history
continues the primary's numbering rather than restarting at zero.

Concurrency model (the serving contract)
----------------------------------------

The cell is **single-writer, multi-reader**: one thread publishes,
any number of threads pin.  All refcount bookkeeping — the pin table,
the retired-epoch map, every counter — is guarded by one mutex whose
critical sections are a handful of dict operations; nothing heavyweight
ever runs under it.  In particular:

* ``publish`` freezes the result (the metadata deep copies) *outside*
  the lock and only swaps the pointer inside it, so a reader's
  :meth:`~SnapshotCell.acquire` never waits on a rebuild — the read hot
  path is wait-free in the practical sense: it can only contend with
  other few-instruction critical sections, never with reconstruction
  work.
* The backend ``lookup`` a reader runs against its pinned snapshot
  executes entirely outside the lock.
* An epoch is retired at most once and freed exactly once: the publish
  that supersedes it either drops it immediately (no pins) or parks it
  in the retired map, and the *last* release frees it.  Double release
  is detected per-lease (every ``acquire`` returns a one-shot
  :class:`SnapshotPin`) and raises instead of corrupting a concurrent
  reader's refcount.
* :meth:`~SnapshotCell.stats` counters (``acquires``, ``releases``,
  ``retired_epochs``, ``max_concurrent_pins``) are updated inside the
  same critical sections, so they are exact under contention — the
  concurrency tests assert their closed-form values after adversarial
  thread schedules.

Admission control: ``max_lag_epochs`` bounds how far the writer may
fall behind its mutation feed before the cell stops admitting new
reads.  The writer reports its backlog with
:meth:`~SnapshotCell.report_lag` (in epochs, i.e. pending un-rebuilt
batches); while the reported lag exceeds the bound, ``acquire`` either
**sheds** the read (raises :class:`AdmissionShed`, the default) or
**parks** it (blocks until the writer catches up, with an optional
timeout after which it sheds).  Shedding reads under lag is what keeps
a rebuild-starved writer from being starved further by the read side.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator

import numpy as np

if TYPE_CHECKING:  # the pipeline imports this module; keep the cycle lazy
    from .btree import BTree
    from .metadata import DSMeta
    from .pipeline import ReconstructionResult

__all__ = ["AdmissionShed", "IndexSnapshot", "SnapshotPin", "SnapshotCell"]


class AdmissionShed(RuntimeError):
    """A read was shed by admission control (rebuild lag over the bound).

    Raised by :meth:`SnapshotCell.acquire` when the writer-reported lag
    exceeds ``max_lag_epochs`` under the ``"shed"`` policy, or when a
    parked read times out under the ``"park"`` policy.  Callers are
    expected to drop or retry the request — the whole point is that the
    read does *not* run while the writer is drowning.
    """


@dataclass(frozen=True)
class IndexSnapshot:
    """One reconstruction, frozen: epoch-stamped, device-resident, immutable.

    ``tree``/``comp_sorted``/``rid_sorted``/``row_sorted`` are the
    pipeline's device arrays; ``meta`` is the refreshed DS-metadata and
    ``extract_bitmap`` the D-bitmap the compressed run was extracted
    under (both copied at freeze time); ``watermark`` is the LSN the
    state is current through (``None`` when not log-driven).
    """

    epoch: int
    tree: "BTree"
    meta: "DSMeta"
    comp_sorted: object
    rid_sorted: object
    row_sorted: object | None
    extract_bitmap: np.ndarray | None
    watermark: int | None

    @property
    def n_keys(self) -> int:
        """Number of live keys in the snapshot's tree."""
        return int(self.tree.n_keys)

    @staticmethod
    def from_result(result: "ReconstructionResult", epoch: int) -> "IndexSnapshot":
        """Freeze a pipeline result at ``epoch``.

        The device tensors are shared: the pipeline never writes a
        result's tensors in place, so a later ``run``/``run_incremental``
        on the same pipeline leaves a published snapshot's bytes (and
        every tensor's ``_version``) untouched.  The host-side metadata
        is deep-copied so producers that keep mutating
        their working ``DSMeta``/``extract_bitmap`` (the §4.3 insert rule
        runs in place on some consumers) cannot reach into a published
        snapshot.
        """
        from dataclasses import replace as _replace

        meta = result.meta
        frozen_meta = _replace(
            meta,
            dbitmap=np.array(meta.dbitmap, np.uint32, copy=True),
            varbitmap=np.array(meta.varbitmap, np.uint32, copy=True),
            refkey=np.array(meta.refkey, np.uint32, copy=True),
        )
        eb = result.extract_bitmap
        return IndexSnapshot(
            epoch=int(epoch),
            tree=result.tree,
            meta=frozen_meta,
            comp_sorted=result.comp_sorted,
            rid_sorted=result.rid_sorted,
            row_sorted=result.row_sorted,
            extract_bitmap=None if eb is None else np.array(eb, np.uint32, copy=True),
            watermark=result.watermark,
        )

    def lookup(self, backend, queries):
        """Batched point lookup through a backend's ``lookup`` op.

        Convenience for read-path consumers: ``backend`` is any
        ``ExecutionBackend``; returns the op's ``(found, rid)`` pair.
        """
        return backend.lookup(self.tree, queries)


class SnapshotPin:
    """One acquire: a lease on a pinned epoch, released exactly once.

    Every :meth:`SnapshotCell.acquire` mints a fresh lease; the lease —
    not the (shared, epoch-wide) snapshot object — is what ``release``
    consumes, which is how a double release is *detected* instead of
    silently decrementing some other reader's refcount.  Attribute
    access delegates to the pinned :class:`IndexSnapshot` (``.tree``,
    ``.epoch``, ``.lookup(...)`` all work directly), and the lease is a
    context manager for scoped use.
    """

    __slots__ = ("_cell", "_snapshot", "_released")

    def __init__(self, cell: "SnapshotCell", snapshot: IndexSnapshot) -> None:
        self._cell = cell
        self._snapshot = snapshot
        self._released = False

    @property
    def snapshot(self) -> IndexSnapshot:
        """The pinned snapshot this lease holds alive."""
        return self._snapshot

    @property
    def released(self) -> bool:
        """Whether this lease was already released."""
        return self._released

    def release(self) -> None:
        """Drop this lease (exactly once; a second call raises)."""
        self._cell.release(self)

    def __getattr__(self, name):
        # only reached for names not on the lease itself: delegate to the
        # snapshot so pin-holding readers can use it as one
        return getattr(object.__getattribute__(self, "_snapshot"), name)

    def __enter__(self) -> "SnapshotPin":
        """Scoped use: ``with cell.acquire() as snap: ...``."""
        return self

    def __exit__(self, *exc) -> None:
        """Release the lease on scope exit."""
        self.release()

    def __repr__(self) -> str:
        state = "released" if self._released else "held"
        return f"SnapshotPin(epoch={self._snapshot.epoch}, {state})"


class SnapshotCell:
    """The epoch-based publish/acquire protocol (a one-slot double buffer).

    Writers call :meth:`publish` with each finished reconstruction;
    readers wrap their lookups in :meth:`pin` (or hold the
    :class:`SnapshotPin` an explicit :meth:`acquire` returns).  The cell
    retires — but does not drop — the previous snapshot while any reader
    still pins it, which is what lets a rebuild proceed concurrently
    with reads: queries pinned before the swap keep answering from the
    pre-rebuild epoch, queries pinned after it see the new one, and no
    query ever sees a mixture.  The protocol is single-writer,
    multi-reader thread-safe (see the module docstring for the exact
    guarantees and the admission-control knobs).

    ``start_epoch`` seeds the numbering: the first publish lands at
    ``start_epoch + 1`` (the default ``-1`` makes it epoch 0).  A
    checkpoint-restored consumer resumes the cell at the persisted epoch
    so its history continues the producer's.

    ``max_lag_epochs`` (optional) turns on admission control: while the
    writer-reported lag (:meth:`report_lag`) exceeds it, ``acquire``
    sheds (``admission="shed"``, raising :class:`AdmissionShed`) or
    parks (``admission="park"``, blocking until the lag drops;
    ``park_timeout`` seconds at most, then it sheds).
    """

    def __init__(
        self,
        start_epoch: int = -1,
        *,
        max_lag_epochs: int | None = None,
        admission: str = "shed",
        park_timeout: float | None = None,
    ) -> None:
        if admission not in ("shed", "park"):
            raise ValueError(f"admission must be 'shed' or 'park', got {admission!r}")
        if max_lag_epochs is not None and int(max_lag_epochs) < 0:
            raise ValueError(f"max_lag_epochs must be >= 0, got {max_lag_epochs}")
        self._lock = threading.Lock()
        self._lag_ok = threading.Condition(self._lock)
        self._current: IndexSnapshot | None = None
        self._epoch = int(start_epoch)
        self._pins: dict[int, int] = {}
        self._retired: dict[int, IndexSnapshot] = {}
        # admission control
        self.max_lag_epochs = None if max_lag_epochs is None else int(max_lag_epochs)
        self.admission = admission
        self.park_timeout = park_timeout
        self._lag = 0
        # counters — mutated only inside the lock's critical sections, so
        # they are exact under contention (asserted by the concurrency tests)
        self.n_published = 0
        self.n_acquired = 0
        self.n_released = 0
        self.n_shed = 0
        self.n_parked = 0
        self.park_wait_s = 0.0
        self._retired_epochs = 0
        self._outstanding = 0
        self._max_concurrent_pins = 0

    # --------------------------------------------------------------- state
    @property
    def current(self) -> IndexSnapshot | None:
        """The currently published snapshot (``None`` before the first)."""
        return self._current

    @property
    def epoch(self) -> int:
        """Epoch of the current snapshot (``start_epoch`` before any)."""
        return self._epoch

    @property
    def lag_epochs(self) -> int:
        """The writer-reported rebuild lag (see :meth:`report_lag`)."""
        return self._lag

    def pinned_epochs(self) -> list[int]:
        """Epochs with at least one outstanding pin, ascending."""
        with self._lock:
            return sorted(e for e, c in self._pins.items() if c > 0)

    # ------------------------------------------------------------- publish
    def publish(
        self, result: "ReconstructionResult", epoch: int | None = None
    ) -> IndexSnapshot:
        """Freeze ``result`` and atomically swap it in as the next epoch.

        ``epoch`` defaults to ``current + 1`` and must be strictly
        increasing when given explicitly (the checkpoint-resume path).
        The previous snapshot is retired while pinned and dropped once its
        last pin releases; an unpinned previous snapshot is dropped
        immediately (double buffering, not an unbounded history).

        The freeze — the metadata deep copies — runs *outside* the cell's
        mutex; only the pointer swap and the retire bookkeeping run under
        it, so concurrent readers never wait on reconstruction work.
        The cell is single-writer: concurrent publishers are not torn
        (the swap is locked) but the loser of an epoch race gets the
        monotonicity ``ValueError``.
        """
        epoch = self._epoch + 1 if epoch is None else int(epoch)
        snap = IndexSnapshot.from_result(result, epoch)
        with self._lag_ok:
            if epoch <= self._epoch and self._current is not None:
                raise ValueError(
                    f"epoch must increase: publishing {epoch} over {self._epoch}"
                )
            prev = self._current
            self._current = snap
            self._epoch = epoch
            self.n_published += 1
            if prev is not None:
                if self._pins.get(prev.epoch, 0) > 0:
                    self._retired[prev.epoch] = prev
                else:
                    # no reader ever pins it again: freed right here
                    self._retired_epochs += 1
            # a publish can only shrink the backlog — wake parked readers
            # so they re-check the lag bound
            self._lag_ok.notify_all()
        return snap

    # --------------------------------------------------- admission control
    def report_lag(self, lag_epochs: int) -> None:
        """Writer-side backlog report: ``lag_epochs`` pending rebuilds.

        The serving writer calls this as its mutation feed outruns (or
        catches up with) its rebuild loop; ``acquire`` compares the last
        reported value against ``max_lag_epochs``.  Lowering the lag
        wakes parked readers.
        """
        with self._lag_ok:
            self._lag = max(0, int(lag_epochs))
            if self.max_lag_epochs is None or self._lag <= self.max_lag_epochs:
                self._lag_ok.notify_all()

    def _admit_locked(self) -> None:
        """Shed or park the calling reader while the lag is over bound.

        Runs under the lock; ``park`` waits on the condition the writer
        notifies (re-checking, so spurious wakeups are harmless) and
        sheds on timeout.
        """
        if self.max_lag_epochs is None or self._lag <= self.max_lag_epochs:
            return
        if self.admission == "shed":
            self.n_shed += 1
            raise AdmissionShed(
                f"read shed: rebuild lag {self._lag} epochs > "
                f"max_lag_epochs {self.max_lag_epochs}"
            )
        self.n_parked += 1
        t0 = time.perf_counter()
        deadline = None if self.park_timeout is None else t0 + self.park_timeout
        while self._lag > self.max_lag_epochs:
            remaining = None if deadline is None else deadline - time.perf_counter()
            if remaining is not None and remaining <= 0:
                self.park_wait_s += time.perf_counter() - t0
                self.n_shed += 1
                raise AdmissionShed(
                    f"parked read timed out after {self.park_timeout}s: "
                    f"rebuild lag {self._lag} epochs > "
                    f"max_lag_epochs {self.max_lag_epochs}"
                )
            self._lag_ok.wait(timeout=remaining)
        self.park_wait_s += time.perf_counter() - t0

    # ------------------------------------------------------------- readers
    def acquire(self) -> SnapshotPin:
        """Pin the current snapshot; returns a one-shot :class:`SnapshotPin`.

        Raises ``RuntimeError`` before the first publish and
        :class:`AdmissionShed` when admission control sheds the read.
        Every lease must be released exactly once (``pin.release()`` or
        the lease's context manager); prefer the :meth:`pin` context
        manager for scoped reads.  The critical section is a few dict
        operations — a reader never waits on a concurrent rebuild.
        """
        with self._lock:
            self._admit_locked()
            snap = self._current
            if snap is None:
                raise RuntimeError("no snapshot published yet")
            self._pins[snap.epoch] = self._pins.get(snap.epoch, 0) + 1
            self.n_acquired += 1
            self._outstanding += 1
            if self._outstanding > self._max_concurrent_pins:
                self._max_concurrent_pins = self._outstanding
            return SnapshotPin(self, snap)

    def release(self, pin: "SnapshotPin | IndexSnapshot") -> None:
        """Drop one pin; the last release of a retired epoch frees it.

        ``pin`` is normally the :class:`SnapshotPin` lease ``acquire``
        returned: releasing it twice raises, even while other readers
        still pin the same epoch (the double release consumed *this*
        lease, not their refcount).  A raw :class:`IndexSnapshot` is
        also accepted for epoch-level bookkeeping, but it must be a
        snapshot this cell actually published *and* its epoch must have
        outstanding pins — anything else raises instead of silently
        corrupting the refcounts.
        """
        with self._lock:
            if isinstance(pin, SnapshotPin):
                if pin._released:
                    raise RuntimeError(
                        f"double release of pin on epoch {pin._snapshot.epoch}"
                    )
                if pin._cell is not self:
                    raise RuntimeError("pin belongs to a different SnapshotCell")
                pin._released = True
                snap = pin._snapshot
            else:
                snap = pin
                live = (
                    self._current
                    if self._current is not None and snap.epoch == self._current.epoch
                    else self._retired.get(snap.epoch)
                )
                if live is not snap:
                    raise RuntimeError(
                        f"release of epoch {snap.epoch}: not a snapshot this "
                        f"cell currently tracks (double release or foreign "
                        f"snapshot)"
                    )
            n = self._pins.get(snap.epoch, 0)
            if n <= 0:
                raise RuntimeError(f"release of unpinned epoch {snap.epoch}")
            self.n_released += 1
            self._outstanding -= 1
            if n == 1:
                del self._pins[snap.epoch]
                if self._retired.pop(snap.epoch, None) is not None:
                    # the last release of a retired epoch frees it — once
                    self._retired_epochs += 1
            else:
                self._pins[snap.epoch] = n - 1

    @contextmanager
    def pin(self) -> Iterator[SnapshotPin]:
        """``with cell.pin() as snap:`` — acquire/release, exception-safe.

        Yields the :class:`SnapshotPin` lease, which delegates attribute
        access to the pinned snapshot (``snap.tree``, ``snap.epoch``,
        ``snap.lookup(...)``).
        """
        p = self.acquire()
        try:
            yield p
        finally:
            p.release()

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Exact cell counters (taken under the bookkeeping mutex).

        ``acquires``/``releases`` count leases; ``pinned`` is the
        outstanding total and ``max_concurrent_pins`` its high-water
        mark; ``retired`` is the number of superseded epochs still held
        alive by pins, ``retired_epochs`` the cumulative count of
        superseded epochs the cell has freed (each exactly once);
        ``shed``/``parked``/``park_wait_s``/``lag_epochs`` are the
        admission-control counters.  ``n_published``/``n_acquired`` are
        kept as aliases of ``publishes``/``acquires``.
        """
        with self._lock:
            return {
                "epoch": self._epoch,
                "n_published": self.n_published,
                "n_acquired": self.n_acquired,
                "acquires": self.n_acquired,
                "releases": self.n_released,
                "pinned": self._outstanding,
                "max_concurrent_pins": self._max_concurrent_pins,
                "retired": len(self._retired),
                "retired_epochs": self._retired_epochs,
                "shed": self.n_shed,
                "parked": self.n_parked,
                "park_wait_s": self.park_wait_s,
                "lag_epochs": self._lag,
                "max_lag_epochs": self.max_lag_epochs,
            }
