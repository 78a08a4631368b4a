"""Pluggable stream transports: ordered frame logs a primary appends to.

A copy of the reference's ``replication/transport.py`` (``os`` only).

A transport is the wire of the async replication layer
(`repro_torch.replication.stream`): an **append-only ordered sequence of opaque
byte frames** with explicit positions.  Publishers append; subscribers poll
by position — there is no push, no connection state, and no subscriber
registration, so a replica can detach for hours and resume from its last
position (or discover it has been truncated past and must catch up from a
checkpoint frame).

Two realizations ship:

* :class:`QueueTransport` — an in-memory list.  The unit-test and
  single-process transport; also the reference semantics the protocol
  tests run against.
* :class:`DirectoryTransport` — one file per frame in a spool directory,
  committed with the same atomic-rename protocol the checkpoint layer
  uses.  A reader never sees a partial frame; separate processes (or a
  shared filesystem) can tail the same stream.

Retention: ``truncate_before(pos)`` drops frames below ``pos`` — the
primary's bounded-lag backpressure calls it after publishing a checkpoint
frame, which is what forces laggards onto the catch-up path.  Positions
are **never reused**: after truncation ``first_pos`` advances but ``end``
keeps counting, so a subscriber's cursor comparison stays meaningful.
"""

from __future__ import annotations

import abc
import os
from pathlib import Path

__all__ = ["Transport", "QueueTransport", "DirectoryTransport", "FrameTruncated"]


class Transport(abc.ABC):
    """Append-only ordered frame log with explicit positions.

    Positions are dense integers assigned at publish time, starting at 0.
    ``read`` returns ``None`` past the end (nothing published yet) and
    raises :class:`FrameTruncated` below ``first_pos`` (retention dropped
    the frame) — the two conditions a poller must distinguish: the first
    means *wait*, the second means *catch up from a checkpoint*.
    """

    @abc.abstractmethod
    def publish(self, frame: bytes) -> int:
        """Append one frame; returns the position it was assigned."""

    @abc.abstractmethod
    def read(self, pos: int) -> bytes | None:
        """The frame at ``pos``; ``None`` if not yet published.

        Raises :class:`FrameTruncated` if ``pos`` fell below
        ``first_pos`` (dropped by retention).
        """

    @abc.abstractmethod
    def first_pos(self) -> int:
        """Position of the oldest retained frame (== ``end`` when empty)."""

    @abc.abstractmethod
    def end(self) -> int:
        """One past the newest published position (0 when never written)."""

    @abc.abstractmethod
    def truncate_before(self, pos: int) -> int:
        """Drop retained frames with position < ``pos``; returns #dropped."""

    def __len__(self) -> int:
        return self.end() - self.first_pos()


class FrameTruncated(LookupError):
    """Requested position was dropped by retention — catch up required."""


class QueueTransport(Transport):
    """In-memory transport: a list plus a base offset.

    Single-process only (tests, benchmarks, in-process standbys).  Frames
    are kept as-is; truncation pops from the front and advances the base
    so positions stay stable.
    """

    def __init__(self) -> None:
        self._frames: list[bytes] = []
        self._base = 0

    def publish(self, frame: bytes) -> int:
        """Append one frame; returns its position."""
        self._frames.append(bytes(frame))
        return self._base + len(self._frames) - 1

    def read(self, pos: int) -> bytes | None:
        """The frame at ``pos``, ``None`` past the end."""
        if pos < self._base:
            raise FrameTruncated(f"frame {pos} truncated (first={self._base})")
        i = pos - self._base
        return self._frames[i] if i < len(self._frames) else None

    def first_pos(self) -> int:
        """Oldest retained position."""
        return self._base

    def end(self) -> int:
        """One past the newest position."""
        return self._base + len(self._frames)

    def truncate_before(self, pos: int) -> int:
        """Drop frames below ``pos``; returns how many were dropped."""
        drop = max(0, min(pos, self.end()) - self._base)
        del self._frames[:drop]
        self._base += drop
        return drop


class DirectoryTransport(Transport):
    """One file per frame in a spool directory (atomic-rename commit).

    Frame ``i`` lives at ``<dir>/frame_<i:010d>.bin``; a publisher writes
    to a dot-prefixed temp name and renames, so concurrent readers never
    observe a partial frame (the same commit protocol as the checkpoint
    layer).  ``end`` is recovered by scanning, which also makes the
    transport restartable: a new publisher process resumes numbering from
    what is on disk.
    """

    def __init__(self, root: str | os.PathLike) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # single-writer end counter: publish() is O(1) after the first call
        self._next: int | None = None
        # reader-side cursors: positions are dense, so end/first advance by
        # forward existence probes (amortized O(1) per call) instead of a
        # full directory scan — stays correct under a concurrent writer
        # (end grows) and concurrent truncation (first grows)
        self._end_cache: int | None = None
        self._first_cache: int | None = None

    def _path(self, pos: int) -> Path:
        return self.root / f"frame_{pos:010d}.bin"

    def _positions(self) -> list[int]:
        return sorted(
            int(p.name[6:-4])
            for p in self.root.iterdir()
            if p.name.startswith("frame_") and p.name.endswith(".bin")
        )

    def publish(self, frame: bytes) -> int:
        """Append one frame (write temp file, fsync, atomic rename).

        After the rename the *directory* is fsynced too (best effort):
        the file's data being durable is not enough — the rename itself
        lives in the directory, and without the directory fsync a crash
        can forget a frame a reader already observed as committed.
        """
        pos = self.end() if self._next is None else self._next
        tmp = self.root / f".tmp_frame_{pos:010d}.bin"
        with open(tmp, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        tmp.rename(self._path(pos))
        self._fsync_dir()
        self._next = pos + 1
        return pos

    def _fsync_dir(self) -> None:
        # best effort: directories can't be fsynced on every platform
        # (and O_RDONLY-on-dir is refused on some); durability of the
        # rename is a hardening, not a protocol requirement
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def read(self, pos: int) -> bytes | None:
        """The frame at ``pos``, ``None`` if not yet published.

        Reads the file first and classifies a miss afterwards, so a
        concurrent truncation between the two steps still surfaces as
        ``FrameTruncated`` (catch-up), never as a raw filesystem error.
        """
        try:
            return self._path(pos).read_bytes()
        except FileNotFoundError:
            if pos < self.first_pos():
                raise FrameTruncated(f"frame {pos} truncated") from None
            return None

    def first_pos(self) -> int:
        """Oldest retained position (== ``end`` when the spool is empty)."""
        end = self.end()
        if self._first_cache is None:
            ps = self._positions()
            self._first_cache = ps[0] if ps else end
        while (
            self._first_cache < end
            and not self._path(self._first_cache).exists()
        ):
            self._first_cache += 1  # truncation passed the cursor
        return min(self._first_cache, end)

    def end(self) -> int:
        """One past the newest published position."""
        if self._end_cache is None:
            ps = self._positions()
            self._end_cache = ps[-1] + 1 if ps else self._read_end_marker()
        while self._path(self._end_cache).exists():
            self._end_cache += 1  # a concurrent writer appended
        return self._end_cache

    def _read_end_marker(self) -> int:
        # retention may empty the spool; END records where numbering resumes
        marker = self.root / "END"
        return int(marker.read_text()) if marker.exists() else 0

    def truncate_before(self, pos: int) -> int:
        """Unlink frames below ``pos``; returns how many were dropped."""
        dropped = 0
        end = self.end()
        for i in self._positions():
            if i < pos:
                self._path(i).unlink()
                dropped += 1
        if dropped:
            # END records where numbering resumes if retention emptied the
            # spool; a no-op truncation leaves the marker alone (nothing
            # moved, and rewriting it would churn the spool for no reason)
            (self.root / "END").write_text(str(end))
            self._fsync_dir()
        return dropped
