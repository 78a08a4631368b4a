"""Fault injection for stream transports: seeded chaos plans + a wrapper.

A copy of the reference's ``replication/chaos.py``: a plan and a wrapper
built from the same seed draw the same fault schedule, call for call.

Fast recovery only matters if it is *correct under failure*: the byte
identity contract (`docs/replication.md` §Determinism) has to survive an
adversarial wire, not just the perfectly ordered lossless transports the
tests construct.  :class:`FaultyTransport` wraps any
:class:`~repro_torch.replication.transport.Transport` and injects the classic
delivery faults, each driven by one seeded RNG so a failing schedule is
replayable bit-for-bit from its seed:

================  =======================================================
fault             injection point
================  =======================================================
drop              ``publish``: the frame silently never reaches the wire
duplicate         ``publish``: the frame is appended twice
reorder           ``publish``: frames buffered in a small window and
                  flushed in a permuted order (positions are assigned in
                  the permuted order — LSNs arrive out of order)
corrupt           ``read``: 1+ random bit flips in a *copy* of the frame
                  (re-reads may heal — transient wire damage)
delay             ``read``: the frame pretends not to be published yet
spurious truncate ``read``: a fake ``FrameTruncated`` (poller takes the
                  catch-up jump for nothing)
mid-stream cut    scheduled real ``truncate_before`` at the N-th publish
                  (retention fires at the worst moment)
================  =======================================================

Every injection lands in the **ledger** (`FaultyTransport.ledger` /
`.counts`), so a soak run can report exactly which faults a surviving
replica absorbed.  With an all-zero plan the wrapper is a transparent
pass-through — the transport-contract suite runs it against the same
assertions as the real transports.

``quiesce()`` ends the chaos phase: faults off, the reorder window
flushed — the fault-free drain a soak harness uses to assert every
surviving replica converges byte-identical to the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .transport import FrameTruncated, Transport

__all__ = ["ChaosPlan", "FaultyTransport"]


@dataclass(frozen=True)
class ChaosPlan:
    """One seeded fault schedule: per-op probabilities + scheduled cuts.

    All probabilities default to 0 (transparent pass-through).
    ``truncate_at`` schedules real mid-stream retention: at the i-th
    ``publish`` call (1-based), ``truncate_before(end - keep_last)``
    fires on the inner transport — whatever protocol frames that cuts.
    """

    seed: int = 0
    p_drop_publish: float = 0.0
    p_duplicate: float = 0.0
    p_reorder: float = 0.0
    reorder_window: int = 4
    p_corrupt: float = 0.0
    corrupt_bits: int = 1
    p_delay: float = 0.0
    p_spurious_truncated: float = 0.0
    truncate_at: tuple[tuple[int, int], ...] = field(default_factory=tuple)

    @staticmethod
    def sample(seed: int, n_publishes_hint: int = 40,
               intensity: float = 1.0) -> "ChaosPlan":
        """Draw a random-but-reproducible plan for a soak run.

        Probabilities are drawn from ranges scaled by ``intensity`` and
        kept low enough that a bounded-retry supervisor converges once
        checkpoints flow; about half the sampled plans also schedule one
        mid-stream truncation somewhere past the warm-up publishes.
        """
        r = np.random.default_rng(np.uint64(seed) * np.uint64(0x9E3779B9) + 1)
        s = float(intensity)
        truncate: tuple[tuple[int, int], ...] = ()
        if n_publishes_hint >= 8 and r.random() < 0.5:
            at = int(r.integers(4, max(5, n_publishes_hint - 2)))
            truncate = ((at, int(r.integers(1, 4))),)
        return ChaosPlan(
            seed=int(seed),
            p_drop_publish=float(r.uniform(0, 0.08)) * s,
            p_duplicate=float(r.uniform(0, 0.15)) * s,
            p_reorder=float(r.uniform(0, 0.25)) * s,
            reorder_window=int(r.integers(2, 5)),
            p_corrupt=float(r.uniform(0, 0.12)) * s,
            corrupt_bits=int(r.integers(1, 4)),
            p_delay=float(r.uniform(0, 0.20)) * s,
            p_spurious_truncated=float(r.uniform(0, 0.05)) * s,
            truncate_at=truncate,
        )


class FaultyTransport(Transport):
    """A fault-injecting wrapper around any transport.

    Publish-side faults (drop, duplicate, reorder, scheduled truncation)
    mutate what lands on the inner transport; read-side faults (corrupt,
    delay, spurious truncation) are **transient** — they damage what this
    call returns, never what is stored, so a re-read can heal them
    (exactly the failure mode the supervisor's re-read-once path is for).

    Position contract under chaos: ``publish`` returns the position the
    frame *would* get were the window flushed in order — exact whenever
    no frames are held, best-effort while the reorder window is holding
    frames (the publisher's only positional use is aiming retention,
    which tolerates slack; subscribers order by LSN, not position).

    ``enabled`` gates all injection; :meth:`quiesce` disables faults and
    flushes the reorder window for a fault-free drain.
    """

    def __init__(self, inner: Transport, plan: ChaosPlan | None = None) -> None:
        self.inner = inner
        self.plan = plan if plan is not None else ChaosPlan()
        self.enabled = True
        self.ledger: list[dict] = []
        self.counts: dict[str, int] = {}
        self._rng = np.random.default_rng(np.uint64(self.plan.seed))
        self._window: list[bytes] = []
        self._n_publishes = 0

    # ------------------------------------------------------------- ledger
    def _record(self, fault: str, **detail) -> None:
        self.counts[fault] = self.counts.get(fault, 0) + 1
        self.ledger.append({"fault": fault, "op": self._n_publishes, **detail})

    # ------------------------------------------------------------ publish
    def publish(self, frame: bytes) -> int:
        """Append one frame, subject to the plan's publish-side faults."""
        if not self.enabled:
            return self.inner.publish(frame)
        self._n_publishes += 1
        for at, keep_last in self.plan.truncate_at:
            if at == self._n_publishes:
                self.flush()  # held frames land before the cut, not after
                cut = max(self.inner.end() - int(keep_last), 0)
                dropped = self.inner.truncate_before(cut)
                self._record("scheduled_truncate", pos=cut, dropped=dropped)
        r = self._rng
        predicted = self.inner.end() + len(self._window)
        if r.random() < self.plan.p_drop_publish:
            self._record("drop", predicted_pos=predicted)
            return predicted
        self._window.append(bytes(frame))
        if r.random() < self.plan.p_duplicate:
            self._window.append(bytes(frame))
            self._record("duplicate", predicted_pos=predicted)
        if (
            len(self._window) < self.plan.reorder_window
            and r.random() < self.plan.p_reorder
        ):
            self._record("hold", predicted_pos=predicted,
                         window=len(self._window))
            return predicted
        self._flush_window()
        return predicted

    def _flush_window(self) -> None:
        if not self._window:
            return
        order = list(range(len(self._window)))
        if len(order) > 1:
            order = [int(i) for i in self._rng.permutation(len(order))]
            if order != sorted(order):
                self._record("reorder", n=len(order), order=tuple(order))
        for i in order:
            self.inner.publish(self._window[i])
        self._window.clear()

    def flush(self) -> None:
        """Release held frames to the inner transport (possibly permuted)."""
        self._flush_window()

    def quiesce(self) -> None:
        """End the chaos phase: disable all faults, flush the window."""
        self.enabled = False
        self._flush_window()

    # --------------------------------------------------------------- read
    def read(self, pos: int) -> bytes | None:
        """The frame at ``pos``, subject to the plan's read-side faults."""
        if not self.enabled:
            return self.inner.read(pos)
        r = self._rng
        if r.random() < self.plan.p_spurious_truncated:
            self._record("spurious_truncated", pos=pos)
            raise FrameTruncated(f"frame {pos} truncated (injected)")
        raw = self.inner.read(pos)  # a real FrameTruncated passes through
        if raw is None:
            return None
        if r.random() < self.plan.p_delay:
            self._record("delay", pos=pos)
            return None
        if r.random() < self.plan.p_corrupt:
            damaged = bytearray(raw)
            for _ in range(max(1, self.plan.corrupt_bits)):
                i = int(r.integers(len(damaged)))
                damaged[i] ^= 1 << int(r.integers(8))
            self._record("corrupt", pos=pos, n_bits=self.plan.corrupt_bits)
            return bytes(damaged)
        return raw

    # -------------------------------------------------------- passthrough
    def first_pos(self) -> int:
        """Oldest retained position (inner transport's)."""
        return self.inner.first_pos()

    def end(self) -> int:
        """One past the newest *visible* position (held frames excluded)."""
        return self.inner.end()

    def truncate_before(self, pos: int) -> int:
        """Retention passes through to the inner transport."""
        return self.inner.truncate_before(pos)
