"""Retry/backoff supervision for a stream replica: the degradation ladder.

A copy of the reference's ``replication/supervisor.py``.

``StreamReplica.poll`` is deliberately *mechanism, not policy*: on a
damaged or undecodable frame it applies the drained good prefix, parks the
cursor on the offending frame, and raises a typed error.  This module is
the policy half — :class:`ReplicaSupervisor` wraps ``poll`` in a bounded
retry loop that walks the **degradation ladder**:

1. **re-read** — a :class:`~repro_torch.replication.wire.FrameCorrupt` is
   transient wire damage by definition (the stored frame may be fine), so
   the first retry is immediate: just read the position again.
2. **backoff + retry** — repeated failures back off exponentially
   (``base_delay_s`` · ``factor``^k, capped at ``max_delay_s``, scaled by
   the ``jitter`` hook), with an independent retry budget per failure
   class (corrupt / schema / gap).
3. **resync** — once a class's budget is spent the wire at this position
   is presumed unrecoverable; ``StreamReplica.resync()`` scans forward to
   the next visible checkpoint frame, whose state covers the lost LSNs,
   and the next poll bootstraps from it.
4. **degraded** — no checkpoint visible yet: report ``degraded`` and
   return (the caller keeps pumping; the primary's next checkpoint is the
   cure).  Time spent degraded is metered into ``time_degraded``.
5. **quarantined** — the checkpoint path itself keeps failing at the same
   position (``quarantine_after`` consecutive stuck pumps): stop touching
   the wire and surface ``state="quarantined"`` in :meth:`stats` instead
   of crashing.  ``reset()`` re-arms after operator intervention.

The clock and sleep are injectable, so tests drive the whole ladder —
including multi-second backoff schedules — in microseconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from .stream import FrameCorrupt, FrameSchemaError, LsnGapError, StreamReplica

__all__ = ["SupervisorPolicy", "ReplicaSupervisor"]


def _default_retries() -> dict:
    # schema errors never heal by re-reading (the payload is intact but
    # malformed) — they get the smallest budget; corruption is transient
    # by construction; a gap may close when delayed frames firm up
    return {"corrupt": 3, "schema": 1, "gap": 3}


@dataclass(frozen=True)
class SupervisorPolicy:
    """Tunables for the degradation ladder.

    ``retries`` is the per-failure-class budget *within one pump*;
    ``quarantine_after`` counts consecutive pumps that ended unrecovered
    at the same stream position even though the checkpoint path was
    available; ``jitter`` multiplies each backoff delay (default: no
    jitter — pass e.g. ``lambda: 0.5 + rng.random()`` to decorrelate a
    fleet of replicas hammering a recovering transport).
    """

    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    factor: float = 2.0
    retries: dict = field(default_factory=_default_retries)
    quarantine_after: int = 3
    max_resyncs_per_pump: int = 4
    jitter: Callable[[], float] | None = None


class ReplicaSupervisor:
    """Drives a :class:`StreamReplica` through faults without crashing.

    Parameters
    ----------
    replica: the stream consumer to supervise (anything with ``poll`` /
             ``resync`` / ``pos`` / ``stats`` quacks well enough — tests
             use stubs).
    policy:  the ladder tunables (:class:`SupervisorPolicy`).
    clock:   monotonic time source (injectable for tests).
    sleep:   how to wait out a backoff delay (injectable for tests).

    Health states: ``healthy`` → ``degraded`` (a pump needed the ladder)
    → ``quarantined`` (the ladder kept failing; pumping is suspended
    until :meth:`reset`).  Counters for every rung live in
    :meth:`stats`.
    """

    def __init__(
        self,
        replica: StreamReplica,
        policy: SupervisorPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.replica = replica
        self.policy = policy if policy is not None else SupervisorPolicy()
        self.clock = clock
        self.sleep = sleep
        self.state = "healthy"
        self.n_pumps = 0
        self.n_faulty_pumps = 0
        self.n_retries: dict[str, int] = {}
        self.n_backoffs = 0
        self.n_resyncs = 0
        self.n_quarantines = 0
        self.time_degraded = 0.0
        self._degraded_since: float | None = None
        self._fail_streak = 0
        self._last_fail_pos: int | None = None

    # ------------------------------------------------------------- ladder
    @staticmethod
    def _classify(err: Exception) -> str:
        """Map a poll failure to its retry-budget class."""
        if isinstance(err, FrameCorrupt):
            return "corrupt"
        if isinstance(err, FrameSchemaError):
            return "schema"
        if isinstance(err, LsnGapError):
            return "gap"
        return "gap"  # unknown stream errors get the gap treatment

    def _delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based); first is free."""
        if attempt <= 1:
            return 0.0  # the immediate re-read rung
        p = self.policy
        d = min(p.max_delay_s, p.base_delay_s * p.factor ** (attempt - 2))
        return d * (p.jitter() if p.jitter is not None else 1.0)

    def _enter_degraded(self) -> None:
        if self.state == "healthy":
            self.state = "degraded"
            self._degraded_since = self.clock()

    def _leave_degraded(self) -> None:
        if self.state == "degraded":
            if self._degraded_since is not None:
                self.time_degraded += self.clock() - self._degraded_since
                self._degraded_since = None
            self.state = "healthy"

    # --------------------------------------------------------------- pump
    def pump(self, max_frames: int | None = None) -> dict:
        """One supervised poll: drain what the wire allows, never raise.

        Returns the poll stats on success (plus ``state``/``recovered``);
        on an unrecovered fault, a dict describing where the ladder
        stopped (``error_class``, ``pos``, ``awaiting_checkpoint``).  A
        quarantined supervisor short-circuits without touching the wire.
        """
        self.n_pumps += 1
        if self.state == "quarantined":
            return {"state": "quarantined", "pumped": False,
                    "recovered": False}
        attempts: dict[str, int] = {}
        resyncs = 0
        faulted = False
        checkpoint_seen = False
        while True:
            try:
                out = self.replica.poll(max_frames=max_frames)
            except (FrameCorrupt, FrameSchemaError, LsnGapError) as err:
                faulted = True
                cls = self._classify(err)
                self.n_retries[cls] = self.n_retries.get(cls, 0) + 1
                self._enter_degraded()
                attempts[cls] = attempts.get(cls, 0) + 1
                budget = int(self.policy.retries.get(cls, 0))
                if attempts[cls] <= budget:
                    d = self._delay(attempts[cls])
                    if d > 0:
                        self.n_backoffs += 1
                        self.sleep(d)
                    continue
                # budget spent: climb to the checkpoint rung
                if (
                    resyncs < self.policy.max_resyncs_per_pump
                    and self.replica.resync()
                ):
                    resyncs += 1
                    checkpoint_seen = True
                    self.n_resyncs += 1
                    attempts = {}  # fresh position, fresh budgets
                    continue
                return self._unrecovered(err, cls, checkpoint_seen)
            # poll came back clean
            if faulted:
                self.n_faulty_pumps += 1
            self._leave_degraded()
            self._fail_streak = 0
            self._last_fail_pos = None
            out["state"] = self.state
            out["recovered"] = faulted
            out["resyncs"] = resyncs
            return out

    def _unrecovered(
        self, err: Exception, cls: str, checkpoint_seen: bool
    ) -> dict:
        """Close out a pump the ladder could not clear."""
        self.n_faulty_pumps += 1
        pos = int(getattr(self.replica, "pos", -1))
        if checkpoint_seen:
            # the cure was available and did not take: count the streak
            if self._last_fail_pos == pos:
                self._fail_streak += 1
            else:
                self._fail_streak = 1
            self._last_fail_pos = pos
            if self._fail_streak >= self.policy.quarantine_after:
                self._leave_degraded()
                self.state = "quarantined"
                self.n_quarantines += 1
        # no checkpoint visible: stay degraded and wait for the primary's
        # next checkpoint — deliberately NOT a streak (nothing to retry
        # against), so a laggard cannot quarantine itself while healthy
        # frames are simply still in flight
        return {
            "state": self.state,
            "recovered": False,
            "error_class": cls,
            "error": repr(err),
            "pos": pos,
            "awaiting_checkpoint": not checkpoint_seen,
        }

    # -------------------------------------------------------------- admin
    def reset(self) -> None:
        """Operator re-arm: leave quarantine/degraded, clear the streak.

        Counters are preserved (they are the incident record); only the
        gate state is cleared, so the next :meth:`pump` touches the wire
        again.
        """
        self._leave_degraded()
        self.state = "healthy"
        self._degraded_since = None
        self._fail_streak = 0
        self._last_fail_pos = None

    def stats(self) -> dict:
        """The full health picture: ladder counters + the replica's own
        consumer counters (watermark, rejected frames, resyncs, lag)."""
        out = {
            "state": self.state,
            "n_pumps": self.n_pumps,
            "n_faulty_pumps": self.n_faulty_pumps,
            "n_retries": dict(self.n_retries),
            "n_backoffs": self.n_backoffs,
            "n_resyncs": self.n_resyncs,
            "n_quarantines": self.n_quarantines,
            "time_degraded": self.time_degraded,
            "fail_streak": self._fail_streak,
        }
        rep_stats = getattr(self.replica, "stats", None)
        if isinstance(rep_stats, dict):
            out["replica"] = dict(rep_stats)
        return out
