"""Multi-tenant serving: geometry-bucketed arenas + fused cross-tenant reads.

The backend layer's ``lookup_many`` answers T same-geometry snapshots in
one batched call; this module is the serving machinery that keeps a
*fleet* of live tenants shaped for it:

* :class:`TenantRegistry` bin-packs live :class:`IndexSnapshot`\\ s into
  **arenas** — one immutable stacked tree per distinct
  ``tree_geometry`` — as tenants publish and retire.  Every publish pins
  its snapshot's epoch (the ``SnapshotCell`` lease protocol), restacks
  only the affected arena(s), and atomically swaps the tenant→arena
  view, so readers are never blocked and never see a half-migrated
  arena: a rebuild that *changes* a tenant's geometry moves it to a
  different bucket without touching any other arena.
* :class:`MultiTenantEngine` coalesces per-tenant request queues into
  fused cross-tenant batches: requests accumulate until a size or time
  bound trips, then one ``backend.lookup_many`` per touched arena
  answers every tenant's block in a single dispatch — N Python
  dispatches become one, which is where the fan-out throughput comes
  from.
* :class:`SLOAdmissionController` replaces the fixed ``max_lag_epochs``
  bound with latency-target admission: a per-tenant reservoir meters
  each tenant's p99 and an AIMD loop adjusts a per-tenant shed fraction
  to hold the configured tail target — backing off admission when the
  tail overshoots, relaxing when it clears, and never fully starving a
  tenant (a fairness bound forces an admit after ``fairness_limit``
  consecutive sheds; the forced-admit counter is asserted in tests).

Torn/stale safety is inherited, not re-proven: an arena is built from
epoch-pinned snapshots and is itself immutable, so a fused batch answers
every tenant from exactly one ``(snapshot, epoch)`` pair — the same
invariant the single-tenant ``SnapshotCell`` protocol gives one reader,
lifted over the tenant axis.  ``repro_torch.serve.loadgen.run_multitenant_load``
is the closed-loop harness that verifies it under churn.

Requests carry numpy ``uint32`` queries and answers come back as numpy;
the fused batch crosses to the backend's device once per arena as int64
carriers (``core/u32.py``) and its answers cross back once.  The
dispatcher thread launches kernels beside whatever the publishing
threads run on the card; both use the default stream, which orders
them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.btree import stack_trees, tree_geometry
from repro_torch.core.snapshot import AdmissionShed, IndexSnapshot, SnapshotPin
from repro_torch.core.u32 import to_carrier, to_u32

__all__ = [
    "Arena",
    "TenantRegistry",
    "MultiTenantEngine",
    "SLOConfig",
    "SLOAdmissionController",
]


@dataclass(frozen=True)
class Arena:
    """One geometry bucket: T pinned snapshots stacked into one tree.

    Immutable — the registry replaces arenas wholesale, so an in-flight
    fused batch keeps answering from the arena object it grabbed (its
    stacked arrays are independent copies and its ``epochs`` map is
    frozen with it) even while the registry migrates tenants underneath.
    ``slots[tenant]`` is the tenant's row in the stacked tree;
    ``capacity`` is the stack's (power-of-two, no-shrink) tenant axis,
    so joins within capacity keep the arena's shapes.
    """

    geometry: tuple
    tenants: tuple
    slots: dict
    stacked: object
    epochs: dict
    capacity: int


class TenantRegistry:
    """Live tenant snapshots bin-packed into geometry-bucketed arenas.

    Writers (tenant publish/retire) serialize on one mutation lock and
    only restack the arena(s) the tenant belongs to; the tenant→arena
    ``view()`` is an immutable dict swapped atomically after each
    mutation, so the engine's read path is lock-free.  Each tenant's
    snapshot is held alive by a :class:`SnapshotPin` lease until the
    tenant republishes or retires — an arena can therefore never
    reference freed epochs (the zero-torn guarantee's first half; the
    second is arena immutability).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._members: dict[tuple, list] = {}  # geometry -> ordered tenants
        self._tenant_geom: dict = {}
        self._pins: dict = {}  # tenant -> SnapshotPin | None
        self._snaps: dict = {}  # tenant -> IndexSnapshot
        self._arenas: dict[tuple, Arena] = {}
        self._view: dict = {}  # tenant -> Arena, replaced atomically
        self.n_publishes = 0
        self.n_retires = 0
        self.n_migrations = 0
        self.n_restacks = 0

    # ------------------------------------------------------------ mutation
    def publish(self, tenant, source) -> Arena:
        """Join or refresh ``tenant`` with a snapshot; returns its arena.

        ``source`` is a ``SnapshotCell`` (its current epoch is pinned —
        the normal serving wiring, so the cell cannot free the epoch an
        arena still answers from) or a bare :class:`IndexSnapshot` (no
        lease, for static fleets).  A republish at the same geometry
        restacks one arena in place (slot preserved); a geometry change
        migrates the tenant to its new bucket and restacks both arenas —
        readers of every other arena are untouched and never wait.
        """
        if hasattr(source, "acquire"):
            pin: SnapshotPin | None = source.acquire()
            snap = pin.snapshot
        else:
            pin, snap = None, source
        if not isinstance(snap, IndexSnapshot):
            raise TypeError(f"expected SnapshotCell or IndexSnapshot, got {snap!r}")
        geom = tree_geometry(snap.tree)
        with self._lock:
            old_pin = self._pins.get(tenant)
            old_geom = self._tenant_geom.get(tenant)
            self._pins[tenant] = pin
            self._snaps[tenant] = snap
            self._tenant_geom[tenant] = geom
            if old_geom is not None and old_geom != geom:
                self.n_migrations += 1
                self._members[old_geom].remove(tenant)
                self._rebuild_arena_locked(old_geom)
            if tenant not in self._members.setdefault(geom, []):
                self._members[geom].append(tenant)
            arena = self._rebuild_arena_locked(geom)
            self._swap_view_locked()
            self.n_publishes += 1
        if old_pin is not None:
            old_pin.release()
        return arena

    def retire(self, tenant) -> None:
        """Remove ``tenant``; its arena restacks without it.

        The tenant's epoch pin is released after the view swap, so a
        fused batch already in flight on the old arena object still
        answers from intact (copied) arrays; new batches no longer see
        the tenant and the engine sheds its queued requests.
        """
        with self._lock:
            if tenant not in self._tenant_geom:
                raise KeyError(f"unknown tenant {tenant!r}")
            geom = self._tenant_geom.pop(tenant)
            pin = self._pins.pop(tenant)
            self._snaps.pop(tenant)
            self._members[geom].remove(tenant)
            self._rebuild_arena_locked(geom)
            self._swap_view_locked()
            self.n_retires += 1
        if pin is not None:
            pin.release()

    def _rebuild_arena_locked(self, geom: tuple) -> Arena | None:
        """Restack one geometry bucket from its members' pinned trees."""
        members = self._members.get(geom, [])
        if not members:
            self._members.pop(geom, None)
            self._arenas.pop(geom, None)
            return None
        prev = self._arenas.get(geom)
        needed = 1 << max(0, (len(members) - 1).bit_length())
        # no-shrink hysteresis: keep the old capacity so churn at the
        # boundary does not flip the arena's tenant axis
        capacity = max(needed, prev.capacity if prev is not None else 1)
        trees = [self._snaps[t].tree for t in members]
        arena = Arena(
            geometry=geom,
            tenants=tuple(members),
            slots={t: i for i, t in enumerate(members)},
            stacked=stack_trees(trees, capacity=capacity),
            epochs={t: int(self._snaps[t].epoch) for t in members},
            capacity=capacity,
        )
        self._arenas[geom] = arena
        self.n_restacks += 1
        return arena

    def _swap_view_locked(self) -> None:
        self._view = {
            t: self._arenas[g] for t, g in self._tenant_geom.items()
        }

    # ---------------------------------------------------------------- reads
    def view(self) -> dict:
        """The current tenant→arena map (immutable; atomic swap on mutate)."""
        return self._view

    def arena_of(self, tenant) -> Arena | None:
        """The arena currently serving ``tenant`` (``None`` if absent)."""
        return self._view.get(tenant)

    def stats(self) -> dict:
        """Registry counters + per-arena occupancy (taken under the lock)."""
        with self._lock:
            return {
                "n_tenants": len(self._tenant_geom),
                "n_arenas": len(self._arenas),
                "n_publishes": self.n_publishes,
                "n_retires": self.n_retires,
                "n_migrations": self.n_migrations,
                "n_restacks": self.n_restacks,
                "arenas": [
                    {"tenants": len(a.tenants), "capacity": a.capacity}
                    for a in self._arenas.values()
                ],
            }


@dataclass
class SLOConfig:
    """Knobs for :class:`SLOAdmissionController` (see class docstring)."""

    target_p99_us: float
    window: int = 64
    step: float = 0.15
    relax: float = 0.7
    max_shed_frac: float = 0.9
    fairness_limit: int = 16
    reservoir_capacity: int = 1024


@dataclass
class _TenantSLO:
    reservoir: object
    window_buf: list = field(default_factory=list)
    shed_frac: float = 0.0
    acc: float = 0.0
    consec_sheds: int = 0
    n_obs: int = 0
    n_admitted: int = 0
    n_shed: int = 0
    forced_admits: int = 0
    p99_us: float = 0.0


class SLOAdmissionController:
    """Latency-target admission: shed just enough to hold a p99 target.

    The successor of the fixed ``max_lag_epochs`` bound: instead of
    counting rebuild backlog, it meters each tenant's end-to-end request
    latency in a loadgen-style reservoir and closes an AIMD loop on the
    tail — every ``window`` observations the tenant's p99 is compared
    against ``target_p99_us``; overshoot bumps the tenant's shed
    fraction additively, a clear margin (< 0.8x target) decays it
    multiplicatively.  :meth:`admit` spreads sheds evenly with an
    accumulator (no random number per request) and **never starves**: after
    ``fairness_limit`` consecutive sheds a request is force-admitted and
    counted, which is the fairness invariant the tests assert.
    """

    def __init__(self, config: SLOConfig) -> None:
        self.config = config
        self._lock = threading.Lock()
        self._tenants: dict = {}

    def _state(self, tenant) -> _TenantSLO:
        st = self._tenants.get(tenant)
        if st is None:
            from .loadgen import LatencyReservoir

            st = self._tenants[tenant] = _TenantSLO(
                reservoir=LatencyReservoir(
                    self.config.reservoir_capacity, seed=len(self._tenants)
                )
            )
        return st

    def admit(self, tenant) -> bool:
        """Admission verdict for one request (False = shed it)."""
        with self._lock:
            st = self._state(tenant)
            st.acc += st.shed_frac
            if st.acc >= 1.0:
                if st.consec_sheds >= self.config.fairness_limit:
                    # fairness floor: the accumulator owes a shed, but the
                    # tenant has eaten too many in a row — admit anyway
                    st.acc -= 1.0
                    st.forced_admits += 1
                else:
                    st.acc -= 1.0
                    st.consec_sheds += 1
                    st.n_shed += 1
                    return False
            st.consec_sheds = 0
            st.n_admitted += 1
            return True

    def observe(self, tenant, latency_us: float) -> None:
        """Feed one completed request's latency into the tenant's loop.

        The control signal is the p99 of the *last window* of
        observations, not of the whole history — a reservoir over all
        history never forgets a past stall, so a controller fed by it
        saturates its shed fraction permanently; the windowed tail lets
        the loop back off during an overload burst and re-admit the
        moment the tail clears.  The cumulative reservoir rides along
        for reporting.
        """
        with self._lock:
            st = self._state(tenant)
            st.reservoir.record(float(latency_us))
            st.window_buf.append(float(latency_us))
            st.n_obs += 1
            if len(st.window_buf) < self.config.window:
                return
            st.p99_us = float(np.percentile(np.asarray(st.window_buf), 99))
            st.window_buf.clear()
            if st.p99_us > self.config.target_p99_us:
                st.shed_frac = min(
                    self.config.max_shed_frac, st.shed_frac + self.config.step
                )
            elif st.p99_us < 0.8 * self.config.target_p99_us:
                st.shed_frac = max(0.0, st.shed_frac * self.config.relax)

    def stats(self) -> dict:
        """Per-tenant admission state (shed fraction, counts, last p99)."""
        with self._lock:
            return {
                t: {
                    "shed_frac": st.shed_frac,
                    "n_admitted": st.n_admitted,
                    "n_shed": st.n_shed,
                    "forced_admits": st.forced_admits,
                    "p99_us": st.p99_us,
                }
                for t, st in self._tenants.items()
            }


@dataclass
class _Request:
    tenant: object
    queries: np.ndarray
    event: threading.Event = field(default_factory=threading.Event)
    t_enqueue: float = 0.0
    found: np.ndarray | None = None
    rid: np.ndarray | None = None
    epoch: int | None = None
    error: Exception | None = None


class MultiTenantEngine:
    """Per-tenant request queues coalesced into fused cross-tenant batches.

    :meth:`submit` is the blocking read call: it runs SLO admission,
    enqueues the request, and waits for the dispatcher to fuse it into a
    cross-tenant batch — one ``backend.lookup_many`` per touched arena
    answers every queued tenant's block in a single dispatch, then each
    request completes with its tenant's ``(found, rid, epoch)`` slice.
    Micro-batching is time/size-bounded: a batch flushes when its queued
    query count reaches ``max_batch_queries`` or its oldest request has
    waited ``max_delay_s``.  ``auto_dispatch=False`` disables the
    dispatcher thread — tests drive :meth:`flush` explicitly for
    deterministic fusion.

    A tenant retired between submit and flush completes with
    :class:`AdmissionShed` (its queue drains; same-batch tenants are
    unaffected) — the "tenant leaving mid-batch" contract.
    """

    def __init__(
        self,
        registry: TenantRegistry,
        backend,
        *,
        max_batch_queries: int = 1024,
        max_delay_s: float = 0.002,
        slo: SLOAdmissionController | None = None,
        auto_dispatch: bool = True,
    ) -> None:
        self.registry = registry
        self.backend = backend
        self.max_batch_queries = int(max_batch_queries)
        self.max_delay_s = float(max_delay_s)
        self.slo = slo
        self._cond = threading.Condition()
        self._pending: list[_Request] = []
        self._pending_queries = 0
        self._stop = False
        self.n_batches = 0
        self.n_dispatches = 0  # lookup_many calls (one per touched arena)
        self.n_requests = 0
        self.n_slo_shed = 0
        self.served_per_tenant: dict = {}
        self._thread: threading.Thread | None = None
        if auto_dispatch:
            self._thread = threading.Thread(
                target=self._dispatch_loop, daemon=True
            )
            self._thread.start()

    # ---------------------------------------------------------------- reads
    def submit(self, tenant, queries) -> tuple[np.ndarray, np.ndarray, int]:
        """One tenant's batched lookup through the fused path (blocking).

        Returns ``(found, rid, epoch)`` where ``epoch`` is the snapshot
        epoch the answer was computed against (per-epoch oracles verify
        it).  Raises :class:`AdmissionShed` when SLO admission sheds the
        request or the tenant is retired before its batch flushes.
        """
        if self.slo is not None and not self.slo.admit(tenant):
            with self._cond:
                self.n_slo_shed += 1
            raise AdmissionShed(f"SLO admission shed tenant {tenant!r}")
        req = _Request(
            tenant=tenant,
            queries=np.asarray(queries, np.uint32),
            t_enqueue=time.perf_counter(),
        )
        with self._cond:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._pending.append(req)
            self._pending_queries += int(req.queries.shape[0])
            self._cond.notify_all()
        # explicit-flush mode blocks here until another thread calls flush()
        return self._wait(req)

    def _wait(self, req: _Request) -> tuple[np.ndarray, np.ndarray, int]:
        req.event.wait()
        if req.error is not None:
            raise req.error
        if self.slo is not None:
            self.slo.observe(
                req.tenant, (time.perf_counter() - req.t_enqueue) * 1e6
            )
        return req.found, req.rid, req.epoch

    # ----------------------------------------------------------- dispatcher
    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if self._stop and not self._pending:
                    return
                deadline = self._pending[0].t_enqueue + self.max_delay_s
                while (
                    self._pending_queries < self.max_batch_queries
                    and not self._stop
                ):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                # take a bounded chunk: max_batch_queries caps the fused
                # dispatch shape (one request may overshoot), so a backlog
                # drains in bounded pieces instead of coalescing into an
                # arbitrarily large query block.
                # Leftover stays pending; the next loop iteration sees the
                # aged oldest request and flushes again without delay.
                batch: list[_Request] = []
                taken = 0
                while self._pending and taken < self.max_batch_queries:
                    req = self._pending.pop(0)
                    batch.append(req)
                    taken += int(req.queries.shape[0])
                self._pending_queries -= taken
            if batch:
                self._flush_batch(batch)

    def flush(self) -> int:
        """Fuse and answer everything queued right now (explicit mode).

        Returns the number of requests completed.  The deterministic
        twin of the dispatcher thread: tests enqueue from several
        tenants, then flush once and assert a single fused dispatch.
        """
        with self._cond:
            batch = self._pending
            self._pending = []
            self._pending_queries = 0
        if batch:
            self._flush_batch(batch)
        return len(batch)

    def _flush_batch(self, batch: list[_Request]) -> None:
        view = self.registry.view()  # one atomic read for the whole batch
        by_arena: dict[int, tuple[Arena, list[_Request]]] = {}
        for req in batch:
            arena = view.get(req.tenant)
            if arena is None:
                req.error = AdmissionShed(
                    f"tenant {req.tenant!r} retired before its batch flushed"
                )
                req.event.set()
                continue
            by_arena.setdefault(id(arena), (arena, []))[1].append(req)
        for arena, reqs in by_arena.values():
            try:
                self._flush_arena(arena, reqs)
            except Exception as e:  # surfaced on every waiting request
                for req in reqs:
                    req.error = e
                    req.event.set()
        with self._cond:
            self.n_batches += 1
            self.n_requests += len(batch)

    def _flush_arena(self, arena: Arena, reqs: list[_Request]) -> None:
        """One fused ``lookup_many`` answering every request on ``arena``.

        Requests from the same tenant concatenate into that tenant's
        query block (offsets remembered for the scatter-back); tenants
        of the arena with nothing queued ride along as zero-valid rows,
        so tenant ``s``'s block sits at row ``s`` of the fused call.
        """
        per_slot: dict[int, list[_Request]] = {}
        for req in reqs:
            per_slot.setdefault(arena.slots[req.tenant], []).append(req)
        t_rows = max(per_slot) + 1
        counts = {
            s: sum(int(r.queries.shape[0]) for r in rs)
            for s, rs in per_slot.items()
        }
        qmax = max(max(counts.values()), 1)
        w = int(arena.stacked.sorted_full.shape[-1])
        qblock = np.full((t_rows, qmax, w), 0xFFFFFFFF, np.uint32)
        n_valid = np.zeros((t_rows,), np.uint32)
        for s, rs in per_slot.items():
            off = 0
            for r in rs:
                k = int(r.queries.shape[0])
                qblock[s, off : off + k] = r.queries
                off += k
            n_valid[s] = off
        found, rid = self.backend.lookup_many(
            arena.stacked, to_carrier(qblock, self.backend.device), n_valid)
        found = found.cpu().numpy()
        rid = to_u32(rid)
        with self._cond:
            self.n_dispatches += 1
        for s, rs in per_slot.items():
            off = 0
            for r in rs:
                k = int(r.queries.shape[0])
                r.found = found[s, off : off + k].copy()
                r.rid = rid[s, off : off + k].copy()
                r.epoch = arena.epochs[r.tenant]
                off += k
                with self._cond:
                    self.served_per_tenant[r.tenant] = (
                        self.served_per_tenant.get(r.tenant, 0) + 1
                    )
                r.event.set()

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        """Stop the dispatcher after draining everything already queued."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stats(self) -> dict:
        """Engine counters: fused batches, dispatches, per-tenant served."""
        with self._cond:
            return {
                "n_batches": self.n_batches,
                "n_dispatches": self.n_dispatches,
                "n_requests": self.n_requests,
                "n_slo_shed": self.n_slo_shed,
                "pending": len(self._pending),
                "served_per_tenant": dict(self.served_per_tenant),
            }
