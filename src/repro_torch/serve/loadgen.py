"""Closed-loop concurrent serving load generator (reads racing rebuilds).

The snapshot protocol promises that lookups stay servable — torn-free
and epoch-exact — while the index is being rebuilt underneath them.
This module is the harness that *measures* that promise instead of
assuming it: N reader threads issue batched lookups through a shared
:class:`~repro_torch.core.snapshot.SnapshotCell` in a closed loop (each
thread fires its next request the moment the previous one completes —
the classic closed-loop load model, so offered load tracks service
capacity instead of overrunning it), while one writer thread drives
``ReconstructionPipeline.run_incremental(publish_to=cell)`` at a
configurable mutation rate.  Every response is verified, not just
timed:

* **torn-read check** — the ``(found, rid)`` batch is byte-compared
  against the *pinned epoch's* oracle (the host-side truth registered
  for that epoch before it was published).  Churned keys re-enter each
  epoch with rids that encode the epoch number, so a single stale or
  mixed lane flips the comparison.
* **stale-epoch check** — the epoch a request pinned must be at least
  the cell epoch observed just before its ``acquire``: a reader can
  race a publish forward, never backward.

Per-request wall latencies land in fixed-size :class:`LatencyReservoir`
samplers (one per thread — no shared-state contention on the hot path)
and the report aggregates p50/p90/p99, throughput, admission-control
counters (sheds / parks under the ``max_lag_epochs`` bound, see
``repro_torch.core.snapshot``) and exact cell counters.

The same closed loop runs against the serving page table
(:func:`run_pager_load`: ``PagedKVManager.lookup_batch`` from N threads
while a writer allocs/frees pages and folds the journal through
``rebuild_index``) and against multi-tenant arenas
(:func:`run_multitenant_load`: readers submit through a
:class:`~repro_torch.serve.tenants.MultiTenantEngine`, whose dispatcher
fuses the tenants' queues into one ``lookup_many``).

Reader threads and the writer share the device's default stream; every
lookup ends in its copy to the host, which is where a reader waits for
the device.  The harnesses run on CUDA unless the caller names another
device.  The reference's reports also carry ``warm_traces``, the
plan-cache trace delta; the port has no program cache yet (ROADMAP
Queue 1 item 9), so that field is left out.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.index import _rows_v, _v_rows
from repro_torch.core.keyformat import KeySet
from repro_torch.core.pipeline import ReconstructionPipeline
from repro_torch.core.snapshot import AdmissionShed, SnapshotCell
from repro_torch.core.u32 import to_carrier, to_u32

__all__ = [
    "LatencyReservoir",
    "ReaderReport",
    "LoadReport",
    "pooled_percentiles",
    "run_load",
    "run_pager_load",
    "run_multitenant_load",
]

#: churn rids are ``epoch * EPOCH_RID_BASE + slot``: they encode the epoch
EPOCH_RID_BASE = 1 << 17


class LatencyReservoir:
    """Fixed-size uniform sample of a latency stream (Vitter's algorithm R).

    A closed-loop run at serving rates produces far more requests than a
    benchmark should hold in memory; the reservoir keeps a seeded,
    uniformly drawn ``capacity``-sized subset with O(1) per record, so
    percentiles over the sample converge on the stream's.  Single-owner:
    each reader thread records into its own reservoir and the report
    merges the samples afterwards.
    """

    def __init__(self, capacity: int = 4096, seed: int = 0) -> None:
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.float64)
        self.n_seen = 0
        self._rng = np.random.default_rng(seed)

    def record(self, value: float) -> None:
        """Offer one observation (reservoir-samples past capacity)."""
        i = self.n_seen
        self.n_seen += 1
        if i < self.capacity:
            self._buf[i] = value
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self.capacity:
            self._buf[j] = value

    def samples(self) -> np.ndarray:
        """The retained sample (a copy, at most ``capacity`` long)."""
        return self._buf[: min(self.n_seen, self.capacity)].copy()


def _percentiles(samples: np.ndarray, ps=(50, 90, 99)) -> dict[str, float]:
    """p50/p90/p99 (µs) of a pooled sample array (zeros when empty)."""
    if samples.size == 0:
        return {f"p{p}_us": 0.0 for p in ps}
    return {f"p{p}_us": float(np.percentile(samples, p)) for p in ps}


def pooled_percentiles(reservoirs, ps=(50, 90, 99)) -> dict[str, float]:
    """Stream-weighted percentiles across per-thread reservoirs.

    Each reservoir is a uniform sample of *its own thread's* stream, so
    one retained sample stands for ``n_seen / len(samples)`` stream
    observations.  Concatenating the raw samples unweighted overweights
    slow threads — a thread that completed 8 requests contributes the
    same sample mass as one that completed 10000, dragging the pooled
    p99 toward the slow thread's tail.  Weighted nearest-rank instead:
    sort the pooled values, each carrying its per-thread weight, and
    read each percentile off the cumulative weight — equivalent to
    percentiles over the union of the original streams.
    """
    vals, wts = [], []
    for res in reservoirs:
        s = res.samples()
        if s.size == 0:
            continue
        vals.append(s)
        wts.append(np.full(s.size, res.n_seen / s.size, np.float64))
    if not vals:
        return {f"p{p}_us": 0.0 for p in ps}
    v = np.concatenate(vals)
    w = np.concatenate(wts)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cw = np.cumsum(w)
    out = {}
    for p in ps:
        idx = int(np.searchsorted(cw, p / 100.0 * cw[-1], side="left"))
        out[f"p{p}_us"] = float(v[min(idx, v.size - 1)])
    return out


@dataclass
class ReaderReport:
    """One reader thread's closed-loop tally (verified, not just timed)."""

    n_requests: int = 0
    n_shed: int = 0
    torn_reads: int = 0
    stale_epochs: int = 0
    min_epoch: int | None = None
    max_epoch: int | None = None
    errors: list = field(default_factory=list)
    reservoir: LatencyReservoir = field(default_factory=LatencyReservoir)

    def saw_epoch(self, epoch: int) -> None:
        """Track the epoch span this reader actually served from."""
        if self.min_epoch is None or epoch < self.min_epoch:
            self.min_epoch = epoch
        if self.max_epoch is None or epoch > self.max_epoch:
            self.max_epoch = epoch


@dataclass
class LoadReport:
    """Aggregated result of one closed-loop run (see :func:`run_load`)."""

    n_readers: int
    duration_s: float
    batch: int
    n_requests: int
    n_shed: int
    torn_reads: int
    stale_epochs: int
    epochs_published: int
    lookups_per_s: float
    p50_us: float
    p90_us: float
    p99_us: float
    unloaded_p50_us: float
    cell_stats: dict
    readers: list[ReaderReport]
    errors: list

    def to_row(self) -> dict:
        """Flat JSON-ready dict (benchmark row / CI gate input)."""
        return {
            "n_readers": self.n_readers,
            "duration_s": self.duration_s,
            "batch": self.batch,
            "n_requests": self.n_requests,
            "n_shed": self.n_shed,
            "torn_reads": self.torn_reads,
            "stale_epochs": self.stale_epochs,
            "epochs_published": self.epochs_published,
            "lookups_per_s": self.lookups_per_s,
            "p50_us": self.p50_us,
            "p90_us": self.p90_us,
            "p99_us": self.p99_us,
            "unloaded_p50_us": self.unloaded_p50_us,
            "max_concurrent_pins": self.cell_stats["max_concurrent_pins"],
            "sheds": self.cell_stats["shed"],
            "parked": self.cell_stats["parked"],
            "retired_epochs": self.cell_stats["retired_epochs"],
        }


def _probe_keyset(rng, n_keys: int, n_words: int) -> KeySet:
    """A masked-random keyset (realistic few-distinction-bit tables)."""
    words = rng.integers(0, 2**32, size=(n_keys, n_words), dtype=np.uint32)
    words &= np.uint32(0x00FF0F0F)
    # dedupe: churn bookkeeping needs one rid per distinct key.  Rows as
    # big-endian bytes sort in the word order, so this is the reference's
    # ``np.unique(words, axis=0)``, a few times faster at millions of keys
    words = _v_rows(np.unique(_rows_v(words)), n_words)
    n = words.shape[0]
    return KeySet(
        words=words,
        lengths=np.full(n, n_words * 4, np.int32),
        rids=np.arange(n, dtype=np.uint32),
    )


def _expected_answers(
    truth: dict, probe_keys: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(found, rid) oracle for the probe batch under the host truth dict."""
    q = probe_keys.shape[0]
    found = np.zeros(q, bool)
    rid = np.full(q, 0xFFFFFFFF, np.uint32)
    for i in range(q):
        r = truth.get(tuple(int(w) for w in probe_keys[i]))
        if r is not None:
            found[i] = True
            rid[i] = r
    return found, rid


def _probe_batch(
    words_h: np.ndarray, batch: int, mutation_batch: int
) -> tuple[int, np.ndarray, np.ndarray]:
    """``(churn_lo, probe_idx, probe_keys)``: the probe batch of a churned
    table of ``n`` distinct keys.

    Stable keys, churn-eligible keys, and guaranteed misses: indices below
    ``churn_lo`` are never churned, so those probe lanes stay constant-rid
    hits; lanes in the churn window change rid per epoch; every fifth lane
    is xor'd with bit 4, which is outside the key mask, so it can never
    collide with a real (current or churned) key and misses in every epoch.
    """
    n = words_h.shape[0]
    churn_lo = max(1, min(batch, n - mutation_batch))
    probe_idx = np.concatenate(
        [
            np.arange(0, batch // 2, dtype=np.int64) % churn_lo,
            churn_lo + np.arange(batch - batch // 2, dtype=np.int64)
            % max(1, n - churn_lo),
        ]
    )
    probe_keys = words_h[probe_idx].copy()
    probe_keys[::5] ^= np.uint32(0x10)
    return churn_lo, probe_idx, probe_keys


def _churn(words_h, tags, churn_lo: int, wrng, mutation_batch: int, next_epoch: int):
    """One writer cycle's change set: redraw ``mutation_batch`` keys of the
    churn window (delete, then re-insert the same key under a fresh rid
    that encodes ``next_epoch``); key population and tree geometry stay
    constant.

    ``tags[i]`` is the original key id of base row ``i``; the fold keeps
    the surviving rows, then appends the delta, so the victims move to the
    tail.  Returns ``(victims, keep_rows, delta, new_tags)``.
    """
    n, n_words = words_h.shape
    victims = churn_lo + wrng.choice(
        n - churn_lo, size=min(mutation_batch, n - churn_lo), replace=False
    )
    keep = ~np.isin(tags, victims)
    new_rids = (
        np.uint32(next_epoch * EPOCH_RID_BASE)
        + np.arange(len(victims), dtype=np.uint32)
    )
    delta = KeySet(
        words=words_h[victims],
        lengths=np.full(len(victims), n_words * 4, np.int32),
        rids=new_rids,
    )
    return victims, keep, delta, np.concatenate([tags[keep], victims])


def run_load(
    *,
    backend: str = "cuda",
    device=None,
    n_keys: int = 16384,
    n_words: int = 2,
    batch: int = 256,
    n_readers: int = 8,
    duration_s: float = 2.0,
    mutation_batch: int = 64,
    mutation_period_s: float = 0.0,
    target_mutation_period_s: float | None = None,
    max_lag_epochs: int | None = None,
    admission: str = "shed",
    park_timeout: float | None = 0.05,
    seed: int = 0,
    reservoir_capacity: int = 4096,
    warmup_cycles: int = 1,
) -> LoadReport:
    """Closed-loop readers vs. a live incremental-rebuild writer.

    Builds an ``n_keys`` index on ``backend`` (``"cuda"`` or ``"torch"``)
    and ``device`` (CUDA unless named), publishes it into a shared
    :class:`SnapshotCell`, then runs ``n_readers`` threads each looping
    *acquire → batched lookup → verify → release* for ``duration_s``
    while the writer thread redraws ``mutation_batch`` keys per cycle
    (rids re-minted to encode the epoch) and folds them through
    ``run_incremental(publish_to=cell)`` every ``mutation_period_s``
    seconds (0 = flat out).  Key population and tree geometry stay
    constant; ``warmup_cycles`` writer cycles run before the readers
    start.  The probe batch lives on the device.

    ``max_lag_epochs``/``admission``/``park_timeout`` configure the
    cell's admission control; ``target_mutation_period_s`` (default:
    ``mutation_period_s``) is the feed rate the writer *owes* — its lag
    report is how many owed cycles its rebuilds have fallen behind, so
    a writer that cannot keep up trips the bound and sheds readers.

    Every response is byte-checked against its pinned epoch's oracle
    (torn reads) and its pinned epoch is checked against the epoch
    observed before acquire (stale epochs); both counts must be zero on
    a healthy protocol and the report carries them per reader.  The
    oracle's truth holds only the keys the probe batch can hit, which
    gives every probe lane the answer the whole table's truth would.
    """
    from repro_torch.backends import get_backend

    rng = np.random.default_rng(seed)
    ks = _probe_keyset(rng, n_keys, n_words)
    n = ks.n
    backend_obj = get_backend(backend, device=device)
    pipe = ReconstructionPipeline(backend=backend, device=backend_obj.device)
    cell = SnapshotCell(
        max_lag_epochs=max_lag_epochs,
        admission=admission,
        park_timeout=park_timeout,
    )

    words_h = np.asarray(ks.words)
    churn_lo, probe_idx, probe_keys = _probe_batch(words_h, batch, mutation_batch)
    # host truth: key tuple -> rid of every key a probe lane can hit,
    # mirrored by every publish's oracle
    truth = {
        tuple(int(w) for w in words_h[i]): int(ks.rids[i])
        for i in np.unique(probe_idx)
    }
    oracles: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def register_oracle(epoch: int) -> None:
        oracles[epoch] = _expected_answers(truth, probe_keys)

    register_oracle(cell.epoch + 1)
    cur = pipe.run(ks, publish_to=cell)
    base = ks

    q_dev = to_carrier(probe_keys, backend_obj.device)

    def one_lookup(tree):
        # the copy to the host waits for the device
        f, r = backend_obj.lookup(tree, q_dev)
        return f.cpu().numpy().astype(bool), to_u32(r)

    # ------------------------------------------------------------ writer
    stop = threading.Event()
    writer_errors: list = []
    wrng = np.random.default_rng(seed + 1)
    target_period = (
        mutation_period_s
        if target_mutation_period_s is None
        else target_mutation_period_s
    )
    tags = np.arange(n, dtype=np.int64)

    def writer_cycle():
        nonlocal cur, base, tags
        next_epoch = cell.epoch + 1
        victims, keep, delta, tags = _churn(
            words_h, tags, churn_lo, wrng, mutation_batch, next_epoch
        )
        for v, r in zip(victims, delta.rids):
            key = tuple(int(w) for w in words_h[v])
            if key in truth:
                truth[key] = int(r)
        register_oracle(next_epoch)
        cur, base = pipe.run_incremental(
            cur, base, delta, keep_rows=keep, meta=cur.meta, publish_to=cell
        )

    def writer_loop():
        t_start = time.perf_counter()
        cycles = 0
        try:
            while not stop.is_set():
                writer_cycle()
                cycles += 1
                # owed-minus-done backlog: the lag report admission reads
                if target_period and target_period > 0:
                    owed = (time.perf_counter() - t_start) / target_period
                    cell.report_lag(int(max(0.0, owed - cycles)))
                else:
                    cell.report_lag(0)
                if mutation_period_s > 0:
                    stop.wait(mutation_period_s)
        except Exception as e:  # pragma: no cover - surfaced in the report
            writer_errors.append(repr(e))
            stop.set()

    # ------------------------------------------------------------ readers
    def reader_loop(report: ReaderReport):
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                epoch_before = cell.epoch
                try:
                    pin = cell.acquire()
                except AdmissionShed:
                    report.n_shed += 1
                    stop.wait(0.001)  # shed backoff: don't spin the lock
                    continue
                try:
                    f, r = one_lookup(pin.tree)
                finally:
                    pin.release()
                report.reservoir.record((time.perf_counter() - t0) * 1e6)
                report.n_requests += 1
                report.saw_epoch(pin.snapshot.epoch)
                if pin.snapshot.epoch < epoch_before:
                    report.stale_epochs += 1
                exp_f, exp_r = oracles[pin.snapshot.epoch]
                if not (np.array_equal(f, exp_f) and np.array_equal(r, exp_r)):
                    report.torn_reads += 1
        except Exception as e:  # pragma: no cover - surfaced in the report
            report.errors.append(repr(e))

    # ------------------------------------------------- warmup + baseline
    one_lookup(cell.current.tree)
    for _ in range(max(warmup_cycles, 1)):
        writer_cycle()
    one_lookup(cell.current.tree)
    # unloaded closed-loop baseline: one thread, no writer — the
    # denominator of the machine-neutral tail-latency ratio
    unloaded = []
    for _ in range(16):
        t0 = time.perf_counter()
        one_lookup(cell.current.tree)
        unloaded.append((time.perf_counter() - t0) * 1e6)
    unloaded_p50 = float(np.percentile(np.asarray(unloaded), 50))

    reports = [
        ReaderReport(reservoir=LatencyReservoir(reservoir_capacity, seed + 10 + i))
        for i in range(n_readers)
    ]
    threads = [
        threading.Thread(target=reader_loop, args=(rep,), daemon=True)
        for rep in reports
    ]
    wt = threading.Thread(target=writer_loop, daemon=True)
    t_run0 = time.perf_counter()
    for t in threads:
        t.start()
    wt.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    wt.join(timeout=30.0)
    wall = time.perf_counter() - t_run0

    pcts = pooled_percentiles([rep.reservoir for rep in reports])
    n_requests = sum(rep.n_requests for rep in reports)
    errors = writer_errors + [e for rep in reports for e in rep.errors]
    return LoadReport(
        n_readers=n_readers,
        duration_s=wall,
        batch=len(probe_keys),
        n_requests=n_requests,
        n_shed=sum(rep.n_shed for rep in reports),
        torn_reads=sum(rep.torn_reads for rep in reports),
        stale_epochs=sum(rep.stale_epochs for rep in reports),
        epochs_published=cell.stats()["n_published"],
        lookups_per_s=n_requests * len(probe_keys) / max(wall, 1e-9),
        unloaded_p50_us=unloaded_p50,
        cell_stats=cell.stats(),
        readers=reports,
        errors=errors,
        **pcts,
    )


def run_pager_load(
    *,
    backend: str = "cuda",
    device=None,
    n_pages: int = 4096,
    page_tokens: int = 16,
    n_seqs: int = 32,
    pages_per_seq: int = 8,
    n_readers: int = 4,
    duration_s: float = 1.0,
    rebuild_period_s: float = 0.0,
    max_lag_epochs: int | None = None,
    admission: str = "shed",
    seed: int = 0,
) -> dict:
    """Closed-loop page gets racing live pager mutation + rebuilds.

    The serving-side twin of :func:`run_load`: readers hammer
    ``PagedKVManager.lookup_batch`` (``backend`` on ``device``, CUDA
    unless named) over a fixed probe set of ``(seq_id, page_no)`` pairs
    while the writer thread frees and re-allocates one sequence per cycle
    and folds the journal through ``rebuild_index`` — each rebuild
    publishes the next epoch into the pager's cell.  Responses are
    checked against the per-epoch oracle of the page table (registered
    before each publish), so a torn or stale probe is a counted failure,
    not a flake.  Returns a flat stats dict (requests, torn/stale counts,
    sheds, epochs, the measured wall and gets per second, p50/p90/p99).
    """
    from repro_torch.serve.pager import PagedKVManager

    pm = PagedKVManager(
        n_pages=n_pages,
        page_tokens=page_tokens,
        backend=backend,
        device=device,
        read_through_dirty=True,
        max_lag_epochs=max_lag_epochs,
        admission=admission,
    )
    for s in range(n_seqs):
        pm.pages_for(s, pages_per_seq * page_tokens)
    pm.rebuild_index()

    probe = np.asarray(
        [(s, p) for s in range(n_seqs) for p in range(pages_per_seq)][:256],
        np.uint32,
    )
    oracles: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def register_oracle(epoch: int) -> None:
        found = np.zeros(len(probe), bool)
        rid = np.full(len(probe), 0xFFFFFFFF, np.uint32)
        for i, (s, p) in enumerate(probe):
            phys = pm._table.get((int(s), int(p)))
            if phys is not None:
                found[i] = True
                rid[i] = phys
        oracles[epoch] = (found, rid)

    register_oracle(pm._snapshots.epoch)
    pm.lookup_batch(probe)  # warm the probe path

    stop = threading.Event()
    errors: list = []
    counts = {"requests": 0, "torn": 0, "stale": 0, "shed": 0}
    lock = threading.Lock()
    reservoirs = [LatencyReservoir(2048, seed + i) for i in range(n_readers)]

    def reader(idx: int):
        res = reservoirs[idx]
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                epoch_before = pm._snapshots.epoch
                try:
                    found, rid, epoch = pm.lookup_batch_versioned(probe)
                except AdmissionShed:
                    with lock:
                        counts["shed"] += 1
                    stop.wait(0.001)  # shed backoff: don't spin the lock
                    continue
                res.record((time.perf_counter() - t0) * 1e6)
                exp_f, exp_r = oracles[epoch]
                torn = not (
                    np.array_equal(found, exp_f) and np.array_equal(rid, exp_r)
                )
                with lock:
                    counts["requests"] += 1
                    if torn:
                        counts["torn"] += 1
                    if epoch < epoch_before:
                        counts["stale"] += 1
        except Exception as e:  # pragma: no cover - surfaced in the report
            errors.append(repr(e))

    wrng = np.random.default_rng(seed + 99)

    def writer():
        try:
            while not stop.is_set():
                victim = int(wrng.integers(0, n_seqs))
                pm.free_seq(victim)
                pm.pages_for(victim, pages_per_seq * page_tokens)
                register_oracle(pm._snapshots.epoch + 1)
                pm.rebuild_index()
                if rebuild_period_s > 0:
                    stop.wait(rebuild_period_s)
        except Exception as e:  # pragma: no cover - surfaced in the report
            errors.append(repr(e))
            stop.set()

    threads = [
        threading.Thread(target=reader, args=(i,), daemon=True)
        for i in range(n_readers)
    ]
    wt = threading.Thread(target=writer, daemon=True)
    t_run0 = time.perf_counter()
    for t in threads:
        t.start()
    wt.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    wt.join(timeout=30.0)
    wall = time.perf_counter() - t_run0

    pcts = pooled_percentiles(reservoirs)
    return {
        "n_readers": n_readers,
        "n_requests": counts["requests"],
        "torn_reads": counts["torn"],
        "stale_epochs": counts["stale"],
        "n_shed": counts["shed"],
        "epochs_published": pm._snapshots.stats()["n_published"],
        "snapshot": pm._snapshots.stats(),
        "errors": errors,
        "duration_s": wall,
        "lookups_per_s": counts["requests"] * len(probe) / max(wall, 1e-9),
        **pcts,
    }


def _probe_keyset_exact(rng, n_keys: int, n_words: int) -> KeySet:
    """A masked-random keyset with *exactly* ``n_keys`` distinct keys.

    The multi-tenant arena buckets tenants by tree geometry, which is a
    function of the key count — every tenant in one arena must hold the
    same ``n``.  Draw an oversized masked pool, dedupe, and slice.
    """
    pool = rng.integers(0, 2**32, size=(2 * n_keys + 64, n_words), dtype=np.uint32)
    pool &= np.uint32(0x00FF0F0F)
    pool = np.unique(pool, axis=0)
    if pool.shape[0] < n_keys:  # pragma: no cover - masked space is ~2^32
        raise ValueError(f"masked pool too small: {pool.shape[0]} < {n_keys}")
    words = pool[rng.permutation(pool.shape[0])[:n_keys]]
    return KeySet(
        words=words,
        lengths=np.full(n_keys, n_words * 4, np.int32),
        rids=np.arange(n_keys, dtype=np.uint32),
    )


def run_multitenant_load(
    *,
    backend: str = "cuda",
    device=None,
    n_tenants: int = 4,
    n_keys: int = 2048,
    n_words: int = 2,
    batch: int = 128,
    n_readers: int = 4,
    duration_s: float = 1.5,
    mutation_batch: int = 48,
    mutation_period_s: float = 0.0,
    target_p99_us: float | None = None,
    slo_window: int = 64,
    fairness_limit: int = 16,
    max_delay_s: float = 0.002,
    max_batch_queries: int = 4096,
    seed: int = 0,
) -> dict:
    """Closed-loop multi-tenant readers vs. per-tenant churn writers.

    ``n_tenants`` same-geometry indexes (exactly ``n_keys`` each) on
    ``backend`` (``"cuda"`` or ``"torch"``) and ``device`` (CUDA unless
    named) publish into per-tenant :class:`SnapshotCell`\\ s and join one
    :class:`~repro_torch.serve.tenants.TenantRegistry` arena;
    ``n_readers`` threads round-robin over the tenants submitting probe
    batches through a
    :class:`~repro_torch.serve.tenants.MultiTenantEngine`, whose
    dispatcher fuses the cross-tenant queues into single ``lookup_many``
    dispatches.  One writer thread churns the tenants round-robin —
    per-tenant delete+reinsert with epoch-coded rids, key population and
    geometry constant.  Before the timed window every tenant takes one
    writer cycle and one warm submit.

    The reference's report also carries ``warm_traces``, the plan-cache
    trace delta; the port has no program cache yet (ROADMAP Queue 1 item
    9), so that field, and the reference's per-bucket ``lookup_many``
    warm-up, are left out.

    Every response is verified against its ``(tenant, epoch)`` oracle
    registered before that epoch published (torn check), and its epoch
    must not precede the arena epoch observed before submit (stale
    check).  ``target_p99_us`` turns on the
    :class:`~repro_torch.serve.tenants.SLOAdmissionController`: sheds and
    forced admits land in the report, and ``served_per_tenant`` lets the
    caller assert no tenant starved.
    """
    from repro_torch.backends import get_backend
    from repro_torch.serve.tenants import (
        MultiTenantEngine,
        SLOAdmissionController,
        SLOConfig,
        TenantRegistry,
    )

    backend_obj = get_backend(backend, device=device)
    registry = TenantRegistry()
    slo = (
        None
        if target_p99_us is None
        else SLOAdmissionController(
            SLOConfig(
                target_p99_us=float(target_p99_us),
                window=slo_window,
                fairness_limit=fairness_limit,
            )
        )
    )

    # ------------------------------------------------ per-tenant state
    tenants = list(range(n_tenants))
    cells, pipes, states, probes = {}, {}, {}, {}
    oracles: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}

    for t in tenants:
        rng = np.random.default_rng(seed + 1000 * (t + 1))
        ks = _probe_keyset_exact(rng, n_keys, n_words)
        words_h = np.asarray(ks.words)
        truth = {
            tuple(int(w) for w in words_h[i]): int(ks.rids[i])
            for i in range(n_keys)
        }
        churn_lo, _, probe_keys = _probe_batch(words_h, batch, mutation_batch)
        probes[t] = probe_keys

        cell = SnapshotCell()
        pipe = ReconstructionPipeline(backend=backend, device=backend_obj.device)
        oracles[(t, cell.epoch + 1)] = _expected_answers(truth, probe_keys)
        cur = pipe.run(ks, publish_to=cell)
        cells[t], pipes[t] = cell, pipe
        states[t] = {
            "cur": cur,
            "base": ks,
            "tags": np.arange(n_keys, dtype=np.int64),
            "truth": truth,
            "words": words_h,
            "churn_lo": churn_lo,
            "wrng": np.random.default_rng(seed + 2000 * (t + 1)),
        }
        registry.publish(t, cell)

    engine = MultiTenantEngine(
        registry,
        backend_obj,
        max_batch_queries=max_batch_queries,
        max_delay_s=max_delay_s,
        slo=slo,
    )

    # ------------------------------------------------------------ writer
    stop = threading.Event()
    writer_errors: list = []

    def writer_cycle(t: int) -> None:
        st = states[t]
        cell = cells[t]
        next_epoch = cell.epoch + 1
        _, keep, delta, st["tags"] = _churn(
            st["words"], st["tags"], st["churn_lo"], st["wrng"], mutation_batch,
            next_epoch,
        )
        for i_k, key in enumerate(delta.words):
            st["truth"][tuple(int(w) for w in key)] = int(delta.rids[i_k])
        oracles[(t, next_epoch)] = _expected_answers(st["truth"], probes[t])
        st["cur"], st["base"] = pipes[t].run_incremental(
            st["cur"], st["base"], delta, keep_rows=keep,
            meta=st["cur"].meta, publish_to=cell,
        )
        registry.publish(t, cell)

    def writer_loop():
        i = 0
        try:
            while not stop.is_set():
                writer_cycle(tenants[i % n_tenants])
                i += 1
                if mutation_period_s > 0:
                    stop.wait(mutation_period_s)
        except Exception as e:  # pragma: no cover - surfaced in the report
            writer_errors.append(repr(e))
            stop.set()

    # ----------------------------------------------------------- readers
    counts = {"requests": 0, "torn": 0, "stale": 0, "shed": 0}
    count_lock = threading.Lock()
    reservoirs = [LatencyReservoir(4096, seed + 10 + i) for i in range(n_readers)]
    reader_errors: list = []

    def reader_loop(idx: int):
        res = reservoirs[idx]
        i = idx  # stagger tenant phase across readers
        try:
            while not stop.is_set():
                t = tenants[i % n_tenants]
                i += 1
                arena = registry.arena_of(t)
                epoch_before = arena.epochs[t] if arena is not None else -1
                t0 = time.perf_counter()
                try:
                    found, rid, epoch = engine.submit(t, probes[t])
                except AdmissionShed:
                    with count_lock:
                        counts["shed"] += 1
                    stop.wait(0.0005)  # shed backoff
                    continue
                res.record((time.perf_counter() - t0) * 1e6)
                exp_f, exp_r = oracles[(t, epoch)]
                torn = not (
                    np.array_equal(found, exp_f) and np.array_equal(rid, exp_r)
                )
                with count_lock:
                    counts["requests"] += 1
                    if torn:
                        counts["torn"] += 1
                    if epoch < epoch_before:
                        counts["stale"] += 1
        except Exception as e:  # pragma: no cover - surfaced in the report
            reader_errors.append(repr(e))

    # ------------------------------------------------ warmup + baseline
    for t in tenants:
        writer_cycle(t)
    # warm submits, then the unloaded fused round trip (micro-batch delay
    # included — the same path the loaded readers pay)
    for t in tenants:
        engine.submit(t, probes[t])
    unloaded = []
    for _ in range(8):
        t0 = time.perf_counter()
        engine.submit(tenants[0], probes[tenants[0]])
        unloaded.append((time.perf_counter() - t0) * 1e6)
    unloaded_p50 = _percentiles(np.asarray(unloaded), (50,))["p50_us"]

    threads = [
        threading.Thread(target=reader_loop, args=(i,), daemon=True)
        for i in range(n_readers)
    ]
    wt = threading.Thread(target=writer_loop, daemon=True)
    t_run0 = time.perf_counter()
    for th in threads:
        th.start()
    wt.start()
    time.sleep(duration_s)
    stop.set()
    for th in threads:
        th.join(timeout=30.0)
    wt.join(timeout=30.0)
    engine.shutdown()
    wall = time.perf_counter() - t_run0

    pcts = pooled_percentiles(reservoirs)
    eng_stats = engine.stats()
    return {
        "backend": backend,
        "n_tenants": n_tenants,
        "n_readers": n_readers,
        "duration_s": wall,
        "batch": batch,
        "n_requests": counts["requests"],
        "n_shed": counts["shed"],
        "torn_reads": counts["torn"],
        "stale_epochs": counts["stale"],
        "epochs_published": sum(
            cells[t].stats()["n_published"] for t in tenants
        ),
        "lookups_per_s": counts["requests"] * batch / max(wall, 1e-9),
        "unloaded_p50_us": unloaded_p50,
        "served_per_tenant": eng_stats["served_per_tenant"],
        "n_batches": eng_stats["n_batches"],
        "n_dispatches": eng_stats["n_dispatches"],
        "registry": registry.stats(),
        "slo": None if slo is None else slo.stats(),
        "errors": writer_errors + reader_errors,
        **pcts,
    }
