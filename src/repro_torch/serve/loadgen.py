"""Closed-loop multi-tenant load harness: fused readers racing rebuilds.

The serving promise is that lookups stay torn-free and epoch-exact while
tenants rebuild underneath them.  :func:`run_multitenant_load` measures
that promise instead of assuming it: reader threads submit batched
lookups through a :class:`~repro_torch.serve.tenants.MultiTenantEngine`
in a closed loop (each thread fires its next request the moment the
previous one completes), while one writer thread churns the tenants with
``ReconstructionPipeline.run_incremental(publish_to=cell)``.  Every
response is byte-compared against the oracle of the ``(tenant, epoch)``
it was answered from, and its epoch must not precede the one observed
before submit.  Per-thread :class:`LatencyReservoir` samples pool into
stream-weighted percentiles (:func:`pooled_percentiles`).

This is the port of the reference's ``serve/loadgen.py`` for the
multi-tenant path only; ``run_load`` and ``run_pager_load`` come with
the pager (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core.keyformat import KeySet
from repro_torch.core.pipeline import ReconstructionPipeline
from repro_torch.core.snapshot import AdmissionShed, SnapshotCell

__all__ = [
    "LatencyReservoir",
    "pooled_percentiles",
    "run_multitenant_load",
]


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
    epoch_rid_base = 1 << 17

    for t in tenants:
        rng = np.random.default_rng(seed + 1000 * (t + 1))
        ks = _probe_keyset_exact(rng, n_keys, n_words)
        words_h = np.asarray(ks.words)
        truth = {
            tuple(int(w) for w in words_h[i]): int(ks.rids[i])
            for i in range(n_keys)
        }
        churn_lo = max(1, min(batch, n_keys - mutation_batch))
        probe_idx = np.concatenate(
            [
                np.arange(0, batch // 2, dtype=np.int64) % churn_lo,
                churn_lo
                + np.arange(batch - batch // 2, dtype=np.int64)
                % max(1, n_keys - churn_lo),
            ]
        )
        probe_keys = words_h[probe_idx].copy()
        probe_keys[::5] ^= np.uint32(0x10)  # guaranteed misses (outside mask)
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
        churn_lo, words_h, truth = st["churn_lo"], st["words"], st["truth"]
        wrng = st["wrng"]
        victims = churn_lo + wrng.choice(
            n_keys - churn_lo,
            size=min(mutation_batch, n_keys - churn_lo),
            replace=False,
        )
        keep = ~np.isin(st["tags"], victims)
        delta_words = words_h[victims]
        new_rids = (
            np.uint32(next_epoch * epoch_rid_base)
            + np.arange(len(victims), dtype=np.uint32)
        )
        delta = KeySet(
            words=delta_words,
            lengths=np.full(len(victims), n_words * 4, np.int32),
            rids=new_rids,
        )
        for i_k, key in enumerate(delta_words):
            truth[tuple(int(w) for w in key)] = int(new_rids[i_k])
        oracles[(t, next_epoch)] = _expected_answers(truth, probes[t])
        st["tags"] = np.concatenate([st["tags"][keep], victims])
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
