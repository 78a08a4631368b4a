"""The port's closed-loop load harnesses against the JAX reference's, on
the CPU.

``repro_torch.serve.loadgen.run_load`` and ``run_pager_load`` on
``"torch"`` and on ``"cuda"`` (``device="cpu"``: every kernel wrapper
takes its plain version) at the reference smoke test's sizes: zero torn
reads, stale epochs, errors and warm traces, the reference's report
fields, and, epoch for
epoch, the reference's oracle for the same seed — the probe keyset, the
probe batch, the writer's victims and their epoch-coded rids.  The
pager's concurrent read path is raced by a mutating writer.  The soak
forms, like their reference twins, carry the ``soak`` marker.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import loadgen as rloadgen  # noqa: E402
from repro_torch.serve import loadgen  # noqa: E402
from repro_torch.serve.pager import PagedKVManager  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")

#: the reference smoke test's run (tests/test_concurrent_snapshot.py)
LOAD_SMOKE = dict(n_keys=1024, n_words=2, batch=64, n_readers=2, duration_s=0.8,
                  mutation_batch=32, seed=0)
#: the reference pager soak's table, for a short run with two readers
PAGER_SMOKE = dict(n_pages=2048, page_tokens=16, n_seqs=24, pages_per_seq=6, n_readers=2,
                   duration_s=1.0, seed=0)


@pytest.mark.parametrize("seed,n_keys,n_words", [(0, 1024, 2), (3, 1024, 3), (5, 300, 1)])
def test_probe_keyset_matches_reference(seed, n_keys, n_words):
    got = loadgen._probe_keyset(np.random.default_rng(seed), n_keys, n_words)
    want = rloadgen._probe_keyset(np.random.default_rng(seed), n_keys, n_words)
    for name in ("words", "lengths", "rids"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _reference_truth(words: np.ndarray) -> dict:
    """The reference's host truth: every key of the table."""
    return {tuple(int(w) for w in words[i]): i for i in range(words.shape[0])}


@pytest.mark.parametrize("batch,mutation_batch", [(64, 32), (256, 1024), (100, 3)])
def test_oracle_matches_reference_every_epoch(batch, mutation_batch):
    """The port's oracle (a truth of the keys a probe lane can hit, the
    shared probe layout and churn draw) gives, epoch after epoch, the
    reference's ``_expected_answers`` over the whole table's truth."""
    ks = loadgen._probe_keyset(np.random.default_rng(0), 1024, 2)
    words = np.asarray(ks.words)
    churn_lo, probe_idx, probe_keys = loadgen._probe_batch(words, batch, mutation_batch)
    truth = {tuple(int(w) for w in words[i]): int(ks.rids[i]) for i in np.unique(probe_idx)}
    full = _reference_truth(words)
    tags = np.arange(ks.n, dtype=np.int64)
    wrng, ref_wrng = np.random.default_rng(1), np.random.default_rng(1)
    hits = set()
    for epoch in range(20):
        got = loadgen._expected_answers(truth, probe_keys)
        want = rloadgen._expected_answers(full, probe_keys)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        hits.update(np.flatnonzero(got[1] >= loadgen.EPOCH_RID_BASE).tolist())
        victims, keep, delta, tags = loadgen._churn(words, tags, churn_lo, wrng,
                                                    mutation_batch, epoch + 1)
        # the reference's draw and rids
        ref_victims = churn_lo + ref_wrng.choice(
            ks.n - churn_lo, size=min(mutation_batch, ks.n - churn_lo), replace=False)
        np.testing.assert_array_equal(victims, ref_victims)
        np.testing.assert_array_equal(
            delta.rids, np.uint32((epoch + 1) * (1 << 17)) + np.arange(len(victims),
                                                                       dtype=np.uint32))
        assert keep.sum() == ks.n - len(victims) and len(tags) == ks.n
        for v, r in zip(victims, delta.rids):
            full[tuple(int(w) for w in words[v])] = int(r)
            key = tuple(int(w) for w in words[v])
            if key in truth:
                truth[key] = int(r)
    assert hits  # churned lanes changed rid along the way
    assert not got[0][::5].any()  # the xor'd lanes miss


def _record_oracles(mp, module) -> list:
    """Record every oracle ``module._expected_answers`` computes."""
    calls = []
    orig = module._expected_answers

    def spy(truth, probe_keys):
        out = orig(truth, probe_keys)
        calls.append((np.array(probe_keys, copy=True), out))
        return out

    mp.setattr(module, "_expected_answers", spy)
    return calls


@pytest.fixture(scope="module")
def reference_load():
    """The reference smoke run and its per-epoch oracles (run once: the
    reference compiles each shape it meets)."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _record_oracles(mp, rloadgen)
        rep = rloadgen.run_load(backend="jnp", **LOAD_SMOKE)
    return rep, calls


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_load_short(reference_load, monkeypatch, backend):
    ref_rep, ref_calls = reference_load
    calls = _record_oracles(monkeypatch, loadgen)
    rep = loadgen.run_load(backend=backend, device="cpu", **LOAD_SMOKE)
    assert rep.errors == []
    assert rep.n_requests > 0 and rep.epochs_published >= 2
    assert rep.torn_reads == 0 and rep.stale_epochs == 0
    assert rep.p50_us > 0 and rep.p99_us >= rep.p50_us
    st = rep.cell_stats
    assert st["acquires"] == st["releases"] and st["pinned"] == 0
    row = rep.to_row()
    assert list(row) == list(ref_rep.to_row())
    assert row["warm_traces"] == 0 and ref_rep.warm_traces == 0
    assert row["max_concurrent_pins"] >= 1 and row["batch"] == ref_rep.batch
    assert ref_rep.errors == [] and ref_rep.torn_reads == 0
    # the oracle of every epoch both runs registered is the reference's
    k = min(len(calls), len(ref_calls))
    assert k >= 2
    for (keys, (f, r)), (ref_keys, (rf, rr)) in zip(calls[:k], ref_calls[:k]):
        np.testing.assert_array_equal(keys, ref_keys)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(r, rr)


def test_run_load_admission_sheds():
    """A writer owing a cycle every millisecond trips the lag bound: reads
    shed, and every shed is counted by the cell."""
    rep = loadgen.run_load(backend="torch", device="cpu", **{
        **LOAD_SMOKE, "duration_s": 1.0, "target_mutation_period_s": 0.001,
        "max_lag_epochs": 1, "admission": "shed"})
    assert rep.errors == []
    assert rep.torn_reads == 0 and rep.stale_epochs == 0
    assert rep.n_shed > 0 and rep.cell_stats["shed"] == rep.n_shed


@pytest.fixture(scope="module")
def reference_pager_keys():
    return set(rloadgen.run_pager_load(**{**PAGER_SMOKE, "duration_s": 0.3}))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_pager_load_short(reference_pager_keys, backend):
    out = loadgen.run_pager_load(backend=backend, device="cpu", **PAGER_SMOKE)
    assert out["errors"] == []
    assert out["n_requests"] > 0 and out["epochs_published"] >= 2
    assert out["torn_reads"] == 0 and out["stale_epochs"] == 0
    st = out["snapshot"]
    assert st["acquires"] == st["releases"] and st["pinned"] == 0
    # the reference's fields, and the measured wall and gets per second
    assert set(out) == reference_pager_keys | {"duration_s", "lookups_per_s"}
    assert out["lookups_per_s"] > 0


def test_pager_concurrent_reads_during_writer_churn():
    """read_through_dirty: reader threads keep answering from the current
    epoch while a writer mutates and rebuilds, the interpreter switching
    threads every 10 µs; every answer matches the epoch it pinned."""
    pm = PagedKVManager(n_pages=512, page_tokens=16, backend="torch", device="cpu",
                        read_through_dirty=True)
    n_seqs, pages = 12, 4
    for s in range(n_seqs):
        pm.pages_for(s, pages * 16)
    pm.rebuild_index()
    probe = np.asarray([(s, p) for s in range(n_seqs) for p in range(pages)], np.uint32)
    oracles = {}

    def snap_oracle(epoch):
        found = np.zeros(len(probe), bool)
        rid = np.full(len(probe), 0xFFFFFFFF, np.uint32)
        for i, (s, p) in enumerate(probe):
            phys = pm._table.get((int(s), int(p)))
            if phys is not None:
                found[i], rid[i] = True, phys
        oracles[epoch] = (found, rid)

    snap_oracle(pm._snapshots.epoch)
    pm.lookup_batch(probe)
    stop = threading.Event()
    n_readers = 3
    bad = [0] * n_readers
    served = [0] * n_readers
    errors: list = []

    def reader(idx):
        try:
            while not stop.is_set():
                f, r, e = pm.lookup_batch_versioned(probe)
                exp_f, exp_r = oracles[e]
                if not (np.array_equal(f, exp_f) and np.array_equal(r, exp_r)):
                    bad[idx] += 1
                served[idx] += 1
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ts = [threading.Thread(target=reader, args=(i,)) for i in range(n_readers)]
    try:
        for t in ts:
            t.start()
        for k in range(4):
            victim = k % n_seqs
            pm.free_seq(victim)
            pm.pages_for(victim, pages * 16)
            snap_oracle(pm._snapshots.epoch + 1)
            pm.rebuild_index()
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=30.0)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert bad == [0] * n_readers and sum(served) > 0
    assert pm._snapshots.stats()["pinned"] == 0
    assert pm.stats["snapshot"]["n_published"] == 5


@pytest.mark.soak
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_soak_run_load_8_readers(backend):
    """The reference's acceptance run on the port: 8 readers, live
    incremental rebuilds, zero torn reads and stale epochs."""
    rep = loadgen.run_load(backend=backend, device="cpu", n_keys=16384, n_words=2,
                           batch=256, n_readers=8, duration_s=4.0, mutation_batch=64,
                           seed=0)
    assert rep.errors == []
    assert rep.n_requests >= 8 and rep.epochs_published >= 3
    assert rep.torn_reads == 0 and rep.stale_epochs == 0
    st = rep.cell_stats
    assert st["acquires"] == st["releases"] and st["pinned"] == 0
    assert st["max_concurrent_pins"] >= 2


@pytest.mark.soak
def test_soak_pager_load():
    out = loadgen.run_pager_load(backend="torch", device="cpu", **{
        **PAGER_SMOKE, "n_readers": 4, "duration_s": 3.0})
    assert out["errors"] == []
    assert out["n_requests"] > 0 and out["epochs_published"] >= 2
    assert out["torn_reads"] == 0 and out["stale_epochs"] == 0
