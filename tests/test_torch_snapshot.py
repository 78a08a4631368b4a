"""The port's snapshot read path: the publish/acquire protocol, its
counters under adversarial thread schedules, admission control, and
``publish_to=`` on every return path of the pipeline, against the JAX
reference.

The protocol tests mirror the reference's ``tests/test_snapshot.py`` and
``tests/test_concurrent_snapshot.py`` (minus the soaks) on port
snapshots: every lookup a reader runs on its pinned epoch is byte-checked
against that epoch's oracle (epoch ``k`` re-mints every rid with a
``k``-coded offset, so one lane answered from the wrong epoch flips the
comparison).  The ``publish_to`` tests hold each published snapshot's
arrays byte for byte against the reference's snapshot of the same run.
"""

import sys
import threading
import time
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.metadata import meta_from_keys as r_meta_from_keys  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.core.snapshot import SnapshotCell as RSnapshotCell  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, meta_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.snapshot import AdmissionShed, SnapshotCell  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402


def _words(seed: int, n: int, w: int = 2) -> np.ndarray:
    """``n`` unique masked keys (one rid per distinct key)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(2 * n, w), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    uniq = np.unique(pool, axis=0)
    return uniq[rng.permutation(uniq.shape[0])[:n]]


def _keyset(words: np.ndarray, rid_base: int = 0) -> KeySet:
    n, w = words.shape
    return keyset_from_numpy(words, np.full(n, 4 * w, np.int32),
                             np.arange(rid_base, rid_base + n, dtype=np.uint32))


# one small index per epoch over the same keys: epoch k's rids are the row
# index + k*1000, so a lookup's rid vector names the epoch it came from.
# Built once and shared by the schedule tests.
_EPOCH_POOL: dict = {}


def _epoch_pool(n_epochs: int = 4) -> dict:
    if _EPOCH_POOL:
        return _EPOCH_POOL
    words = _words(7, 300)
    pipe = ReconstructionPipeline(backend="torch", device="cpu")
    probe_idx = np.arange(0, 300, 300 // 32)[:32]
    _EPOCH_POOL.update(
        n=n_epochs,
        results=[pipe.run(_keyset(words, 1000 * k)) for k in range(n_epochs)],
        backend=get_backend("torch", device="cpu"),
        probe=to_carrier(words[probe_idx], "cpu"),
        probe_rids=probe_idx.astype(np.uint32),
    )
    return _EPOCH_POOL


def _check_epoch(pool, pin) -> bool:
    """Byte-check a pinned lookup against the pinned epoch's oracle."""
    found, rid = pin.lookup(pool["backend"], pool["probe"])
    want = pool["probe_rids"] + np.uint32(pin.epoch * 1000)
    return bool(found.all()) and np.array_equal(to_u32(rid), want)


# ---------------------------------------------------------------------------
# the cell protocol
# ---------------------------------------------------------------------------


def test_snapshot_cell_publish_pin_retire():
    ks = _keyset(_words(1, 300))
    pipe = ReconstructionPipeline(backend="torch", device="cpu")
    cell = SnapshotCell()
    with pytest.raises(RuntimeError):
        cell.acquire()  # nothing published yet
    res0 = pipe.run(ks, publish_to=cell)
    assert cell.epoch == 0 and cell.current.tree is res0.tree

    pinned = cell.acquire()
    res1 = pipe.run(ks, publish_to=cell)  # double buffer: next epoch
    assert cell.epoch == 1 and cell.current.tree is res1.tree
    assert pinned.epoch == 0 and pinned.tree is res0.tree
    assert cell.stats()["retired"] == 1
    cell.release(pinned)
    assert cell.stats()["retired"] == 0  # dropped once unpinned

    pipe.run(ks, publish_to=cell)  # an unpinned previous epoch drops at once
    assert cell.epoch == 2 and cell.stats()["retired"] == 0
    with pytest.raises(RuntimeError):
        cell.release(pinned)  # double release is a bug, not a no-op
    with pytest.raises(ValueError):
        cell.publish(res1, epoch=1)  # epochs must increase

    # frozen metadata: mutating the producer's result cannot reach a snapshot
    snap = cell.current
    res1.meta.dbitmap[:] = 0
    assert snap.meta.dbitmap.any()
    assert repr(pinned) == "SnapshotPin(epoch=0, released)"


def test_snapshot_cell_resume_epoch():
    cell = SnapshotCell(start_epoch=41)
    ReconstructionPipeline(backend="torch", device="cpu").run(_keyset(_words(2, 280)),
                                                              publish_to=cell)
    assert cell.epoch == 42  # resumed numbering, not restarted at 0


def test_double_release_raises_even_with_concurrent_pin():
    pool = _epoch_pool()
    cell = SnapshotCell()
    cell.publish(pool["results"][0])
    pin_a, pin_b = cell.acquire(), cell.acquire()  # two readers, one epoch
    pin_a.release()
    with pytest.raises(RuntimeError, match="double release"):
        pin_a.release()
    with pytest.raises(RuntimeError, match="double release"):
        cell.release(pin_a)
    st = cell.stats()
    assert st["pinned"] == 1 and st["acquires"] == 2 and st["releases"] == 1
    cell.publish(pool["results"][1])
    assert cell.stats()["retired"] == 1
    assert _check_epoch(pool, pin_b)  # epoch-0 answers, byte-exact
    pin_b.release()
    st = cell.stats()
    assert st["retired"] == 0 and st["retired_epochs"] == 1


def test_release_rejects_foreign_and_unpinned_snapshots():
    pool = _epoch_pool()
    cell, other = SnapshotCell(), SnapshotCell()
    cell.publish(pool["results"][0])
    other.publish(pool["results"][1])
    foreign_pin = other.acquire()
    with pytest.raises(RuntimeError, match="different SnapshotCell"):
        cell.release(foreign_pin)
    foreign_pin.release()
    with pytest.raises(RuntimeError, match="double release or foreign"):
        cell.release(other.current)
    with pytest.raises(RuntimeError, match="release of unpinned epoch"):
        cell.release(cell.current)
    p = cell.acquire()
    cell.release(p.snapshot)
    with pytest.raises(RuntimeError):
        cell.release(p.snapshot)


# ---------------------------------------------------------------------------
# barrier-scheduled interleavings
# ---------------------------------------------------------------------------


def _run_schedule(seed: int, n_readers: int = 4, reader_iters: int = 40):
    """Readers loop acquire → verify → release while the writer publishes
    the epoch pool with seeded sleeps; the counters must come out exact."""
    pool = _epoch_pool()
    cell = SnapshotCell()
    cell.publish(pool["results"][0])
    sleeps = np.random.default_rng(seed).uniform(0.0, 2e-3, size=pool["n"] - 1)
    barrier = threading.Barrier(n_readers + 1)
    torn, stale, errors = [0] * n_readers, [0] * n_readers, []

    def reader(idx: int):
        try:
            barrier.wait()
            for _ in range(reader_iters):
                before = cell.epoch
                with cell.pin() as pin:
                    torn[idx] += not _check_epoch(pool, pin)
                    stale[idx] += pin.epoch < before
        except Exception as e:  # surfaced by the assert below
            errors.append(repr(e))

    def writer():
        try:
            barrier.wait()
            for k in range(1, pool["n"]):
                time.sleep(float(sleeps[k - 1]))
                cell.publish(pool["results"][k])
        except Exception as e:  # surfaced by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # preempt inside the critical windows
    try:
        ts = [threading.Thread(target=reader, args=(i,)) for i in range(n_readers)]
        ts.append(threading.Thread(target=writer))
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    st = cell.stats()
    assert st["acquires"] == st["releases"] == n_readers * reader_iters
    assert st["pinned"] == 0 and st["retired"] == 0
    assert st["n_published"] == pool["n"]
    assert st["retired_epochs"] == pool["n"] - 1  # each freed exactly once
    assert 1 <= st["max_concurrent_pins"] <= n_readers
    assert sum(torn) == 0 and sum(stale) == 0, (seed, torn, stale)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17])
def test_publish_racing_acquire_release_seeded(seed):
    _run_schedule(seed)


def test_reader_pinned_across_three_rebuilds():
    pool = _epoch_pool()
    cell = SnapshotCell()
    cell.publish(pool["results"][0])
    pin = cell.acquire()
    for k in range(1, 4):
        cell.publish(pool["results"][k])
        assert cell.epoch == k
        assert _check_epoch(pool, pin)  # still epoch-0 rids, byte-exact
    assert cell.stats()["retired"] == 1 and cell.stats()["retired_epochs"] == 2
    pin.release()
    st = cell.stats()
    assert st["retired"] == 0 and st["retired_epochs"] == 3
    with cell.pin() as p2:
        assert p2.epoch == 3 and _check_epoch(pool, p2)


def test_last_release_retires_exactly_once():
    pool = _epoch_pool()
    k = 6
    cell = SnapshotCell()
    cell.publish(pool["results"][0])
    pins = [cell.acquire() for _ in range(k)]
    cell.publish(pool["results"][1])
    assert cell.stats()["retired"] == 1 and cell.stats()["retired_epochs"] == 0
    barrier = threading.Barrier(k)
    errors: list = []

    def releaser(p):
        try:
            barrier.wait()
            p.release()
        except Exception as e:  # surfaced by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=releaser, args=(p,)) for p in pins]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    st = cell.stats()
    assert st["pinned"] == 0 and st["retired"] == 0 and st["retired_epochs"] == 1
    assert st["releases"] == k and st["max_concurrent_pins"] == k


# ---------------------------------------------------------------------------
# admission control: shed, park, park timeout
# ---------------------------------------------------------------------------


def test_admission_shed_on_lag():
    pool = _epoch_pool()
    cell = SnapshotCell(max_lag_epochs=1)
    cell.publish(pool["results"][0])
    cell.report_lag(1)
    with cell.pin() as p:  # at the bound: still admitted
        assert p.epoch == 0
    cell.report_lag(2)
    with pytest.raises(AdmissionShed):
        cell.acquire()
    assert cell.stats()["shed"] == 1
    cell.report_lag(0)
    with cell.pin():
        pass
    assert cell.stats()["shed"] == 1 and cell.stats()["lag_epochs"] == 0


def test_admission_park_until_writer_catches_up():
    pool = _epoch_pool()
    cell = SnapshotCell(max_lag_epochs=0, admission="park")
    cell.publish(pool["results"][0])
    cell.report_lag(3)
    got: list = []

    def parked_reader():
        with cell.pin() as p:
            got.append(p.epoch)

    t = threading.Thread(target=parked_reader)
    t.start()
    time.sleep(0.05)
    assert not got  # still parked
    cell.publish(pool["results"][1])  # a publish alone does not clear the lag
    cell.report_lag(0)
    t.join(timeout=10.0)
    assert got == [1]  # woke on the new epoch
    st = cell.stats()
    assert st["parked"] == 1 and st["shed"] == 0 and st["park_wait_s"] > 0


def test_admission_park_timeout_sheds():
    pool = _epoch_pool()
    cell = SnapshotCell(max_lag_epochs=0, admission="park", park_timeout=0.05)
    cell.publish(pool["results"][0])
    cell.report_lag(5)
    t0 = time.perf_counter()
    with pytest.raises(AdmissionShed, match="timed out"):
        cell.acquire()
    assert time.perf_counter() - t0 >= 0.04
    st = cell.stats()
    assert st["parked"] == 1 and st["shed"] == 1


def test_admission_knob_validation():
    with pytest.raises(ValueError):
        SnapshotCell(admission="drop")
    with pytest.raises(ValueError):
        SnapshotCell(max_lag_epochs=-1)


# ---------------------------------------------------------------------------
# publish_to on every return path, against the reference's snapshots
# ---------------------------------------------------------------------------


def _assert_snapshot_equal(snap, rsnap):
    assert snap.epoch == rsnap.epoch and snap.watermark == rsnap.watermark
    got = result_to_numpy(snap)
    for name in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(rsnap, name)), err_msg=name)
    np.testing.assert_array_equal(got["tree"]["sorted_full"], np.asarray(rsnap.tree.sorted_full))
    np.testing.assert_array_equal(got["tree"]["sorted_rids"], np.asarray(rsnap.tree.sorted_rids))
    for k, v in rsnap.tree.leaf.items():
        np.testing.assert_array_equal(got["tree"]["leaf"][k], np.asarray(v), err_msg=k)
    for lv, rlv in zip(got["tree"]["levels"], rsnap.tree.levels, strict=True):
        for k, v in rlv.items():
            np.testing.assert_array_equal(lv[k], np.asarray(v), err_msg=k)
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(got["meta"][field], getattr(rsnap.meta, field))
    np.testing.assert_array_equal(snap.extract_bitmap, rsnap.extract_bitmap)


def _change_set():
    """300 3-word keys: 255 base rows (80 % kept), 45 delta rows, and the
    union meta that already covers the delta (no fallback)."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    rids = rng.permutation(300).astype(np.uint32)
    lengths = np.full(300, 12, np.int32)
    sets = [(RKeySet(words=words[s], lengths=lengths[s], rids=rids[s]),
             keyset_from_numpy(words[s], lengths[s], rids[s]))
            for s in (slice(0, 255), slice(255, 300))]
    rmeta = r_meta_from_keys(words)
    keep = rng.random(255) < 0.8
    return sets, rmeta, keep


@pytest.mark.parametrize("path", ["run", "merge", "fallback", "noop"])
def test_publish_to_on_every_path_matches_reference(path):
    """``run`` and each return path of ``run_incremental`` publish their
    result as the cell's next epoch, equal to the reference's snapshot."""
    ((rbase, base), (rdelta, delta)), rmeta, keep = _change_set()
    meta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    rpipe, pipe = RPipeline(backend="jnp"), ReconstructionPipeline(backend="cuda", device="cpu")
    rcell, cell = RSnapshotCell(start_epoch=4), SnapshotCell(start_epoch=4)
    rprev = rpipe.run(rbase, meta=rmeta, watermark=3, publish_to=rcell)
    prev = pipe.run(base, meta=meta, watermark=3, publish_to=cell)
    if path == "merge":
        rpipe.run_incremental(rprev, rbase, rdelta, keep_rows=keep, meta=rmeta,
                              watermark=9, publish_to=rcell)
        res, _ = pipe.run_incremental(prev, base, delta, keep_rows=keep, meta=meta,
                                      watermark=9, publish_to=cell)
        assert res.stats["incremental"] is True and "noop" not in res.stats
    elif path == "fallback":  # a D-bitmap with one more bit: full run
        grown = rmeta.dbitmap.copy()
        grown[0] |= ~grown[0] & (grown[0] + np.uint32(1))  # lowest clear bit
        rmeta_x = replace(rmeta, dbitmap=grown)
        rpipe.run_incremental(rprev, rbase, rdelta, keep_rows=keep, meta=rmeta_x,
                              watermark=9, publish_to=rcell)
        res, _ = pipe.run_incremental(prev, base, delta, keep_rows=keep,
                                      meta=replace(meta, dbitmap=grown), watermark=9,
                                      publish_to=cell)
        assert res.stats["incremental_fallback"] == "dbitmap_changed"
    elif path == "noop":
        rpipe.run_incremental(rprev, rbase, None, watermark=9, publish_to=rcell)
        res, _ = pipe.run_incremental(prev, base, None, watermark=9, publish_to=cell)
        assert res.stats["noop"] is True and cell.current.comp_sorted is prev.comp_sorted
    assert cell.epoch == rcell.epoch == (5 if path == "run" else 6)
    assert cell.stats()["n_published"] == rcell.stats()["n_published"]
    _assert_snapshot_equal(cell.current, rcell.current)


def test_published_snapshot_untouched_by_later_rebuilds():
    """The port shares a result's tensors with its snapshot (torch tensors
    are mutable; the pipeline writes none in place): a later
    ``run_incremental`` on the same pipeline leaves every tensor of a
    published snapshot at its ``_version`` and its bytes."""
    ((_, base), (_, delta)), rmeta, keep = _change_set()
    meta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    pipe = ReconstructionPipeline(backend="cuda", device="cpu")
    cell = SnapshotCell()
    prev = pipe.run(base, meta=meta, publish_to=cell)
    pin = cell.acquire()
    snap = pin.snapshot
    tensors = [snap.comp_sorted, snap.rid_sorted, snap.row_sorted, snap.tree.sorted_full,
               snap.tree.sorted_rids, *snap.tree.leaf.values(),
               *(v for lv in snap.tree.levels for v in lv.values())]
    before = [(t._version, t.clone()) for t in tensors]
    res, folded = pipe.run_incremental(prev, base, delta, keep_rows=keep, meta=meta,
                                       publish_to=cell)
    pipe.run_incremental(res, folded, delta, meta=meta, publish_to=cell)
    assert cell.epoch == 2 and pin.epoch == 0
    for t, (version, copy) in zip(tensors, before):
        assert t._version == version and torch.equal(t, copy)
    pin.release()
