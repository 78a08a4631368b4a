"""The port's online index against the JAX reference's, on the CPU.

``repro_torch.core.index.OnlineIndex`` on ``"torch"`` and on ``"cuda"``
(``device="cpu"``: every kernel wrapper takes its plain version) is given
the same mutations as ``repro.core.index.OnlineIndex(backend="jnp")``
and must agree byte for byte (the tolerance is exact equality): the
DS-metadata after every insert and delete (which checks the neighbor
view, tombstoned base rows included), the search answers with tombstones
and the delta, the rebuilt tree, sorted run, rids and pinned D-bitmap on
the merged and the fallback path, the epochs across rebuilds and a
reader pinned across one.  The cases mirror ``tests/test_btree_index.py``,
``tests/test_lookup.py``, ``tests/test_snapshot.py`` and
``tests/test_pipeline.py``'s neighbor cache case, at their shapes (W = 3
and 2, n of 300-600).

The change log and its wire framing (``repro_torch.replication``) are
numpy-only copies of the reference's: the same appends give the same
columns, LSNs, fold, slices and archives as ``repro.replication``; those
cases mirror ``tests/test_replication.py``'s log cases and
``tests/test_stream.py``'s slice and schema-error cases.
"""

import bisect
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.index import OnlineIndex as ROnlineIndex  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.replication import ChangeLog as RChangeLog  # noqa: E402
from repro.replication import wire as rwire  # noqa: E402
from repro_torch.convert import keyset_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core.index import OnlineIndex  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.replication import ChangeLog, FrameSchemaError, wire  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")


def _words(seed: int, n: int, w: int = 3, mask: int = 0x0FFF0FFF) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = np.unique(rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask),
                    axis=0)
    return arr[rng.permutation(arr.shape[0])]


def _pair(words: np.ndarray, backend: str):
    """The reference's and the port's index over the same keys."""
    n, w = words.shape
    lengths = np.full(n, 4 * w, np.int32)
    rids = np.arange(n, dtype=np.uint32)
    ref = ROnlineIndex.build(RKeySet(words=words, lengths=lengths, rids=rids))
    port = OnlineIndex.build(keyset_from_numpy(words, lengths, rids), backend=backend,
                             device="cpu")
    return ref, port


def _assert_meta_equal(port_meta, ref_meta, what=""):
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(port_meta, field), getattr(ref_meta, field),
                                      err_msg=f"{what} meta.{field}")


def _assert_search_equal(port, ref, queries):
    fp, rp = port.search_batch(queries)
    fr, rr = ref.search_batch(queries)
    np.testing.assert_array_equal(fp, np.asarray(fr, bool))
    np.testing.assert_array_equal(rp, np.asarray(rr, np.uint32))
    return fp, rp


def _assert_results_equal(res, ref):
    got = result_to_numpy(res)
    for name in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(got["tree"]["sorted_full"], np.asarray(ref.tree.sorted_full))
    np.testing.assert_array_equal(got["tree"]["sorted_rids"], np.asarray(ref.tree.sorted_rids))
    for k, v in ref.tree.leaf.items():
        np.testing.assert_array_equal(got["tree"]["leaf"][k], np.asarray(v), err_msg=k)
    assert len(got["tree"]["levels"]) == len(ref.tree.levels)
    for lg, lw in zip(got["tree"]["levels"], ref.tree.levels):
        for k, v in lw.items():
            np.testing.assert_array_equal(lg[k], np.asarray(v), err_msg=k)
    _assert_meta_equal(res.meta, ref.meta)
    np.testing.assert_array_equal(res.extract_bitmap, ref.extract_bitmap)


def _mutate_both(port, ref, words, seed):
    """A seeded mix of mutations on both indexes, the meta compared after
    each: fresh inserts, a duplicate of a base key, base deletes, delta
    deletes, a re-insert of a deleted base key and misses."""
    rng = np.random.default_rng(seed)
    n, w = words.shape
    fresh = _words(seed + 100, 40, w, 0x0FFF0FFF | 0x10000000)
    fresh = fresh[~(fresh[:, None, :] == words[None]).all(-1).any(1)][:30]
    ops = [("insert", fresh[i], 10_000 + i) for i in range(len(fresh))]
    ops += [("delete", words[i], None) for i in rng.choice(n, 25, replace=False)]
    ops += [("delete", fresh[i], None) for i in range(0, 30, 4)]
    ops += [("insert", words[3], 20_000), ("delete", words[3], None),
            ("insert", words[3], 20_001), ("delete", fresh[1] ^ np.uint32(1), None)]
    order = rng.permutation(len(ops))
    # keep an insert of a key ahead of its deletes (the rest is shuffled)
    ops = [ops[i] for i in order if ops[i][0] == "insert"] + \
          [ops[i] for i in order if ops[i][0] == "delete"]
    for k, (op, key, rid) in enumerate(ops):
        if op == "insert":
            port.insert(key, rid)
            ref.insert(key, rid)
        else:
            assert port.delete(key) == ref.delete(key), k
        _assert_meta_equal(port.meta, ref.meta, f"after op {k} ({op})")
    return fresh


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_meta_after_each_mutation_and_searches_match_reference(backend):
    words = _words(1, 400)
    ref, port = _pair(words, backend)
    _assert_meta_equal(port.meta, ref.meta, "built")
    fresh = _mutate_both(port, ref, words, seed=2)
    queries = np.concatenate([words[:64], fresh, words[:16] ^ np.uint32(4),
                              np.full((2, 3), 0xFFFFFFFF, np.uint32)])
    found, _ = _assert_search_equal(port, ref, queries)
    assert found.any() and not found.all()
    np.testing.assert_array_equal(port.log.arrays()["rids"], ref.log.arrays()["rids"])


def test_neighbor_view_matches_reference():
    """After 60 mixed inserts and deletes (base and delta keys), the
    neighbor pair of every probe key equals the reference's (its sorted
    tuple view) and a bisect of a from-scratch sort of the same keys
    (test_pipeline.py's cache case)."""
    words = _words(3, 300, w=2)
    ref, port = _pair(words, "torch")
    rng = np.random.default_rng(4)
    inserted, live = [], []
    for i in range(60):
        if i % 3 == 2 and live:
            # every third mutation deletes: a live insert or a base key
            k = live.pop(int(rng.integers(len(live)))) if i % 2 else words[i]
            assert port.delete(k) and ref.delete(k)
            continue
        k = rng.integers(0, 2**32, size=2, dtype=np.uint32) | np.uint32(0x10000000)
        port.insert(k, 50_000 + i)
        ref.insert(k, 50_000 + i)
        inserted.append((k, 50_000 + i))
        live.append(k)
    # the view from scratch: every base key (tombstoned ones stay) and
    # every live delta key, sorted
    delta = port._delta_rows()
    scratch = np.concatenate([np.asarray(ref.result.tree.sorted_full), delta[:, :2]])
    scratch = scratch[np.lexsort(scratch.T[::-1])]
    scratch_t = [tuple(int(x) for x in r) for r in scratch]
    assert scratch_t == list(ref._sorted_view())
    probes = np.concatenate([words[:40], np.stack([k for k, _ in inserted]),
                             words[:20] ^ np.uint32(2), np.zeros((1, 2), np.uint32),
                             np.full((1, 2), 0xFFFFFFFF, np.uint32)])
    for key in probes:
        key_t = tuple(int(x) for x in key)
        i = bisect.bisect_left(scratch_t, key_t)
        want = (scratch[i - 1] if i > 0 else None,
                scratch[i] if i < len(scratch_t) else None)
        for g, r, s in zip(port._neighbors(key), ref._neighbors(key_t), want):
            assert (g is None) == (r is None) == (s is None)
            if g is not None:
                np.testing.assert_array_equal(g, r)
                np.testing.assert_array_equal(g, s)
    # the delta holds what the reference's does, in its order
    assert [(tuple(int(x) for x in r[:2]), int(r[2])) for r in delta] == \
        [(k, r) for k, r in ref._delta]
    oi2 = port.rebuild()
    for k, rid in inserted:
        want = (True, rid) if any((k == x).all() for x in live) else (False, None)
        got = oi2.search(k)
        assert got[0] == want[0] and (not got[0] or got[1] == rid)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_rebuild_matches_reference(backend):
    """The rebuilt tree, sorted run, rids and pinned D-bitmap equal the
    reference's rebuild; a quiet follow-up rebuild merges in both."""
    words = _words(5, 400)
    ref, port = _pair(words, backend)
    fresh = _mutate_both(port, ref, words, seed=6)
    p2, r2 = port.rebuild(), ref.rebuild()
    _assert_results_equal(p2.result, r2.result)
    assert p2.result.stats["incremental"] == r2.result.stats["incremental"]
    np.testing.assert_array_equal(p2.meta.dbitmap, p2.result.extract_bitmap)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(p2.keyset, field), getattr(r2.keyset, field))
    queries = np.concatenate([words[:32], fresh[:12]])
    _assert_search_equal(p2, r2, queries)
    # a quiet rebuild (one delete) merges against the pinned bitmap
    assert p2.delete(words[40]) == r2.delete(words[40])
    p3, r3 = p2.rebuild(), r2.rebuild()
    assert p3.result.stats["incremental"] is True
    assert r3.result.stats["incremental"] is True
    _assert_results_equal(p3.result, r3.result)


def test_stale_bitmap_rebuild_sheds_and_answers():
    """Delete half the keys; the stale bitmap still rebuilds correctly
    and the rebuild sheds stale positions (test_btree_index.py's case),
    equal to the reference's at every step."""
    words = _words(7, 400)
    ref, port = _pair(words, "cuda")
    for i in range(200):
        assert port.delete(words[i]) and ref.delete(words[i])
    _assert_meta_equal(port.meta, ref.meta, "stale")
    p2, r2 = port.rebuild(), ref.rebuild()
    assert p2.meta.n_dbits <= port.meta.n_dbits
    _assert_results_equal(p2.result, r2.result)
    found, rid = p2.search_batch(words[200:250])
    assert found.all() and (rid == np.arange(200, 250)).all()
    assert not p2.search_batch(words[:25])[0].any()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_delete_delta_key_and_rid_reuse(backend):
    """A delta key leaves the delta (no tombstone); a base row's rid is
    reused by a new key, which the fold keeps and the old key loses."""
    words = _words(8, 400)
    ref, port = _pair(words, backend)
    new = words[10] ^ np.uint32(0x00100000)
    for oi in (port, ref):
        oi.insert(new, 70_000)
        assert oi.delete(new)
        assert not oi.delete(new)
        assert oi.delete(words[20])  # base rid 20 tombstoned ...
        oi.insert(new, 20)           # ... and reused by the new key
    assert port._tombstones == ref._tombstones == {20}
    _assert_search_equal(port, ref, np.stack([new, words[20], words[21]]))
    assert port.search(new) == (True, 20) and port.search(words[20])[0] is False
    p2, r2 = port.rebuild(), ref.rebuild()
    _assert_results_equal(p2.result, r2.result)
    assert p2.search(new) == (True, 20) and not p2.search(words[20])[0]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_scalar_search_is_batched_row(backend):
    words = _words(9, 400)
    ref, port = _pair(words, backend)
    for oi in (port, ref):
        oi.insert(np.asarray([9, 9, 9], np.uint32), 777)
        oi.delete(np.asarray(words[3]))
    queries = np.concatenate([words[:8], np.asarray([[9, 9, 9]], np.uint32)])
    fb, rb = _assert_search_equal(port, ref, queries)
    for i, q in enumerate(queries):
        assert port.search(q) == (bool(fb[i]), int(rb[i]))
    assert not fb[3] and fb[-1] and rb[-1] == 777


def test_reader_pinned_across_rebuild():
    """A pinned epoch keeps its pre-rebuild answers; the pre-rebuild
    instance keeps its own epoch and overlay (test_snapshot.py's case)."""
    words = _words(10, 400)
    ref, port = _pair(words, "cuda")
    victim = words[7]
    pinned = port.snapshots.acquire()
    r_pinned = ref.snapshots.acquire()
    port.delete(victim)
    ref.delete(victim)
    p2, r2 = port.rebuild(), ref.rebuild()
    assert p2.snapshots is port.snapshots and p2.snapshots.epoch == r2.snapshots.epoch == 1
    assert not p2.search(victim)[0]
    f_old, r_old = pinned.lookup(p2._backend_obj(), torch.as_tensor(victim[None, :],
                                                                   dtype=torch.int64))
    rf_old, rr_old = r_pinned.lookup(r2._backend_obj(), victim[None, :])
    assert bool(f_old[0]) and bool(rf_old[0]) and int(r_old[0]) == int(rr_old[0]) == 7
    port.snapshots.release(pinned)
    ref.snapshots.release(r_pinned)
    assert port._snapshot.epoch == 0 and p2._snapshot.epoch == 1
    assert port.search(victim) == ref.search(victim)
    assert not port.search(victim)[0]
    assert port.search(words[8]) == ref.search(words[8]) == (True, 8)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_rebuild_falls_back_when_an_insert_sets_a_new_bit(backend):
    """An insert that differs from its neighbor in a bit no base key
    distinguishes sets a new D-bit, so the rebuild takes the full resort,
    as the reference's does; both equal byte for byte."""
    words = _words(12, 400)
    ref, port = _pair(words, backend)
    # the mask leaves 0x8000 of word 2 clear in every key: a non-D bit
    new = words[5].copy()
    new[2] |= np.uint32(0x8000)
    before = port.meta.n_dbits
    for oi in (port, ref):
        oi.insert(new, 90_000)
        assert oi.delete(words[6])
    _assert_meta_equal(port.meta, ref.meta, "new bit")
    assert port.meta.n_dbits > before
    p2, r2 = port.rebuild(), ref.rebuild()
    assert p2.result.stats["incremental"] is False
    assert p2.result.stats["incremental_fallback"] == r2.result.stats["incremental_fallback"]
    _assert_results_equal(p2.result, r2.result)
    assert p2.search(new) == r2.search(new) == (True, 90_000)


def test_epochs_rise_across_rebuilds():
    """Three rebuilds publish epochs 1, 2 and 3 into the one shared cell,
    as the reference's do; every instance keeps its own epoch and answers
    from it."""
    words = _words(13, 400)
    ref, port = _pair(words, "torch")
    chain_p, chain_r = [port], [ref]
    for i in range(3):
        for oi in (chain_p[-1], chain_r[-1]):
            assert oi.delete(words[10 + i])
        chain_p.append(chain_p[-1].rebuild())
        chain_r.append(chain_r[-1].rebuild())
        assert chain_p[-1].snapshots is port.snapshots
        assert chain_p[-1].snapshots.epoch == chain_r[-1].snapshots.epoch == i + 1
    assert [oi._snapshot.epoch for oi in chain_p] == \
        [oi._snapshot.epoch for oi in chain_r] == [0, 1, 2, 3]
    for j, oi in enumerate(chain_p):
        # instance i tombstoned words[10 + i]; epoch i + 1 folded it away
        want = [(True, 10 + i) if i > j else (False, None) for i in range(3)]
        for i, (hit, rid) in enumerate(want):
            got = oi.search(words[10 + i])
            assert got[0] == hit and (not hit or got[1] == rid)
            assert got == chain_r[j].search(words[10 + i])


def test_packages_export_online_index():
    import repro_torch
    import repro_torch.core

    assert repro_torch.OnlineIndex is OnlineIndex
    assert repro_torch.core.OnlineIndex is OnlineIndex
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018


def test_log_journals_mutations_as_reference():
    words = _words(11, 300, w=2)
    ref, port = _pair(words, "torch")
    _mutate_both(port, ref, words, seed=12)
    assert isinstance(port.log, ChangeLog)
    got, want = port.log.arrays(), ref.log.arrays()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    keep_p, delta_p = port.log.fold_keyset(port.keyset)
    keep_r, delta_r = ref.log.fold_keyset(ref.keyset)
    np.testing.assert_array_equal(keep_p, keep_r)
    np.testing.assert_array_equal(delta_p.words, delta_r.words)
    np.testing.assert_array_equal(delta_p.rids, delta_r.rids)


# ---------------------------------------------------------------------------
# the change log and its wire framing (numpy-only copies of the reference's)
# ---------------------------------------------------------------------------


def _script(rng, n_words=3, start_lsn=0, **kw):
    """One seeded append script applied to a port and a reference log."""
    logs = ChangeLog(n_words, start_lsn=start_lsn, **kw), RChangeLog(n_words,
                                                                    start_lsn=start_lsn, **kw)
    words = rng.integers(0, 2**32, size=(12, n_words), dtype=np.uint32)
    steps = [
        ("ins", words[:5], np.arange(5, dtype=np.uint32), None),
        ("del", None, np.asarray([1, 3, 77], np.uint32), None),
        ("ins", words[5:6], np.asarray([3], np.uint32), np.asarray([7], np.int32)),
        ("ins", words[6:6], np.zeros(0, np.uint32), None),  # empty: no LSN
        ("del", None, np.asarray([100, 3], np.uint32), None),
        ("ins", words[6:12], np.arange(100, 106, dtype=np.uint32), None),
    ]
    for op, w, rids, lengths in steps:
        got = [log.append_inserts(w, rids, lengths) if op == "ins" else log.append_deletes(rids)
               for log in logs]
        assert got[0] == got[1]
    return logs


def _assert_logs_equal(got, want):
    assert (got.n_words, got.start_lsn, got.next_lsn, len(got)) == \
        (want.n_words, want.start_lsn, want.next_lsn, len(want))
    assert got.shed_delete_frac == want.shed_delete_frac
    assert got.deletes_since_shed == want.deletes_since_shed
    a, b = got.arrays(), want.arrays()
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_arrays_equal_reference_for_the_same_appends():
    log, ref = _script(np.random.default_rng(0), start_lsn=5)
    _assert_logs_equal(log, ref)
    got, want = log.to_npz_dict(), ref.to_npz_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fold_replay_semantics():
    """Insert-then-delete dies, a base delete drops its row, delete then
    reinsert of a rid keeps the insert (test_replication.py's case)."""
    base_rids = np.asarray([0, 1, 2, 3], np.uint32)
    outs = []
    for cls in (ChangeLog, RChangeLog):
        log = cls(n_words=2)
        k = lambda v: np.asarray([[v, v]], np.uint32)  # noqa: E731
        log.append_inserts(k(10), [10])
        log.append_inserts(k(11), [11])
        log.append_deletes([11])
        log.append_deletes([2])
        log.append_deletes([3])
        log.append_inserts(k(33), [3])
        outs.append(log.fold(base_rids))
        assert len(log) == 6 and log.next_lsn == 6
    keep, iw, il, ir = outs[0]
    assert keep.tolist() == [True, True, False, False]
    assert ir.tolist() == [10, 3] and iw[:, 0].tolist() == [10, 33] and il.tolist() == [8, 8]
    for got, want in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_base", [0, 4, 200])
def test_fold_and_fold_keyset_match_reference(n_base):
    rng = np.random.default_rng(n_base)
    log, ref = _script(rng)
    base_rids = np.arange(n_base, dtype=np.uint32)
    for got, want in zip(log.fold(base_rids), ref.fold(base_rids)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    words = rng.integers(0, 2**32, size=(n_base, 3), dtype=np.uint32)
    lengths = np.full(n_base, 12, np.int32)
    keep, delta = log.fold_keyset(KeySet(words=words, lengths=lengths, rids=base_rids))
    r_keep, r_delta = ref.fold_keyset(RKeySet(words=words, lengths=lengths, rids=base_rids))
    assert (keep is None) == (r_keep is None)
    if keep is not None:
        np.testing.assert_array_equal(keep, r_keep)
    assert isinstance(delta, KeySet)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(delta, field), getattr(r_delta, field))


def test_empty_fold():
    log = ChangeLog(n_words=2)
    keep, iw, il, ir = log.fold(np.asarray([5, 6], np.uint32))
    assert keep.tolist() == [True, True] and iw.shape == (0, 2)
    assert log.fold_keyset(KeySet(words=np.zeros((2, 2), np.uint32),
                                  lengths=np.full(2, 8, np.int32),
                                  rids=np.asarray([5, 6], np.uint32))) == (None, None)


def test_slice_and_concat_match_reference():
    log, ref = _script(np.random.default_rng(1), n_words=2, start_lsn=10)
    for lo, hi in [(12, 17), (0, 13), (13, 99), (15, 15), (30, 40)]:
        _assert_logs_equal(log.slice_lsn(lo, hi), ref.slice_lsn(lo, hi))
    whole = ChangeLog.concat([log.slice_lsn(10, 13), log.slice_lsn(13, 30)])
    _assert_logs_equal(whole, RChangeLog.concat([ref.slice_lsn(10, 13), ref.slice_lsn(13, 30)]))
    a, b = log.arrays(), whole.arrays()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        ChangeLog.concat([log.slice_lsn(10, 12), log.slice_lsn(13, 18)])
    with pytest.raises(ValueError):
        ChangeLog.concat([])


def test_npz_and_wire_round_trips_keep_shed_state(tmp_path):
    log, ref = _script(np.random.default_rng(2), start_lsn=17, shed_delete_frac=0.5,
                       deletes_since_shed=3)
    back = ChangeLog.load(log.save(tmp_path / "log.npz"))
    _assert_logs_equal(back, ref)
    _assert_logs_equal(ChangeLog.from_wire(log.to_wire()), ref)
    # each package reads the other's bytes
    _assert_logs_equal(ChangeLog.from_wire(ref.to_wire()), ref)
    _assert_logs_equal(RChangeLog.from_wire(log.to_wire()), ref)
    log2 = ChangeLog.from_wire(ChangeLog(2, deletes_since_shed=4).to_wire())
    assert log2.shed_delete_frac is None and log2.deletes_since_shed == 4
    assert len(log2) == 0 and log2.arrays()["words"].shape == (0, 2)


@pytest.mark.parametrize("payload", [
    b"definitely not a zip",
    b"",
    "npz_without_log_columns",
    "truncated_npz",
])
def test_foreign_bytes_raise_frame_schema_error(payload):
    if payload == "npz_without_log_columns":
        buf = io.BytesIO()
        np.savez(buf, unrelated=np.arange(3))
        payload = buf.getvalue()
    elif payload == "truncated_npz":
        payload = ChangeLog(2).to_wire()[:40]
    with pytest.raises(FrameSchemaError):
        ChangeLog.from_wire(payload)
    with pytest.raises(rwire.FrameSchemaError):
        RChangeLog.from_wire(payload)


def test_wire_frames_match_reference():
    payload = ChangeLog(3).to_wire()
    for kind, seq in [(1, 0), (2, 7), (255, 2**40)]:
        frame = wire.pack_frame(kind, payload, seq=seq)
        assert frame == rwire.pack_frame(kind, payload, seq=seq)
        header, body = wire.unpack_frame(frame)
        assert body == payload and (header.kind, header.seq) == (kind, seq)
    assert wire.crc32c(b"123456789") == rwire.crc32c(b"123456789") == 0xE3069283
    assert wire.is_framed(frame) and not wire.is_framed(payload)
    bad = bytearray(frame)
    bad[4] = 99  # the version byte
    with pytest.raises(wire.FrameSchemaError):
        wire.unpack_frame(bytes(bad))
    with pytest.raises(wire.FrameCorrupt):
        wire.unpack_frame(frame[:-1])
    flipped = bytearray(frame)
    flipped[-1] ^= 1
    with pytest.raises(wire.FrameCorrupt):
        wire.unpack_frame(bytes(flipped))
    with pytest.raises(ValueError):
        wire.pack_frame(256, payload)
