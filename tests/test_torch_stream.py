"""The port's replication stream against the JAX reference's, on the CPU.

Frames cross between the packages in both directions: a batch, shed or
checkpoint frame encoded by either decodes in the other to the same
fields and log columns, with the same header (kind, sequence number), and
both reject the same damage with the same typed errors.  Frames are
compared decoded, not as bytes: ``np.savez`` stamps each archive entry
with the time of writing.  A payload past 64 KiB takes the port's
chunk-parallel CRC32C, which must equal the reference's byte loop.

A ``StreamPrimary`` with bounded lag, a tail that polls after every batch
and a lagger that sleeps through two checkpoints (so it bootstraps from
the checkpoint chain) are driven with the same seeded batches on
``repro`` (``"jnp"``) and on the port (``"torch"`` and ``"cuda"``, on
the CPU): every replica's state, the counters, the checkpoint manifests
and the search answers are equal.  The protocol cases of
``tests/test_stream.py`` (duplicates, gaps, overlaps, coalescing, the
no-op, shed frames, the wire sequence) run on the port, each replica held
to the port's primary and the shed case to the reference as well.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt.checkpoint import step_manifest as r_step_manifest  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.replication import BatchFrame as RBatchFrame  # noqa: E402
from repro.replication import ChangeLog as RChangeLog  # noqa: E402
from repro.replication import CheckpointFrame as RCheckpointFrame  # noqa: E402
from repro.replication import QueueTransport as RQueueTransport  # noqa: E402
from repro.replication import ShedFrame as RShedFrame  # noqa: E402
from repro.replication import StreamPrimary as RStreamPrimary  # noqa: E402
from repro.replication import StreamReplica as RStreamReplica  # noqa: E402
from repro.replication import decode_frame as r_decode_frame  # noqa: E402
from repro.replication import encode_frame as r_encode_frame  # noqa: E402
from repro.replication import peek_header as r_peek_header  # noqa: E402
from repro.replication import wire as rwire  # noqa: E402
from repro_torch.ckpt import step_manifest  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    BackpressureError,
    BatchFrame,
    ChangeLog,
    CheckpointFrame,
    DirectoryTransport,
    FrameCorrupt,
    FrameSchemaError,
    LsnGapError,
    QueueTransport,
    Replica,
    ShedFrame,
    StreamPrimary,
    StreamReplica,
    decode_frame,
    encode_frame,
    peek_header,
    wire,
)

PORT_BACKENDS = ("torch", "cuda")


def _keyset(cls, rng, n, w=3, mask=0x00FF0F0F, rid_base=0):
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)
    return cls(words=words, lengths=np.full(n, w * 4, np.int32),
               rids=np.arange(rid_base, rid_base + n, dtype=np.uint32))


def _random_batch(log_cls, rng, primary, n_ins=40, n_del=8, rid_base=100_000):
    """One LSN-contiguous batch re-drawing live keys (no new D-bits)."""
    ks = primary.replica.keyset
    log = log_cls(ks.n_words, start_lsn=primary.next_lsn)
    if n_ins:
        pick = rng.integers(0, ks.n, size=n_ins)
        log.append_inserts(np.asarray(ks.words)[pick],
                           rid_base + rng.integers(0, 2**20, size=n_ins).astype(np.uint32))
    if n_del:
        dead = rng.choice(np.asarray(ks.rids), size=min(n_del, ks.n), replace=False)
        log.append_deletes(dead)
    return log


def _state(rep) -> dict:
    """A replica's state as numpy (either package)."""
    res = rep.result
    if isinstance(res.comp_sorted, torch.Tensor):
        r = result_to_numpy(res)
        sorted_arrays = {k: r[k] for k in ("comp_sorted", "rid_sorted", "row_sorted")}
    else:
        sorted_arrays = {k: np.asarray(getattr(res, k))
                         for k in ("comp_sorted", "rid_sorted", "row_sorted")}
    return {
        "words": np.asarray(rep.keyset.words), "rids": np.asarray(rep.keyset.rids),
        "lengths": np.asarray(rep.keyset.lengths),
        "dbitmap": np.asarray(rep.meta.dbitmap), "varbitmap": np.asarray(rep.meta.varbitmap),
        "refkey": np.asarray(rep.meta.refkey), **sorted_arrays,
        "applied_lsn": np.asarray(rep.applied_lsn), "epoch": np.asarray(rep.snapshots.epoch),
    }


def _differing(a, b) -> list[str]:
    sa, sb = _state(a), _state(b)
    return [k for k in sa if not np.array_equal(sa[k], sb[k])]


def _assert_matches_full_run(rep, backend):
    """The stream-driven replica == a full pipeline run over its keyset."""
    full = ReconstructionPipeline(backend=backend, device="cpu").run(rep.keyset, meta=rep.meta)
    got, want = result_to_numpy(rep.result), result_to_numpy(full)
    for k in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["tree"]["levels"]) == len(want["tree"]["levels"])


def _log_arrays_equal(a, b):
    aa, bb = a.arrays(), b.arrays()
    for k in aa:
        np.testing.assert_array_equal(aa[k], bb[k], err_msg=k)
    assert (a.start_lsn, a.next_lsn, a.n_words) == (b.start_lsn, b.next_lsn, b.n_words)
    assert (a.shed_delete_frac, a.deletes_since_shed) == (b.shed_delete_frac,
                                                          b.deletes_since_shed)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _frame_pairs(n_ins: int):
    """Each frame kind built by both packages from the same arrays."""
    rng = np.random.default_rng(n_ins)
    words = rng.integers(0, 2**32, size=(n_ins, 3), dtype=np.uint32)
    rids = np.arange(n_ins, dtype=np.uint32)
    pairs = []
    for cls, batch, shed, ckpt in ((RChangeLog, RBatchFrame, RShedFrame, RCheckpointFrame),
                                   (ChangeLog, BatchFrame, ShedFrame, CheckpointFrame)):
        log = cls(3, start_lsn=7)
        log.append_inserts(words, rids)
        log.append_deletes([1, 2])
        state = cls(3, start_lsn=99, shed_delete_frac=0.25, deletes_since_shed=17)
        pairs.append([batch(log=log, bucket=plancache.bucket(len(log))), shed(lsn=41),
                      ckpt(ckpt_dir="/some/dir", step=3, base_lsn=99, log_state=state)])
    return list(zip(*pairs))


def _frames_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    if type(a).__name__ == "BatchFrame":
        assert (a.bucket, a.lsn0, a.lsn1) == (b.bucket, b.lsn0, b.lsn1)
        _log_arrays_equal(a.log, b.log)
    elif type(a).__name__ == "ShedFrame":
        assert a.lsn == b.lsn
    else:
        assert (a.ckpt_dir, a.step, a.base_lsn) == (b.ckpt_dir, b.step, b.base_lsn)
        _log_arrays_equal(a.log_state, b.log_state)


@pytest.mark.parametrize("n_ins", [5, 6000])
def test_frames_cross_between_packages(n_ins):
    """Encoded by either package, decoded by both: equal frames, equal
    headers.  6,000 inserts make a payload past 64 KiB, whose chunks
    outgrow 4 bytes (the port's chunk-parallel CRC32C against the
    reference's byte loop)."""
    for i, (rf, pf) in enumerate(_frame_pairs(n_ins)):
        for raw in (r_encode_frame(rf, seq=10 + i), encode_frame(pf, seq=10 + i)):
            if n_ins > 5 and i == 0:
                assert len(raw) > 1 << 16
            _frames_equal(decode_frame(raw), r_decode_frame(raw))
            _frames_equal(decode_frame(raw), pf)
            hp, hr = peek_header(raw), r_peek_header(raw)
            assert (hp.kind, hp.seq, hp.payload_len, hp.crc) == \
                (hr.kind, hr.seq, hr.payload_len, hr.crc) and hp.seq == 10 + i


def test_crc32c_matches_reference_at_every_length():
    rng = np.random.default_rng(0)
    assert wire.crc32c(b"123456789") == 0xE3069283
    lim = wire._PARALLEL_MIN
    for n in (0, 1, 3, 4, 5, 63, 1000, lim - 1, lim, lim + 1, (1 << 16) - 1, 1 << 16,
              (1 << 16) + 7, 200_003):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert wire.crc32c(data, crc=n) == rwire.crc32c(data, crc=n), n
        if n:  # the chunked evaluation at other chunk counts, small inputs included
            reg = wire._crc_bytes(0xFFFFFFFF, data)
            for chunks in (1, 3, 64):
                assert wire._crc_parallel(0xFFFFFFFF, data, chunks) == reg, (n, chunks)


def test_decode_rejects_damage_alike():
    """Bit flips, truncation and foreign payloads raise the same typed
    errors in both packages; a legacy v0 frame (raw npz) still decodes."""
    rf = _frame_pairs(50)[0][0]
    raw = bytearray(r_encode_frame(rf, seq=3))
    raw[200] ^= 0x10
    for dec in (decode_frame, r_decode_frame):
        with pytest.raises(Exception) as e:
            dec(bytes(raw))
        assert type(e.value).__name__ == "FrameCorrupt"
    with pytest.raises(FrameCorrupt):
        decode_frame(bytes(raw[:-3]))
    with pytest.raises(FrameSchemaError):
        decode_frame(wire.pack_frame(1, b"not an npz"))
    with pytest.raises(FrameSchemaError):
        decode_frame(wire.pack_frame(9, b""))
    buf = io.BytesIO()
    np.savez(buf, frame_kind=np.asarray("shed"), frame_lsn=np.asarray(5, np.int64))
    assert decode_frame(buf.getvalue()) == ShedFrame(lsn=5)


# ---------------------------------------------------------------------------
# primary, tail and a checkpoint-bootstrapped lagger against the reference
# ---------------------------------------------------------------------------


def _drive(pkg: str, ckpt_dir, backend="jnp"):
    """A bounded-lag primary, a per-batch tail and a lagger that polls once
    at the end, over a queue; the same seeded batches on either package."""
    port = pkg == "port"
    kw = {"backend": backend, "device": "cpu"} if port else {}
    ks_cls, log_cls = (KeySet, ChangeLog) if port else (RKeySet, RChangeLog)
    q = QueueTransport() if port else RQueueTransport()
    prim_cls, rep_cls = (StreamPrimary, StreamReplica) if port else (RStreamPrimary,
                                                                     RStreamReplica)
    rng = np.random.default_rng(3)
    prim = prim_cls(q, _keyset(ks_cls, rng, 300), ckpt_dir=str(ckpt_dir), max_lag_batches=2,
                    **({"backend": backend, "device": "cpu"} if port else {}))
    tail, lagger = rep_cls(q, **kw), rep_cls(q, **kw)
    tail.poll()
    for _ in range(7):
        prim.publish(_random_batch(log_cls, rng, prim, n_ins=20, n_del=8))
        tail.poll()
    st = lagger.poll()
    return prim, tail, lagger, st


@pytest.fixture(scope="module")
def reference_stream(tmp_path_factory):
    return _drive("ref", tmp_path_factory.mktemp("ref_ckpt"))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_stream_with_checkpoint_catchup_matches_reference(reference_stream, tmp_path,
                                                          backend):
    rp, rt, rl, rst = reference_stream
    pp, pt, pl, pst = _drive("port", tmp_path / "ckpt", backend)
    assert pst["catchup"] and pst["truncated_jump"] and pl.stats["n_catchups"] == 1
    assert pp.stats["ckpt_step"] == 2 and pt.stats["n_catchups"] == 0
    for key in ("frames", "applied_batches", "duplicates", "catchup", "truncated_jump",
                "applied_lsn", "lag_frames"):
        assert pst[key] == rst[key], key
    assert pp.stats == rp.stats and pt.stats == rt.stats and pl.stats == rl.stats
    man, rman = step_manifest(tmp_path / "ckpt", 2), r_step_manifest(rp.ckpt_dir, 2)
    assert man["delta"] and man["base_step"] == 1
    assert {k: man[k] for k in ("step", "base_step", "delta", "meta")} == \
        {k: rman[k] for k in ("step", "base_step", "delta", "meta")}
    for got, want, what in ((pp, rp, "primary"), (pt, rt, "tail"), (pl, rl, "lagger")):
        assert _differing(got.replica, want.replica) == [], what
    # the tail and the lagger both equal the primary and a full run; the
    # lagger folded its last batches in one rebuild, so it published
    # fewer epochs (on the reference too: the states above match)
    assert _differing(pt.replica, pp.replica) == []
    assert _differing(pl.replica, pp.replica) == ["epoch"]
    _assert_matches_full_run(pl.replica, backend)
    assert pl.last_bootstrap["restore_s"] > 0 and pl.last_bootstrap["rebuild_s"] > 0
    queries = np.concatenate([np.asarray(pp.replica.keyset.words)[::4],
                              np.asarray(pp.replica.keyset.words)[:30] | np.uint32(0x10000000)])
    for rep, ref in ((pt, rt), (pl, rl)):
        f, r = rep.search_batch(queries)
        fr, rr = ref.search_batch(queries)
        np.testing.assert_array_equal(f, np.asarray(fr, bool))
        np.testing.assert_array_equal(r, np.asarray(rr, np.uint32))


def test_stream_over_a_directory_spool_and_lagging_bootstrap(tmp_path):
    """The dir transport end to end: a lagger that drains frame by frame
    after its bootstrap stays equal to the primary at every frame."""
    rng = np.random.default_rng(5)
    t = DirectoryTransport(tmp_path / "spool")
    prim = StreamPrimary(t, _keyset(KeySet, rng, 300), backend="cuda", device="cpu",
                         ckpt_dir=str(tmp_path / "ckpt"), max_lag_batches=2)
    lagger = StreamReplica(t, backend="cuda", device="cpu")
    for _ in range(6):
        prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=int(rng.integers(0, 30)),
                                   n_del=int(rng.integers(0, 10))))
    while lagger.lag_frames():
        lagger.poll(max_frames=1)
    assert lagger.stats["n_catchups"] == 1
    assert _differing(lagger.replica, prim.replica) == []


# ---------------------------------------------------------------------------
# the protocol on the port
# ---------------------------------------------------------------------------


def _port_stream(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    t = QueueTransport()
    prim = StreamPrimary(t, _keyset(KeySet, rng, n), backend="torch", device="cpu", **kw)
    return rng, t, prim


def test_bounded_lag_requires_checkpoint_config():
    with pytest.raises(BackpressureError):
        StreamPrimary(QueueTransport(), n_words=2, max_lag_batches=3)
    with pytest.raises(BackpressureError):
        StreamPrimary(QueueTransport(), _keyset(KeySet, np.random.default_rng(0), 50),
                      max_lag_batches=3, device="cpu")


def test_primary_stamps_monotonic_wire_seq():
    rng, t, prim = _port_stream(200)
    for _ in range(3):
        prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=5, n_del=0))
    assert [peek_header(t.read(i)).seq for i in range(t.end())] == list(range(t.end()))
    assert prim.stats["wire_seq"] == t.end()


def test_stream_duplicate_and_out_of_order():
    rng, t, prim = _port_stream(600)
    rep = StreamReplica(t, backend="cuda", device="cpu")
    rep.poll()
    prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=20, n_del=4))
    rep.poll()
    before = _state(rep.replica)["rid_sorted"]
    t.publish(t.read(1))  # duplicate delivery is idempotent
    st = rep.poll()
    assert st["duplicates"] == 1 and st["applied_batches"] == 0
    np.testing.assert_array_equal(before, _state(rep.replica)["rid_sorted"])
    good = _random_batch(ChangeLog, rng, prim, n_ins=10, n_del=0)
    prim.publish(good)
    bad = ChangeLog(3, start_lsn=prim.next_lsn + 100)
    bad.append_inserts(np.asarray(prim.replica.keyset.words)[:1], [1])
    bad_pos = t.publish(encode_frame(BatchFrame(log=bad, bucket=plancache.bucket(1))))
    with pytest.raises(LsnGapError):
        rep.poll()
    assert rep.applied_lsn == good.next_lsn - 1 and rep.pos == bad_pos
    assert _differing(rep.replica, prim.replica) == []


def test_stream_overlapping_batch_sliced():
    rng, t, prim = _port_stream(500)
    base_words = np.asarray(prim.replica.keyset.words)
    rep = StreamReplica(t, backend="cuda", device="cpu")
    rep.poll()
    l1 = _random_batch(ChangeLog, rng, prim, n_ins=12, n_del=0)
    prim.publish(l1)
    rep.poll()
    l2 = ChangeLog(3, start_lsn=prim.next_lsn)
    l2.append_inserts(base_words[:5], np.arange(7000, 7005, dtype=np.uint32))
    both = ChangeLog.concat([l1, l2]).slice_lsn(l1.next_lsn - 4, l2.next_lsn)
    t.publish(encode_frame(BatchFrame(log=both, bucket=plancache.bucket(len(both)))))
    prim.replica.apply(l2)
    assert rep.poll()["applied_batches"] == 1
    assert _differing(rep.replica, prim.replica) == []


def test_stream_coalesces_to_bucket():
    rng, t, prim = _port_stream(700, coalesce_min=64)
    rep = StreamReplica(t, backend="torch", device="cpu")
    rep.poll()
    genesis_frames = t.end()
    for _ in range(3):
        prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=16, n_del=0))
    assert t.end() == genesis_frames and prim.stats["pending_entries"] == 48
    prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=16, n_del=0))
    frame = decode_frame(t.read(genesis_frames))
    assert len(frame.log) == 64 and frame.bucket == plancache.bucket(64)
    assert rep.poll()["applied_batches"] == 1
    assert _differing(rep.replica, prim.replica) == []
    prim.publish(_random_batch(ChangeLog, rng, prim, n_ins=5, n_del=0))
    assert prim.flush() == 5 and prim.flush() == 0
    rep.poll()
    assert _differing(rep.replica, prim.replica) == []


def test_watermark_noop_fast_path():
    rng = np.random.default_rng(1)
    base = _keyset(KeySet, rng, 400)
    rep = Replica(base, backend="cuda", device="cpu")
    standing = rep.result
    log = ChangeLog(3, start_lsn=0)
    log.append_inserts(np.asarray(base.words)[:1], [4242])
    log.append_deletes([4242])  # cancels the insert
    st = rep.apply(log)
    assert st["noop"] and st["incremental"] and st["timings"]["build"] == 0.0
    assert rep.result.tree is standing.tree and rep.result.watermark == log.next_lsn - 1
    _assert_matches_full_run(rep, "cuda")


def _stale_bit_base(cls):
    """Rows 0/1 differ only at bit 63; deleting both makes that bit stale."""
    words = np.zeros((6, 2), np.uint32)
    words[1] = (0, 1)
    for i in range(2, 6):
        words[i] = (i << 8, 0)
    return cls(words=words, lengths=np.full(6, 8, np.int32), rids=np.arange(6, dtype=np.uint32))


def test_shed_frames_keep_replicas_identical_and_match_reference(tmp_path):
    """The primary's shed lands in the stream as a control frame; a
    per-batch tail and a replica draining the whole span in one poll both
    adopt it at the shed watermark, on the port as on the reference; a
    replica bootstrapped after the shed, and a stale shed frame, adopt
    nothing."""
    out = {}
    for pkg in ("ref", "port"):
        port = pkg == "port"
        kw = {"backend": "cuda", "device": "cpu"} if port else {}
        q = QueueTransport() if port else RQueueTransport()
        prim = (StreamPrimary if port else RStreamPrimary)(
            q, _stale_bit_base(KeySet if port else RKeySet), shed_delete_frac=0.1,
            ckpt_dir=str(tmp_path / pkg), **kw)
        rep_cls, log_cls = (StreamReplica, ChangeLog) if port else (RStreamReplica, RChangeLog)
        tail, span = rep_cls(q, **kw), rep_cls(q, **kw)
        tail.poll()
        span.poll()
        shed_batch = log_cls(2, start_lsn=prim.next_lsn)
        shed_batch.append_deletes([0, 1])
        prim.publish(shed_batch)
        st_tail = tail.poll()
        post = log_cls(2, start_lsn=prim.next_lsn)
        post.append_inserts(np.asarray([[7 << 8, 0]], np.uint32), [100])
        prim.publish(post)
        tail.poll()
        st_span = span.poll()
        prim.checkpoint()
        late = rep_cls(q, start_pos=q.end() - 1, **kw)
        st_late = late.poll()
        q.publish((encode_frame if port else r_encode_frame)(
            (ShedFrame if port else RShedFrame)(lsn=0)))
        st_stale = late.poll()
        out[pkg] = (prim, tail, span, late, st_tail, st_span, st_late, st_stale)
    prim, tail, span, late, st_tail, st_span, st_late, st_stale = out["port"]
    assert st_tail["shed_adopted"] == 1 and st_span["shed_adopted"] == 1
    assert len(st_span["applies"]) == 2 and st_span["apply"]["fallback"] == "dbitmap_changed"
    assert st_late["catchup"] and st_late["shed_adopted"] == 0 and st_stale["shed_adopted"] == 0
    assert prim.stats["n_shed_frames"] == 1
    for i, (got, want) in enumerate(zip(out["port"][:4], out["ref"][:4])):
        assert _differing(got.replica, want.replica) == [], i
        assert _differing(got.replica, prim.replica) == [], i
    for i in range(4, 8):
        g, w = out["port"][i], out["ref"][i]
        assert {k: g[k] for k in ("frames", "applied_batches", "shed_adopted", "catchup")} == \
            {k: w[k] for k in ("frames", "applied_batches", "shed_adopted", "catchup")}
