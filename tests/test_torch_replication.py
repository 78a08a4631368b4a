"""The port's replica, transports, supervisor and chaos layer against the
JAX reference's, on the CPU.

``repro_torch.replication.Replica`` on ``"torch"`` and on ``"cuda"``
(``device="cpu"``: every kernel wrapper takes its plain version, the insert
rule's rank included) is given the same seeded numpy batches as
``repro.replication.Replica(backend="jnp")`` and must hold the same state
after every step, exactly: keyset, working DS-metadata, sorted run, rid
and row permutations, tree, watermark, the apply stats and the search
answers — through an incremental apply with duplicate inserts, an
``apply_many``, the fallback of a new distinction bit, a no-op batch, a
local shed and a stream-driven ``adopt_shed``.  The transports keep the
reference's semantics and read the reference's spools; ``ChaosPlan`` and
``FaultyTransport`` draw the reference's fault schedule seed for seed;
the supervisor walks the reference's ladder with a no-op ``sleep``; the
port's chaos soak passes on both transports and both port backends.  Shapes
are the reference tests': W = 3, mask ``0x00FF0F0F``, n of 300-600.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.replication import ChangeLog as RChangeLog  # noqa: E402
from repro.replication import ChaosPlan as RChaosPlan  # noqa: E402
from repro.replication import DirectoryTransport as RDirectoryTransport  # noqa: E402
from repro.replication import FaultyTransport as RFaultyTransport  # noqa: E402
from repro.replication import FrameCorrupt as RFrameCorrupt  # noqa: E402
from repro.replication import FrameTruncated as RFrameTruncated  # noqa: E402
from repro.replication import LsnGapError as RLsnGapError  # noqa: E402
from repro.replication import QueueTransport as RQueueTransport  # noqa: E402
from repro.replication import Replica as RReplica  # noqa: E402
from repro.replication import ReplicaSupervisor as RReplicaSupervisor  # noqa: E402
from repro.replication import SupervisorPolicy as RSupervisorPolicy  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    ChangeLog,
    ChaosPlan,
    DirectoryTransport,
    FaultyTransport,
    FrameCorrupt,
    FrameSchemaError,
    FrameTruncated,
    LsnGapError,
    QueueTransport,
    Replica,
    ReplicaSupervisor,
    StreamPrimary,
    StreamReplica,
    SupervisorPolicy,
)
from repro_torch.tools import chaos_soak  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")
MASK = 0x00FF0F0F


def _words(seed: int, n: int, w: int = 3, mask: int = MASK) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


def _keysets(words: np.ndarray, rid_base: int = 0):
    """The same rows as a reference and a port ``KeySet``."""
    n, w = words.shape
    cols = dict(words=words, lengths=np.full(n, 4 * w, np.int32),
                rids=np.arange(rid_base, rid_base + n, dtype=np.uint32))
    return RKeySet(**cols), KeySet(**cols)


def _logs(start_lsn: int, n_words: int, inserts=None, ins_rids=None, deletes=None):
    """The same batch as a reference and a port ``ChangeLog``."""
    out = []
    for cls in (RChangeLog, ChangeLog):
        log = cls(n_words, start_lsn=start_lsn)
        if inserts is not None and len(inserts):
            log.append_inserts(inserts, ins_rids)
        if deletes is not None and len(deletes):
            log.append_deletes(deletes)
        out.append(log)
    return out


def _state(rep) -> dict:
    """A replica's whole state as numpy (either package)."""
    res = rep.result
    if isinstance(res.comp_sorted, torch.Tensor):
        got = result_to_numpy(res)
    else:
        got = {
            "comp_sorted": np.asarray(res.comp_sorted), "rid_sorted": np.asarray(res.rid_sorted),
            "row_sorted": np.asarray(res.row_sorted),
            "tree": {"sorted_full": np.asarray(res.tree.sorted_full),
                     "sorted_rids": np.asarray(res.tree.sorted_rids),
                     "leaf": {k: np.asarray(v) for k, v in res.tree.leaf.items()},
                     "levels": [{k: np.asarray(v) for k, v in lv.items()}
                                for lv in res.tree.levels]},
        }
    return {
        "words": np.asarray(rep.keyset.words), "rids": np.asarray(rep.keyset.rids),
        "lengths": np.asarray(rep.keyset.lengths),
        "dbitmap": np.asarray(rep.meta.dbitmap), "varbitmap": np.asarray(rep.meta.varbitmap),
        "refkey": np.asarray(rep.meta.refkey), "extract_bitmap": np.asarray(res.extract_bitmap),
        "comp_sorted": got["comp_sorted"], "rid_sorted": got["rid_sorted"],
        "row_sorted": got["row_sorted"], "sorted_full": got["tree"]["sorted_full"],
        "sorted_rids": got["tree"]["sorted_rids"],
        "leaf": got["tree"]["leaf"], "levels": got["tree"]["levels"],
        "applied_lsn": rep.applied_lsn, "watermark": res.watermark,
        "deletes_since_shed": rep.deletes_since_shed, "epoch": rep.snapshots.epoch,
    }


def _assert_state_equal(got: dict, want: dict, what: str) -> None:
    for key, w in want.items():
        g = got[key]
        if key == "leaf":
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}: leaf.{k}")
        elif key == "levels":
            assert len(g) == len(w), f"{what}: tree height"
            for lg, lw in zip(g, w):
                for k in lw:
                    np.testing.assert_array_equal(lg[k], lw[k], err_msg=f"{what}: level {k}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {key}")
        else:
            assert g == w, f"{what}: {key} {g} != {w}"


_STAT_KEYS = ("incremental", "fallback", "noop", "n_delta", "n_deleted", "n_keys",
              "shed_bits", "deletes_since_shed", "applied_lsn")


def _scenario(words: np.ndarray):
    """The batches of the replica trajectory, each as a (reference, port)
    log pair, with the kind of step: duplicates of live keys and deletes
    (incremental), two batches through ``apply_many``, a key with a bit
    no base key has (fallback), a cancelling batch (no-op), then a bulk
    delete that crosses the shed threshold and makes the new bit stale
    (local shed) and an insert under the shed bitmap (the full resort)."""
    rng = np.random.default_rng(11)
    n, w = words.shape
    steps = []
    lsn = 0

    def batch(inserts=None, ins_rids=None, deletes=None):
        nonlocal lsn
        pair = _logs(lsn, w, inserts, ins_rids, deletes)
        lsn = pair[1].next_lsn
        return pair

    dup = words[rng.integers(0, n, 40)]
    steps.append(("apply", [batch(dup, 1000 + np.arange(40), rng.choice(n, 8, replace=False))]))
    many = [batch(words[rng.integers(0, n, 12)], 2000 + np.arange(12),
                  rng.choice(np.arange(8, n), 5, replace=False)),
            batch(words[rng.integers(0, n, 9)], 3000 + np.arange(9), [1000, 1001, 2003])]
    steps.append(("apply_many", many))
    newbit = words[:3].copy()
    newbit[:, 0] |= np.uint32(0x80000000)
    steps.append(("apply", [batch(newbit, 4000 + np.arange(3))]))
    steps.append(("apply", [batch(words[5:6], [5000], [5000])]))
    # 90 base rows and the three new-bit keys: the shed drops their bit
    steps.append(("apply", [batch(deletes=np.r_[np.arange(20, 110), 4000 + np.arange(3)])]))
    steps.append(("apply", [batch(words[rng.integers(0, n, 6)], 6000 + np.arange(6))]))
    return steps


def _drive(rep, steps, pick: int, queries: np.ndarray):
    """Run the trajectory on ``rep`` (``pick`` 0: the reference's logs, 1:
    the port's); the state, stats and answers after bring-up and each step."""
    out = [("bring-up", _state(rep), None, rep.search_batch(queries))]
    for kind, pairs in steps:
        logs = [p[pick] for p in pairs]
        st = rep.apply(logs[0]) if kind == "apply" else rep.apply_many(logs)
        found, rid = rep.search_batch(queries)
        out.append((kind, _state(rep), {k: st[k] for k in _STAT_KEYS},
                    (np.asarray(found, bool), np.asarray(rid, np.uint32))))
    return out


@pytest.fixture(scope="module")
def trajectory():
    """The reference replica's trajectory (computed once: the reference
    compiles each shape it meets)."""
    words = _words(7, 300)
    rks, _ = _keysets(words)
    steps = _scenario(words)
    queries = np.concatenate([words[::3], _words(8, 40) | np.uint32(0x01000000)])
    ref = _drive(RReplica(rks, backend="jnp", shed_delete_frac=0.25), steps, 0, queries)
    return words, steps, queries, ref


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_replica_trajectory_matches_reference(trajectory, backend):
    words, steps, queries, ref = trajectory
    _, pks = _keysets(words)
    rep = Replica(pks, backend=backend, device="cpu", shed_delete_frac=0.25)
    got = _drive(rep, steps, 1, queries)
    kinds = []
    for i, ((kind, gs, gst, (gf, gr)), (_, ws, wst, (wf, wr))) in enumerate(zip(got, ref)):
        what = f"step {i} ({kind})"
        _assert_state_equal(gs, ws, what)
        assert gst == wst, what
        np.testing.assert_array_equal(gf, np.asarray(wf, bool), err_msg=what)
        np.testing.assert_array_equal(gr, np.asarray(wr, np.uint32), err_msg=what)
        kinds.append(None if gst is None else
                     ("noop" if gst["noop"] else gst["fallback"] or "incremental",
                      gst["shed_bits"]))
    # the trajectory takes every path it names
    assert kinds == [None, ("incremental", False), ("incremental", False),
                     ("dbitmap_changed", False), ("noop", False),
                     ("incremental", True), ("dbitmap_changed", False)]
    assert rep.stats == {**rep.stats, "applied_lsn": ref[-1][1]["applied_lsn"],
                         "n_applied_batches": len(steps)}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_replica_adopt_shed_and_meta_match_reference(backend):
    """A stream-driven shed: deletes leave a stale bit, ``adopt_shed`` flips
    the working bitmap to the refreshed one, the next insert pays the full
    resort — as on the reference; ``search`` equals its batch row."""
    words = np.zeros((6, 2), np.uint32)
    words[1] = (0, 1)
    for i in range(2, 6):
        words[i] = (i << 8, 0)
    rks, pks = _keysets(words)
    ref = RReplica(rks, backend="jnp")
    rep = Replica(pks, backend=backend, device="cpu")
    r1, p1 = _logs(0, 2, deletes=[0, 1])
    ref.apply(r1)
    rep.apply(p1)
    assert rep.adopt_shed() is ref.adopt_shed() is True
    assert rep.adopt_shed() is ref.adopt_shed() is False  # idempotent
    r2, p2 = _logs(p1.next_lsn, 2, np.asarray([[7 << 8, 0]], np.uint32), [100])
    wst, gst = ref.apply(r2), rep.apply(p2)
    assert gst["fallback"] == wst["fallback"] == "dbitmap_changed"
    _assert_state_equal(_state(rep), _state(ref), "after the adopted shed")
    for key in words[2:]:
        assert rep.search(key) == ref.search(key)
    assert rep.search(words[0]) == (False, 0xFFFFFFFF)


def test_replica_rejects_a_log_of_another_width():
    _, pks = _keysets(_words(3, 50))
    rep = Replica(pks, backend="torch", device="cpu")
    with pytest.raises(ValueError):
        rep.apply(ChangeLog(2))


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["queue", "dir"])
def test_transport_semantics(tmp_path, kind):
    t = QueueTransport() if kind == "queue" else DirectoryTransport(tmp_path / "s")
    assert t.first_pos() == t.end() == 0 and t.read(0) is None
    for i in range(5):
        assert t.publish(f"frame{i}".encode()) == i
    assert t.end() == 5 and t.read(2) == b"frame2" and t.read(5) is None
    assert t.truncate_before(3) == 3
    assert t.first_pos() == 3 and len(t) == 2
    with pytest.raises(FrameTruncated):
        t.read(1)
    assert t.publish(b"six") == 5  # positions never reused
    t.truncate_before(6)
    assert t.first_pos() == t.end() == 6
    assert t.publish(b"seven") == 6


def test_directory_spools_cross_between_packages(tmp_path):
    """A spool written by either package's ``DirectoryTransport`` (frames,
    truncation, END marker) reads the same through the other's, and a
    torn temp frame stays invisible to both."""
    for writer, reader in ((RDirectoryTransport, DirectoryTransport),
                           (DirectoryTransport, RDirectoryTransport)):
        root = tmp_path / writer.__module__.split(".")[0]
        w = writer(root)
        for i in range(6):
            w.publish(bytes([i]) * (i + 1))
        w.truncate_before(6)  # empties the spool: END keeps the numbering
        w.publish(b"after")
        (root / ".tmp_frame_0000000007.bin").write_bytes(b"torn")
        r = reader(root)
        assert (r.first_pos(), r.end(), r.read(6), r.read(7)) == (6, 7, b"after", None)
        with pytest.raises((FrameTruncated, RFrameTruncated)):
            r.read(2)
        assert r.publish(b"next") == 7  # takes the torn frame's place
        assert sorted(p.name for p in root.iterdir()) == [
            "END", "frame_0000000006.bin", "frame_0000000007.bin"]
        assert writer(root).read(7) == b"next"


# ---------------------------------------------------------------------------
# chaos: the reference's fault schedule, seed for seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 17, 123456])
def test_chaos_plans_and_fault_ledgers_match_reference(seed):
    """``ChaosPlan.sample`` gives the reference's plan, and a
    ``FaultyTransport`` driven through one scripted mix of publishes,
    reads and a quiesce deals the reference's faults in the same order:
    equal ledgers, counts, inner frames and read results."""
    plan = ChaosPlan.sample(seed, n_publishes_hint=30, intensity=2.5)
    rplan = RChaosPlan.sample(seed, n_publishes_hint=30, intensity=2.5)
    assert plan.__dict__ == rplan.__dict__
    runs = []
    for ft_cls, q_cls, truncated in ((FaultyTransport, QueueTransport, FrameTruncated),
                                     (RFaultyTransport, RQueueTransport, RFrameTruncated)):
        p = plan if ft_cls is FaultyTransport else rplan
        ft = ft_cls(q_cls(), p)
        reads = []
        for i in range(30):
            ft.publish(f"frame-{i:03d}".encode() * 4)
            for pos in (i // 2, i, max(0, i - 5)):
                try:
                    reads.append(ft.read(pos))
                except truncated:
                    reads.append("truncated")
        ft.quiesce()
        runs.append((ft.ledger, ft.counts, [ft.inner.read(j) for j in
                                            range(ft.inner.first_pos(), ft.inner.end())],
                     reads))
    assert runs[0] == runs[1]
    assert sum(runs[0][1].values()) > 10  # the plan was hostile


# ---------------------------------------------------------------------------
# the supervisor ladder (stub replica, fake clock, no-op sleep)
# ---------------------------------------------------------------------------


class _StubReplica:
    """Scripted poll outcomes: exceptions raise, dicts return."""

    def __init__(self, script, resync_ok=True):
        self.script = list(script)
        self.pos = 0
        self.resync_ok = resync_ok
        self.n_resyncs = 0

    def poll(self, max_frames=None):
        item = self.script.pop(0) if self.script else {"lag_frames": 0}
        if isinstance(item, Exception):
            raise item
        return dict(item)

    def resync(self):
        self.n_resyncs += 1
        return self.resync_ok


class _FakeTime:
    """A tick-per-call clock and a delay-recording sleep."""

    def __init__(self):
        self.now = 0.0
        self.slept = []

    def clock(self):
        self.now += 1.0
        return self.now

    def sleep(self, s):
        self.slept.append(round(s, 6))


def _ladder(sup_cls, pol_cls, errors, script, pumps, resync_ok=True, **policy):
    """Pump a supervisor over a stub whose polls follow ``script`` (an
    error class name, or a clean poll), then re-arm and pump once more;
    returns everything the ladder recorded."""
    ft = _FakeTime()
    items = [errors[s](s) if s in errors else {"lag_frames": 0} for s in script]
    stub = _StubReplica(items, resync_ok=resync_ok)
    sup = sup_cls(stub, pol_cls(**policy), clock=ft.clock, sleep=ft.sleep)
    outs = [sup.pump() for _ in range(pumps)]
    sup.reset()
    outs.append(sup.pump())
    stats = sup.stats()
    return outs, stats, ft.slept, stub.n_resyncs, sup.state


_LADDERS = {
    "reread": (["corrupt", "ok"], 1, True, {}),
    "backoff": (["corrupt"] * 3 + ["ok"], 1, True, {"retries": {"corrupt": 3}}),
    "jitter": (["corrupt"] * 3 + ["ok"], 1, True,
               {"retries": {"corrupt": 3}, "jitter": lambda: 2.0}),
    "resync": (["corrupt"] * 4 + ["ok"], 1, True, {}),
    "schema": (["schema"] * 3 + ["ok"], 2, True, {}),
    "await_checkpoint": (["gap"] * 40, 8, False, {}),
    "quarantine": (["corrupt"] * 80, 4, True, {"quarantine_after": 3}),
}


@pytest.mark.parametrize("name", sorted(_LADDERS))
def test_supervisor_ladder_matches_reference(name):
    script, pumps, resync_ok, policy = _LADDERS[name]
    port = _ladder(ReplicaSupervisor, SupervisorPolicy,
                   {"corrupt": FrameCorrupt, "schema": FrameSchemaError, "gap": LsnGapError},
                   script, pumps, resync_ok, **policy)
    from repro.replication import FrameSchemaError as RFrameSchemaError

    ref = _ladder(RReplicaSupervisor, RSupervisorPolicy,
                  {"corrupt": RFrameCorrupt, "schema": RFrameSchemaError, "gap": RLsnGapError},
                  script, pumps, resync_ok, **policy)
    assert port == ref


def test_supervisor_ladder_rungs():
    """The rungs themselves: a free re-read, then exponential backoff; a
    resync once the budget is spent; no quarantine while no checkpoint is
    visible; quarantine of a stuck position, then an operator reset."""
    outs, stats, slept, resyncs, _ = _ladder(
        ReplicaSupervisor, SupervisorPolicy, {"corrupt": FrameCorrupt},
        ["corrupt"] * 3 + ["ok"], 1, retries={"corrupt": 3})
    assert outs[0]["recovered"] and slept == [0.05, 0.1] and resyncs == 0
    outs, _, _, resyncs, _ = _ladder(ReplicaSupervisor, SupervisorPolicy,
                                     {"corrupt": FrameCorrupt}, ["corrupt"] * 4 + ["ok"], 1)
    assert outs[0]["resyncs"] == 1 and resyncs == 1
    outs, stats, _, _, state = _ladder(ReplicaSupervisor, SupervisorPolicy,
                                       {"gap": LsnGapError}, ["gap"] * 40, 8, resync_ok=False)
    assert all(o["awaiting_checkpoint"] for o in outs[:8]) and stats["n_quarantines"] == 0
    outs, stats, _, _, _ = _ladder(ReplicaSupervisor, SupervisorPolicy,
                                   {"corrupt": FrameCorrupt}, ["corrupt"] * 80, 4,
                                   quarantine_after=3)
    assert [o["state"] for o in outs[:4]] == ["degraded", "degraded", "quarantined",
                                              "quarantined"]
    assert outs[3] == {"state": "quarantined", "pumped": False, "recovered": False}
    assert stats["n_quarantines"] == 1 and outs[4]["state"] == "degraded"


def test_supervisor_heals_read_corruption_end_to_end(tmp_path):
    """A real primary and replica over a wire that flips bits on half the
    reads: the supervised replica ends healthy and byte-identical."""
    words = _words(4, 400)
    _, pks = _keysets(words)
    wire = FaultyTransport(QueueTransport(), ChaosPlan(seed=5, p_corrupt=0.5, corrupt_bits=3))
    prim = StreamPrimary(wire, pks, backend="torch", device="cpu",
                         ckpt_dir=str(tmp_path / "ckpt"), max_lag_batches=4)
    rep = StreamReplica(wire, backend="cuda", device="cpu", reorder_window=4)
    sup = ReplicaSupervisor(rep, sleep=lambda s: None)
    for i in range(5):
        log = ChangeLog(3, start_lsn=prim.next_lsn)
        log.append_inserts(np.asarray(prim.replica.keyset.words)[:6],
                           np.arange(6, dtype=np.uint32) + 9000 + 100 * i)
        prim.publish(log)
        sup.pump()
    wire.quiesce()
    prim.flush()
    prim.checkpoint()
    for _ in range(20):
        out = sup.pump()
        if "error_class" not in out and out.get("lag_frames", 1) == 0:
            break
    assert sup.state == "healthy"
    assert wire.counts.get("corrupt", 0) >= 1 and sup.n_retries.get("corrupt", 0) >= 1
    assert chaos_soak._identical(rep.replica, prim.replica) == []


# ---------------------------------------------------------------------------
# the port's chaos soak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,kind,backend", [(0, "queue", "torch"), (1, "queue", "cuda"),
                                               (2, "dir", "torch"), (3, "dir", "cuda")])
def test_chaos_soak_fast(tmp_path, seed, kind, backend):
    rep = chaos_soak.run_soak(seed, kind, backend, str(tmp_path), steps=8, n_replicas=2,
                              device="cpu")
    assert rep["violations"] == [], rep
    assert rep["survivors"] == 2 and rep["steady_traces"] == 0
    assert sum(rep["faults_injected"].values()) > 0


def test_chaos_soak_cli(capsys):
    assert chaos_soak._parse_seeds("0-3") == [0, 1, 2, 3]
    assert chaos_soak._parse_seeds("1,4,7") == [1, 4, 7]
    assert chaos_soak._parse_seeds("0-1,5") == [0, 1, 5]
    rc = chaos_soak.main(["--seeds", "0-1", "--transports", "queue,dir", "--fast",
                          "--steps", "6", "--backend", "torch", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "4 runs, 0 failing" in out and out.count("steady_traces=0") == 4
