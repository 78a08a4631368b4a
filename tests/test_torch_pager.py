"""The port's serving page table against the JAX reference's, on the CPU.

``repro_torch.serve.pager.PagedKVManager`` on ``"torch"`` and on
``"cuda"`` (``device="cpu"``: every kernel wrapper takes its plain
version) takes the same operations as
``repro.serve.pager.PagedKVManager(backend="jnp")`` and must hold the same
state, exactly: after every operation the page table (in its insertion
order, which orders the journal's deletes), the free list, the working
DS-metadata and the operation's return value; after every rebuild the
journal it drained (its wire bytes), the frames shipped to an attached
stream, the tree, the sorted compressed keys, ``stats`` and the page gets.
Frames written by either package are read by the other's
``StreamReplica``.  The scenarios are the reference tests' (restart
replays the log, re-alloc of a mapped slot, the shed policy, journal
shipping), on 32- to 512-page pagers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.replication import DirectoryTransport as RDirectoryTransport  # noqa: E402
from repro.replication import StreamPrimary as RStreamPrimary  # noqa: E402
from repro.replication import StreamReplica as RStreamReplica  # noqa: E402
from repro.replication.stream import decode_frame as r_decode_frame  # noqa: E402
from repro.serve.pager import PagedKVManager as RPagedKVManager  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core.snapshot import AdmissionShed  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    DirectoryTransport,
    StreamPrimary,
    StreamReplica,
    decode_frame,
)
from repro_torch.serve.pager import PagedKVManager  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")

#: every (seq, page) a scenario can map, and some it never does: the gets
PROBE = np.asarray([(s, p) for s in range(10) for p in range(12)], np.uint32)

#: name -> (pager options, operations); ``("rebuild",)`` rebuilds
SCENARIOS = {
    # restart replays the log; a quiet restart merges an empty log
    "restart": (dict(n_pages=128, page_tokens=16), [
        *[("pages_for", s, 80) for s in range(6)], ("rebuild",),
        ("free_seq", 1), ("pages_for", 3, 160), ("rebuild",),
        ("rebuild",),
    ]),
    # re-alloc of a mapped slot retires the old page in the journal
    "realloc": (dict(n_pages=32, page_tokens=8), [
        *[("alloc", s, 0) for s in range(4)], ("rebuild",),
        ("alloc", 3, 0), ("rebuild",),
    ]),
    # a freed sequence allocated again moves to the end of the table (and
    # of the next free's journal); a re-allocated slot keeps its place
    "churn": (dict(n_pages=256, page_tokens=16), [
        *[("pages_for", s, 64) for s in range(6)], ("rebuild",),
        ("free_seq", 1), ("pages_for", 1, 48), ("alloc", 0, 2), ("free_seq", 0),
        ("pages_for", 3, 160), ("free_seq", 7), ("rebuild",),
        ("pages_for", 0, 32), ("free_seq", 1), ("alloc", 2, 1), ("rebuild",),
        ("free_seq", 4), ("pages_for", 4, 64), ("rebuild",),
    ]),
    # frees past a quarter of the live keys shed the stale bits
    "shed": (dict(n_pages=512, page_tokens=16, shed_delete_frac=0.25), [
        *[("pages_for", s, 16 * 8) for s in range(8)], ("rebuild",),
        *[("free_seq", s) for s in range(4)], ("rebuild",),
    ]),
}


def _tree_numpy(res) -> dict:
    if isinstance(res.comp_sorted, torch.Tensor):
        got = result_to_numpy(res)
        return {"comp_sorted": got["comp_sorted"], **{
            k: v for k, v in got["tree"].items() if k in ("sorted_full", "sorted_rids")},
            "leaf": got["tree"]["leaf"], "levels": got["tree"]["levels"]}
    return {"comp_sorted": np.asarray(res.comp_sorted),
            "sorted_full": np.asarray(res.tree.sorted_full),
            "sorted_rids": np.asarray(res.tree.sorted_rids),
            "leaf": {k: np.asarray(v) for k, v in res.tree.leaf.items()},
            "levels": [{k: np.asarray(v) for k, v in lv.items()} for lv in res.tree.levels]}


def _frames(transport, pos0: int) -> list:
    """The change logs of the batch frames published since ``pos0``, as
    arrays, decoded by both packages."""
    out = []
    for pos in range(pos0, transport.end()):
        raw = transport.read(pos)
        logs = [decode_frame(raw).log, r_decode_frame(raw).log]
        arrays = [dict(log.arrays(), start_lsn=log.start_lsn) for log in logs]
        for k in arrays[0]:
            np.testing.assert_array_equal(arrays[0][k], arrays[1][k])
        out.append(arrays[0])
    return out


def _drive(pm, ops, transport) -> list:
    """Run ``ops``; the state after each (and, after a rebuild, what it
    drained, shipped, built and answers)."""
    out = []
    for op in ops:
        step = {"op": op}
        if op[0] == "rebuild":
            step["journal"] = pm._log.to_wire()
            pos0 = transport.end()
            res = pm.rebuild_index()
            step["frames"] = _frames(transport, pos0)
            step["tree"] = _tree_numpy(res)
            found, rid = pm.lookup_batch(PROBE)
            step["gets"] = (np.asarray(found, bool), np.asarray(rid, np.uint32))
            step["stats"] = pm.stats
        else:
            step["ret"] = getattr(pm, op[0])(*op[1:])
        step["table"] = list(pm._table.items())
        step["free"] = list(pm._free)
        step["dbitmap"] = None if pm._meta is None else np.asarray(pm._meta.dbitmap)
        out.append(step)
    return out


def _assert_steps_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        what = str(w["op"])
        for key, wv in w.items():
            gv = g[key]
            if key == "tree":
                for name in ("comp_sorted", "sorted_full", "sorted_rids"):
                    np.testing.assert_array_equal(gv[name], wv[name], err_msg=what)
                for name in wv["leaf"]:
                    np.testing.assert_array_equal(gv["leaf"][name], wv["leaf"][name],
                                                  err_msg=f"{what}: leaf.{name}")
                assert len(gv["levels"]) == len(wv["levels"]), what
                for lg, lw in zip(gv["levels"], wv["levels"]):
                    for name in lw:
                        np.testing.assert_array_equal(lg[name], lw[name], err_msg=what)
            elif key == "frames":
                assert len(gv) == len(wv), what
                for fg, fw in zip(gv, wv):
                    for name in fw:
                        np.testing.assert_array_equal(fg[name], fw[name], err_msg=what)
            elif key == "gets":
                np.testing.assert_array_equal(gv[0], wv[0], err_msg=what)
                np.testing.assert_array_equal(gv[1], wv[1], err_msg=what)
            elif key == "dbitmap" and wv is not None:
                np.testing.assert_array_equal(gv, wv, err_msg=what)
            else:
                assert gv == wv, f"{what}: {key}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each scenario on the reference pager, journal shipped to a spool
    (computed once: the reference compiles each shape it meets)."""
    out = {}
    for name, (opts, ops) in SCENARIOS.items():
        spool = tmp_path_factory.mktemp(f"ref_{name}")
        t = RDirectoryTransport(spool)
        pm = RPagedKVManager(backend="jnp", **opts)
        pm.attach_stream(RStreamPrimary(t, n_words=2))
        out[name] = (spool, _drive(pm, ops, t), pm)
    return out


def _port_run(name, backend, spool):
    opts, ops = SCENARIOS[name]
    t = DirectoryTransport(spool)
    pm = PagedKVManager(backend=backend, device="cpu", **opts)
    pm.attach_stream(StreamPrimary(t, n_words=2, device="cpu"))
    return _drive(pm, ops, t), pm


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_pager_matches_reference_after_every_operation(reference, tmp_path, name, backend):
    _, want, _ = reference[name]
    got, pm = _port_run(name, backend, tmp_path / "spool")
    _assert_steps_equal(got, want)
    # the wire bytes of each drained journal are the reference's
    assert [s.get("journal") for s in got] == [s.get("journal") for s in want]


def test_pager_scenarios_exercise_their_paths(reference):
    """The scenarios reach what they are named for (the reference's own
    assertions, on the reference's trajectory)."""
    steps = {name: [s for s in reference[name][1] if s["op"] == ("rebuild",)]
             for name in SCENARIOS}
    assert steps["restart"][0]["stats"]["last_rebuild"]["incremental"] is False
    assert steps["restart"][1]["stats"]["last_rebuild"]["log_entries_replayed"] > 0
    assert steps["restart"][2]["stats"]["last_rebuild"] == {
        "incremental": True, "fallback": None, "log_entries_replayed": 0,
        "shed_bits": False}
    assert steps["restart"][2]["frames"] == []  # a quiet rebuild ships nothing
    realloc = reference["realloc"][1]
    old = dict(realloc[3]["table"])[(3, 0)]
    assert realloc[5]["ret"] != old and old in realloc[5]["free"]
    assert [f["ops"].tolist() for f in steps["realloc"][1]["frames"]] == [[2, 1]]
    assert [s["stats"]["last_rebuild"]["shed_bits"] for s in steps["shed"]] == [False, True]
    assert any(s["stats"]["last_rebuild"]["incremental"] for s in steps["churn"][1:])
    assert any(s["stats"]["last_rebuild"]["fallback"] == "dbitmap_changed"
               for s in steps["churn"][1:])


@pytest.mark.parametrize("name", ["restart", "churn"])
def test_stream_frames_cross_between_packages(reference, tmp_path, name):
    """A standby of either package follows the other's spool and answers
    every mapped page with its physical page; freed pages miss."""
    ref_spool, _, ref_pm = reference[name]
    _, pm = _port_run(name, "torch", tmp_path / "spool")
    for spool, standby in ((tmp_path / "spool", RStreamReplica(RDirectoryTransport(
            tmp_path / "spool"))), (ref_spool, StreamReplica(DirectoryTransport(ref_spool),
                                                            backend="torch", device="cpu"))):
        standby.poll()
        table = pm._table
        keys = np.asarray(list(table), np.uint32)
        found, rid = standby.search_batch(keys)
        assert np.asarray(found).all()
        np.testing.assert_array_equal(np.asarray(rid, np.uint32),
                                      np.fromiter(table.values(), np.uint32))
        gone = np.asarray([(9, 0), (8, 3)], np.uint32)
        assert not np.asarray(standby.search_batch(gone)[0]).any()
    assert ref_pm._table == pm._table


def test_pager_ships_journal_and_standby_follows(tmp_path):
    """The reference's standby test on the port: the standby answers
    every mapped page, the freed sequence misses, and a quiet rebuild
    ships nothing."""
    t = DirectoryTransport(tmp_path / "spool")
    pm = PagedKVManager(n_pages=256, page_tokens=16, backend="torch", device="cpu")
    pm.attach_stream(StreamPrimary(t, n_words=2, device="cpu"))
    for s in range(6):
        pm.pages_for(s, 80)
    pm.rebuild_index()
    pm.free_seq(1)
    pm.pages_for(3, 160)
    pm.rebuild_index()
    standby = StreamReplica(t, backend="torch", device="cpu")
    standby.poll()
    for (s, p), phys in pm._table.items():
        found, rid = standby.search(np.asarray([s, p], np.uint32))
        assert found and rid == phys
    assert not standby.search(np.asarray([1, 0], np.uint32))[0]
    before = t.end()
    pm.rebuild_index()
    assert t.end() == before


def test_attach_stream_checks_width_and_lsn(tmp_path):
    pm = PagedKVManager(n_pages=16, page_tokens=4, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="2-word"):
        pm.attach_stream(StreamPrimary(DirectoryTransport(tmp_path / "a"), n_words=3,
                                       device="cpu"))
    pm.alloc(0, 0)
    pm.rebuild_index()  # the journal now starts at LSN 1
    with pytest.raises(ValueError, match="LSN"):
        pm.attach_stream(StreamPrimary(DirectoryTransport(tmp_path / "b"), n_words=2,
                                       device="cpu"))


def test_pager_out_of_pages_and_empty_table():
    pm = PagedKVManager(n_pages=2, page_tokens=4, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="empty page table"):
        pm.rebuild_index()
    pm.pages_for(0, 8)
    with pytest.raises(MemoryError):
        pm.alloc(1, 0)


def test_pager_admission_knobs():
    """The reference's admission test on the port: a journal backlog past
    the lag bound sheds reads until the rebuild drains it."""
    pm = PagedKVManager(
        n_pages=64, page_tokens=16, backend="torch", device="cpu", read_through_dirty=True,
        max_lag_epochs=0, admission="shed", lag_entries_per_epoch=4,
    )
    pm.pages_for(0, 64)
    pm.rebuild_index()
    assert pm.stats["snapshot"]["max_lag_epochs"] == 0
    for s in range(1, 9):
        pm.pages_for(s, 16)
    assert pm.stats["snapshot"]["lag_epochs"] >= 1
    with pytest.raises(AdmissionShed):
        pm.lookup(0, 0)
    pm.rebuild_index()
    assert pm.lookup(0, 0) is not None
    assert pm.stats["snapshot"]["shed"] == 1

