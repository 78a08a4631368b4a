"""The reference's ``apply_many`` drain, pinned: the port copies it exactly.

``tests/test_stream.py::test_catchup_equals_never_lagged_hypothesis`` fails
at these four seeds (``n_batches=3, lag_from=2``).  No catch-up runs there
(one checkpoint, ``n_catchups`` 0): the lagger drains three batches in one
poll and folds them through ``Replica.apply_many``, whose §4.3 insert rule
finds each insert's neighbors in the tree as it stood before the whole
span.  The primary and the tail apply batch by batch, so the lagger's
D-bitmap, and with it ``comp_sorted``, differ from theirs, while both hold
every true distinction bit (Theorem 2) and answer every lookup alike.

The port keeps the reference's poll cadence byte for byte.  At each seed,
on ``"torch"`` and on ``"cuda"`` (``device="cpu"``), the same seeded
batches must give: the port's lagger equal to the reference's lagger; the
port's tail equal to the reference's primary; the port's lagger differing
from its primary where the reference's differs from its own; and every
live key and miss answered alike by all of them.  Fixed seeds, no random
draw: a change to either the fault or its copy fails here, every time.
"""

import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.replication import ChangeLog as RChangeLog  # noqa: E402
from repro.replication import QueueTransport as RQueueTransport  # noqa: E402
from repro.replication import StreamPrimary as RStreamPrimary  # noqa: E402
from repro.replication import StreamReplica as RStreamReplica  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core.keyformat import KeySet  # noqa: E402
from repro_torch.replication import (  # noqa: E402
    ChangeLog,
    QueueTransport,
    StreamPrimary,
    StreamReplica,
)

#: the four recorded seeds; each reference run takes about 20 s on the
#: CPU, so this file holds the first two and
#: ``tests/test_torch_stream_pinned_more.py`` the other two
SEEDS = (952660, 832949, 427018, 618906)


def _keyset(cls, rng, n, w=3, mask=0x00FF0F0F):
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)
    return cls(words=words, lengths=np.full(n, w * 4, np.int32),
               rids=np.arange(n, dtype=np.uint32))


def _random_batch(log_cls, rng, primary, n_ins, n_del, rid_base=100_000):
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


def _drive(seed, ckpt_dir, port_backend=None, n_batches=3, lag_from=2):
    """The hypothesis test's body at one draw."""
    port = port_backend is not None
    kw = {"backend": port_backend, "device": "cpu"} if port else {}
    ks_cls, log_cls = (KeySet, ChangeLog) if port else (RKeySet, RChangeLog)
    t = QueueTransport() if port else RQueueTransport()
    prim_cls, rep_cls = (StreamPrimary, StreamReplica) if port else (RStreamPrimary,
                                                                     RStreamReplica)
    rng = np.random.default_rng(seed)
    prim = prim_cls(t, _keyset(ks_cls, rng, 300), ckpt_dir=str(ckpt_dir),
                    max_lag_batches=lag_from, **kw)
    tail, lagger = rep_cls(t, **kw), rep_cls(t, **kw)
    tail.poll()
    for _ in range(n_batches):
        prim.publish(_random_batch(log_cls, rng, prim, n_ins=int(rng.integers(0, 30)),
                                   n_del=int(rng.integers(0, 10))))
        tail.poll()
    lagger.poll()
    return prim, tail, lagger


def _state(rep) -> dict:
    res = rep.result
    if isinstance(res.comp_sorted, torch.Tensor):
        r = result_to_numpy(res)
        sorted_arrays = {k: r[k] for k in ("comp_sorted", "rid_sorted")}
    else:
        sorted_arrays = {k: np.asarray(getattr(res, k)) for k in ("comp_sorted", "rid_sorted")}
    return {
        "words": np.asarray(rep.keyset.words), "rids": np.asarray(rep.keyset.rids),
        "dbitmap": np.asarray(rep.meta.dbitmap), "varbitmap": np.asarray(rep.meta.varbitmap),
        "refkey": np.asarray(rep.meta.refkey), **sorted_arrays,
        "applied_lsn": np.asarray(rep.applied_lsn),
    }


def _differing(a, b) -> list[str]:
    sa, sb = _state(a), _state(b)
    return [k for k in sa if not (sa[k].shape == sb[k].shape and np.array_equal(sa[k], sb[k]))]


def check_pinned_seed(seed: int) -> None:
    """The four assertions at one seed, on both port backends."""
    with tempfile.TemporaryDirectory() as tmp:
        rp, rt, rl = _drive(seed, f"{tmp}/ref")
        ports = {b: _drive(seed, f"{tmp}/{b}", b) for b in ("torch", "cuda")}
    ref_diff = _differing(rl.replica, rp.replica)
    # the reference's fault as recorded: one checkpoint, no catch-up, a
    # lagger whose bitmap and sorted run differ from the primary's
    assert rp.stats["ckpt_step"] == 1 and rl.stats["n_catchups"] == 0
    assert "dbitmap" in ref_diff and "comp_sorted" in ref_diff
    assert _differing(rt.replica, rp.replica) == []
    live = np.asarray(rp.replica.keyset.words)
    queries = np.concatenate([live, live[:50] | np.uint32(0x10000000)])
    want_f, want_r = (np.asarray(x) for x in rp.replica.search_batch(queries))
    assert want_f[: live.shape[0]].all() and not want_f[live.shape[0]:].any()
    for backend, (pp, pt, pl) in ports.items():
        assert pl.stats == rl.stats and pt.stats == rt.stats, backend
        assert _differing(pl.replica, rl.replica) == [], backend
        assert _differing(pt.replica, rp.replica) == [], backend
        assert _differing(pl.replica, pp.replica) == ref_diff, backend
        for rep in (pp.replica, pt.replica, pl.replica, rl.replica):
            f, r = rep.search_batch(queries)
            np.testing.assert_array_equal(np.asarray(f, bool), want_f, err_msg=backend)
            np.testing.assert_array_equal(np.asarray(r, np.uint32), want_r, err_msg=backend)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_lagger_apply_many_drain_matches_reference(seed):
    check_pinned_seed(seed)
