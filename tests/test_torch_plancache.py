"""The port's plan cache against the JAX reference's, on the CPU.

``repro_torch.core.plancache.PlanCache`` is driven through the same key
sequences as ``repro.core.plancache.PlanCache`` (counters, per-op
attribution, LRU victims, auto-sizing), and the reference's zero-retrace
cases run on the port with the reference beside them: the same calls
record the same programs, hits, misses and traces.  On the CPU a trace is
a program's first eager run at a new input signature.  The padded lookups
(``lookup`` and ``lookup_many``, with dead and all-ones lanes, at bucket
edges) answer byte for byte as the reference's, and the load harnesses
and the soak report zero warm traces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.core import btree as RB  # noqa: E402
from repro.core import plancache as RP  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.metadata import meta_from_keys as r_meta_from_keys  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, meta_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.core import plancache as TP  # noqa: E402
from repro_torch.core.btree import stack_trees  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402

ONES = np.uint32(0xFFFFFFFF)


def _words(seed, n, w=3, mask=0x00FF0F0F):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


def _keysets(seed, n, w=3, rid_base=0):
    """The same keys as a reference and a port keyset."""
    words = _words(seed, n, w)
    lengths = np.full(n, w * 4, np.int32)
    rids = np.arange(rid_base, rid_base + n, dtype=np.uint32)
    return (RKeySet(words=words, lengths=lengths, rids=rids),
            keyset_from_numpy(words, lengths, rids))


def _meta_pair(words):
    rm = r_meta_from_keys(words)
    return rm, meta_from_numpy(rm.dbitmap, rm.varbitmap, rm.refkey, rm.n_words)


def _port_tree(rtree):
    return tree_from_numpy(
        [{k: np.asarray(v) for k, v in lv.items()} for lv in rtree.levels],
        {k: np.asarray(v) for k, v in rtree.leaf.items()},
        np.asarray(rtree.sorted_full), np.asarray(rtree.sorted_rids), rtree.n_keys,
        rtree.config, device="cpu")


def _per_op(stats, rename=None):
    """Per-op counters with the port's op names mapped to the reference's."""
    rename = rename or {}
    return {rename.get(op, op): c for op, c in stats["per_op"].items()}


# ---------------------------------------------------------------------------
# the cache: counters, LRU, auto-size, scoping
# ---------------------------------------------------------------------------


def _key_sequence(seed, n_calls=240, n_keys=12):
    rng = np.random.default_rng(seed)
    ops = ("sort", "merge", "lookup", "build_leaf")
    keys = [(ops[i % 4], "b", 256 << (i // 4)) for i in range(n_keys)]
    # a hot set most of the time, the rest spread: the LRU has work to do
    idx = np.where(rng.random(n_calls) < 0.6, rng.integers(0, 3, n_calls),
                   rng.integers(0, n_keys, n_calls))
    return [keys[i] for i in idx]


@pytest.mark.parametrize("kw", [
    {},
    {"max_programs": 4},
    {"max_programs": 2, "auto_size": True, "auto_size_window": 16, "auto_size_cap": 16},
])
def test_counters_lru_and_auto_size_equal_the_reference(kw):
    seq = _key_sequence(len(kw))
    got, want = TP.PlanCache(**kw), RP.PlanCache(**kw)
    for key in seq:
        got.program(key, object)
        want.program(key, object)
    assert got.stats() == want.stats()
    assert list(got.programs) == list(want.programs)  # recency order: LRU victims
    assert (got.evictions, got.resizes, got.max_programs) == \
        (want.evictions, want.resizes, want.max_programs)
    if kw.get("auto_size"):
        assert got.resizes >= 1


def test_traces_count_signatures_as_the_reference_jit_does():
    """A program traces once per input signature (shapes, dtypes); plain
    counts are data.  The traces land under the op whose builder made
    the program, and outside any builder under ``"_unkeyed"``."""
    got, want = TP.PlanCache(), RP.PlanCache()

    def body(x, n):
        return x * 2 + n

    t_prog = got.program(("sort", "b", 4), lambda: got.traced(body))
    r_prog = want.program(("sort", "b", 4), lambda: want.jit(body))
    for rows, n in ((4, 3), (4, 1), (8, 5), (4, 2), (8, 8)):
        x = np.arange(rows * 2, dtype=np.uint32).reshape(rows, 2)
        t_prog(torch.as_tensor(x.astype(np.int64)), n)
        r_prog(jnp.asarray(x), np.uint32(n))
        got.program(("sort", "b", 4), lambda: got.traced(body))
        want.program(("sort", "b", 4), lambda: want.jit(body))
    loose_t, loose_r = got.traced(body), want.jit(body)
    loose_t(torch.zeros((3, 2), dtype=torch.int64), 1)
    loose_r(jnp.zeros((3, 2), jnp.uint32), np.uint32(1))
    assert got.stats() == want.stats()
    assert got.stats()["per_op"] == {"sort": {"hits": 5, "misses": 1, "traces": 2},
                                     "_unkeyed": {"hits": 0, "misses": 0, "traces": 1}}


def test_bounds_scoping_and_reset_as_the_reference():
    for mod in (TP, RP):
        with pytest.raises(ValueError, match="max_programs must be >= 1 or None"):
            mod.PlanCache(max_programs=0)
        with pytest.raises(ValueError, match="max_programs must be >= 1 or None"):
            mod.set_max_programs(0)
    g = TP.get_cache()
    try:
        TP.set_max_programs(5)
        assert g.max_programs == 5
        TP.set_max_programs(None)
        assert g.max_programs is None
        n_before = TP.cache_stats()["programs"]
        with TP.scoped_cache() as scoped:
            assert TP.get_cache() is scoped and scoped is not g
            TP.get_cache().program(("sort", "scoped", 1), object)
            assert TP.cache_stats()["programs"] == 1
        assert TP.get_cache() is g and TP.cache_stats()["programs"] == n_before
        assert scoped.stats()["programs"] == 0  # a fresh scope is freed on exit
        mine = TP.PlanCache()
        with TP.scoped_cache(mine):
            TP.get_cache().program(("sort", "mine", 1), object)
        assert mine.stats()["programs"] == 1  # a given cache is the caller's
        g.program(("sort", "global", 1), object)
        TP.reset_cache()
        assert TP.cache_stats() == RP.PlanCache().stats()
    finally:
        TP.set_max_programs(None)


def test_tune_chunking_runs_in_a_scoped_cache():
    before = TP.cache_stats()
    plan = ReconstructionPipeline(backend="torch", device="cpu").tune_chunking(
        candidates=(256, 512), ref_n=4096)
    assert plan.chunk_size in (256, 512)
    assert TP.cache_stats() == before


# ---------------------------------------------------------------------------
# the reference's zero-retrace cases, with the reference beside them
# ---------------------------------------------------------------------------


def test_merge_same_bucket_zero_retrace_as_the_reference():
    """test_plancache.py: drifting (na, nb) inside one bucket pair replays
    one merge; crossing bucket a traces the new program."""
    from repro.core.dbits import sort_words_keyed as r_sort

    got, want = TP.PlanCache(), RP.PlanCache()
    rng = np.random.default_rng(5)
    for step, (na, nb) in enumerate(((1000, 100), (1010, 90), (997, 127), (2000, 100))):
        ka, ra = r_sort(jnp.asarray(rng.integers(0, 2**16, (na, 2), dtype=np.uint32)),
                        jnp.arange(na, dtype=jnp.uint32))
        kb, rb = r_sort(jnp.asarray(rng.integers(0, 2**16, (nb, 2), dtype=np.uint32)),
                        jnp.arange(na, na + nb, dtype=jnp.uint32))
        mk, mr = RP.merge_padded(ka, ra, kb, rb, cache=want)
        tk, tr = TP.merge_padded(*(to_carrier(np.asarray(a), "cpu") for a in (ka, ra, kb, rb)),
                                 cache=got)
        np.testing.assert_array_equal(to_u32(tk), np.asarray(mk))
        np.testing.assert_array_equal(to_u32(tr), np.asarray(mr))
        if step == 0:
            t0 = got.stats()["traces"]
        elif step < 3:
            assert got.stats()["traces"] == t0
    assert got.stats()["traces"] > t0
    assert got.stats() == want.stats()


def test_sort_drifting_n_in_one_bucket_zero_retrace_as_the_reference():
    """test_dynamic_count.py and test_bucket_boundaries.py: every n inside
    the 256 bucket (the bucket itself and n = 1 included) replays the
    sort traced at n = 200."""
    be, rbe = get_backend("torch", device="cpu"), r_get_backend("jnp")
    with TP.scoped_cache() as got, RP.scoped_cache() as want:
        for i, n in enumerate((200, 130, 255, 256, 64, 201, 1)):
            keys = _words(n, n, 2, 0xFFFFFFFF)
            sk, sr = be.sort(to_carrier(keys, "cpu"), TP.iota(n, "cpu"))
            rk, rr = rbe.sort(jnp.asarray(keys), jnp.arange(n, dtype=jnp.uint32))
            assert sk.shape[0] == n and sr.shape[0] == n
            np.testing.assert_array_equal(to_u32(sk), np.asarray(rk))
            np.testing.assert_array_equal(to_u32(sr), np.asarray(rr))
            if i == 0:
                traced = got.stats()["traces"]
        assert got.stats()["traces"] == traced == 1
        assert got.stats()["hits"] == 6
        assert _per_op(got.stats()) == _per_op(want.stats())


def test_pipeline_drifting_n_zero_retrace_as_the_reference():
    """test_dynamic_count.py and test_plancache.py: run() (sort, build
    levels, refresh) at n = 300, then 257, 400, 512 and 511 under one meta
    replays every program; the port's bitmap refresh stands where the
    reference's dpos refresh does."""
    words = _words(9, 512)
    rmeta, meta = _meta_pair(words)
    pipe, rpipe = ReconstructionPipeline(backend="torch", device="cpu"), RPipeline(backend="jnp")
    with TP.scoped_cache() as got, RP.scoped_cache() as want:
        for i, n in enumerate((300, 257, 400, 512, 511)):
            rks, ks = _keysets(100 + n, n)
            rks = RKeySet(words=words[:n], lengths=rks.lengths, rids=rks.rids)
            ks = keyset_from_numpy(words[:n], np.asarray(rks.lengths), np.asarray(rks.rids))
            res, rres = pipe.run(ks, meta=meta), rpipe.run(rks, meta=rmeta)
            np.testing.assert_array_equal(to_u32(res.rid_sorted), np.asarray(rres.rid_sorted))
            if i == 0:
                traced = got.stats()["traces"]
        assert got.stats()["traces"] == traced
        assert _per_op(got.stats(), {"refresh_dbitmap": "refresh_dpos"}) == \
            _per_op(want.stats())


def test_run_incremental_and_chunked_warm_zero_retrace():
    """test_plancache.py and test_chunked_sort.py: a repeated
    run_incremental and a warm chunked rebuild (chunk sorts, ladder
    merges, build levels, refresh) trace nothing new."""
    words = _words(11, 5000)
    rmeta, meta = _meta_pair(words)
    pipe = ReconstructionPipeline(backend="torch", device="cpu", chunk_threshold=2048,
                                  chunk_size=1024)
    rpipe = RPipeline(backend="jnp", chunk_threshold=2048, chunk_size=1024)
    lengths, rids = np.full(5000, 12, np.int32), np.arange(5000, dtype=np.uint32)
    with TP.scoped_cache() as got, RP.scoped_cache() as want:
        for n in (5000, 5000, 4993):
            ks = keyset_from_numpy(words[:n], lengths[:n], rids[:n])
            rks = RKeySet(words=words[:n], lengths=lengths[:n], rids=rids[:n])
            res, rres = pipe.run(ks, meta=meta), rpipe.run(rks, meta=rmeta)
            assert res.stats["chunked"] == rres.stats["chunked"] > 0
            np.testing.assert_array_equal(to_u32(res.comp_sorted), np.asarray(rres.comp_sorted))
            if n == 5000 and "traced" not in locals():
                traced = got.stats()["traces"]
        assert got.stats()["traces"] == traced
        assert _per_op(got.stats(), {"refresh_dbitmap": "refresh_dpos"}) == \
            _per_op(want.stats())
    base = keyset_from_numpy(words[:3000], lengths[:3000], rids[:3000])
    delta = keyset_from_numpy(words[3000:3150], lengths[3000:3150], rids[3000:3150])
    flat = ReconstructionPipeline(backend="torch", device="cpu")
    prev = flat.run(base, meta=meta)
    res, _ = flat.run_incremental(prev, base, delta, meta=meta)
    assert res.stats["incremental"] is True
    s0 = TP.cache_stats()
    res2, _ = flat.run_incremental(prev, base, delta, meta=meta)
    assert res2.stats["incremental"] is True
    assert TP.cache_stats()["traces"] == s0["traces"]


def _lookup_setup(seed, n=1000):
    rks, ks = _keysets(seed, n)
    rtree = RPipeline(backend="jnp").run(rks).tree
    return rks, rtree, _port_tree(rtree)


def test_lookup_steady_stream_zero_retrace_as_the_reference():
    """test_lookup.py: drifting same-bucket batches replay one program."""
    rks, rtree, tree = _lookup_setup(21)
    words = np.asarray(rks.words)
    be, rbe = get_backend("torch", device="cpu"), r_get_backend("jnp")
    with TP.scoped_cache() as got, RP.scoped_cache() as want:
        for q in (200, 130, 255, 64, 201):
            f, r = be.lookup(tree, to_carrier(words[:q], "cpu"))
            rf, rr = rbe.lookup(rtree, jnp.asarray(words[:q]))
            np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
            np.testing.assert_array_equal(to_u32(r), np.asarray(rr))
        assert got.stats() == want.stats()
        assert got.stats()["traces"] == 1 and got.stats()["hits"] == 4


def test_lookup_zero_retrace_across_snapshot_versions():
    """test_lookup.py: a same-sized rebuild (balanced churn folded by
    run_incremental) replays the cached lookup program."""
    rng = np.random.default_rng(23)
    rks, ks = _keysets(23, 1000)
    words = np.asarray(ks.words)
    keep = np.ones(ks.n, bool)
    keep[rng.choice(ks.n, size=30, replace=False)] = False
    dw = words[rng.integers(0, ks.n, size=30)]
    drids = np.arange(5000, 5030, dtype=np.uint32)
    delta = keyset_from_numpy(dw, np.full(30, 12, np.int32), drids)
    rdelta = RKeySet(words=dw, lengths=np.full(30, 12, np.int32), rids=drids)
    rmeta, meta = _meta_pair(np.concatenate([words, dw]))
    pipe, rpipe = ReconstructionPipeline(backend="torch", device="cpu"), RPipeline(backend="jnp")
    be, rbe = get_backend("torch", device="cpu"), r_get_backend("jnp")
    q = to_carrier(words[:100], "cpu")
    prev, rprev = pipe.run(ks, meta=meta), rpipe.run(rks, meta=rmeta)
    be.lookup(prev.tree, q)
    nxt, folded = pipe.run_incremental(prev, ks, delta, keep_rows=keep, meta=meta)
    rnxt, _ = rpipe.run_incremental(rprev, rks, rdelta, keep_rows=keep, meta=rmeta)
    assert folded.n == ks.n
    s0 = TP.cache_stats()
    f, r = be.lookup(nxt.tree, q)
    assert TP.cache_stats()["traces"] == s0["traces"]
    rf, rr = rbe.lookup(rnxt.tree, jnp.asarray(words[:100]))
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(r), np.asarray(rr))


def test_lookup_many_partial_arena_zero_retrace_as_the_reference():
    """test_multitenant.py: partial tenant rows (n_valid) and a warm
    replay attributed to ``lookup_many``."""
    sets = [_lookup_setup(30 + i, 320) for i in range(3)]
    rstack = RB.stack_trees([s[1] for s in sets])
    stacked = stack_trees([s[2] for s in sets])
    queries = np.stack([np.asarray(s[0].words)[::10][:32] for s in sets])
    n_valid = np.array([32, 7, 0], np.uint32)
    be, rbe = get_backend("torch", device="cpu"), r_get_backend("jnp")
    with TP.scoped_cache() as got, RP.scoped_cache() as want:
        for _ in range(2):
            f, r = be.lookup_many(stacked, to_carrier(queries, "cpu"), n_valid)
            rf, rr = rbe.lookup_many(rstack, jnp.asarray(queries), n_valid)
            np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
            np.testing.assert_array_equal(to_u32(r), np.asarray(rr))
        assert got.stats() == want.stats()
        assert got.stats()["traces"] == 1
        assert got.stats()["per_op"]["lookup_many"]["hits"] == 1
    assert not f[1, 7:].any() and not f[2].any()


def test_replica_query_stream_zero_retrace_across_polls():
    """test_snapshot.py: a same-bucket query stream interleaved with
    balanced-churn polls records zero new traces once warm."""
    from repro_torch.replication import ChangeLog, QueueTransport, StreamPrimary, StreamReplica

    _, base = _keysets(41, 600)
    t = QueueTransport()
    prim = StreamPrimary(t, base, backend="torch", device="cpu")
    rep = StreamReplica(t, backend="torch", device="cpu")
    rep.poll()
    queries = np.asarray(base.words)[::3]

    def churn():
        log = ChangeLog(3, start_lsn=prim.next_lsn)
        dead = np.asarray(prim.replica.keyset.rids)[:10]
        log.append_deletes(dead)
        log.append_inserts(np.asarray(prim.replica.keyset.words)[:10],
                           np.asarray(dead) + np.uint32(50000))
        prim.publish(log)
        rep.poll()

    churn()
    rep.search_batch(queries)
    churn()
    s0 = TP.cache_stats()
    for q in (len(queries), len(queries) - 7, len(queries) - 40):
        f, r = rep.search_batch(queries[:q])
        assert f.shape == (q,) and r.dtype == np.uint32
    churn()
    rep.search_batch(queries)
    assert TP.cache_stats()["traces"] == s0["traces"]


# ---------------------------------------------------------------------------
# the padded lookups at bucket edges, byte for byte
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edge_trees():
    """Two trees of one geometry; keys include the all-ones key."""
    out = []
    for seed in (51, 52):
        words = _words(seed, 700)
        words[350] = ONES
        rks = RKeySet(words=words, lengths=np.full(700, 12, np.int32),
                      rids=np.arange(700, dtype=np.uint32) + np.uint32(1000 * seed))
        rtree = RPipeline(backend="jnp").run(rks).tree
        out.append((words, rtree, _port_tree(rtree)))
    return out


def _edge_queries(words, q, seed):
    rng = np.random.default_rng(seed)
    out = words[rng.integers(0, words.shape[0], size=q)].copy()
    out[1::3, 0] ^= np.uint32(1)  # misses one bit off a key
    out[0] = ONES
    return out


@pytest.mark.parametrize("q", [255, 256, 257])
@pytest.mark.parametrize("backend", ["torch", "cuda", "distributed"])
def test_padded_lookups_equal_the_reference_at_bucket_edges(edge_trees, backend, q):
    words, rtree, tree = edge_trees[0]
    queries = _edge_queries(words, q, q)
    be = get_backend(backend, device="cpu")
    f, r = be.lookup(tree, to_carrier(queries, "cpu"))
    rf, rr = r_get_backend("jnp").lookup(rtree, jnp.asarray(queries))
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(r), np.asarray(rr))
    # "distributed" at one rank answers through its local backend's program
    program_backend = getattr(be, "local", be).name
    assert ("lookup", program_backend, TP.bucket_for("lookup", q), 3) in TP.get_cache().programs
    # lookup_many: two tenants of capacity 2, one ragged with dead lanes
    # and one whole; the dead lanes answer as the all-ones key does
    qs = np.stack([queries, _edge_queries(edge_trees[1][0], q, q + 1)])
    n_valid = np.array([q - 3, q], np.uint32)
    stacked = stack_trees([tree, edge_trees[1][2]])
    rstack = RB.stack_trees([rtree, edge_trees[1][1]])
    f, r = be.lookup_many(stacked, to_carrier(qs, "cpu"), n_valid)
    rf, rr = r_get_backend("jnp").lookup_many(rstack, jnp.asarray(qs), n_valid)
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(r), np.asarray(rr))
    assert f[0, q - 3:].all()  # dead lanes: the all-ones key is in the tree


# ---------------------------------------------------------------------------
# warm serving: the load harnesses and the soak
# ---------------------------------------------------------------------------


def test_run_load_and_multitenant_load_record_zero_warm_traces():
    from repro_torch.serve.loadgen import run_load, run_multitenant_load

    rep = run_load(backend="torch", device="cpu", n_keys=2048, n_words=2, batch=64,
                   n_readers=2, duration_s=0.3, mutation_batch=16, seed=1)
    assert rep.errors == [] and rep.torn_reads == 0 and rep.epochs_published >= 2
    assert rep.warm_traces == 0 and rep.to_row()["warm_traces"] == 0
    mt = run_multitenant_load(backend="torch", device="cpu", n_tenants=2, n_keys=256,
                              n_words=2, batch=32, n_readers=2, duration_s=0.3,
                              mutation_batch=16, seed=2)
    assert mt["errors"] == [] and mt["torn_reads"] == 0 and mt["epochs_published"] > 2
    assert mt["warm_traces"] == 0


def test_soak_steady_rounds_trace_nothing():
    from repro_torch.tools.chaos_soak import run_soak

    rep = run_soak(5, "queue", "torch", steps=6, n_replicas=2, device="cpu")
    assert rep["violations"] == [] and rep["steady_traces"] == 0
