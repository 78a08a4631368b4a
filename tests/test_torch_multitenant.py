"""The port's multi-tenant serving against the JAX reference: stacked
trees, the fused ``lookup_many``, the tenant-major probe, the tenant
registry, the fused engine, SLO admission and the load harness.

Every input is made with numpy from a seed and fed to both packages; the
answers are integers and must be equal byte for byte (dead lanes
included).  Trees are built once by the reference ``jnp`` pipeline and
carried to the port with ``repro_torch.convert``, which
``tests/test_torch_pipeline.py`` holds equal to the port's own builds.
The reference's probe kernel runs in Pallas interpret mode; the port's
``"cuda"`` backend runs on ``device="cpu"``, where the probe wrapper takes
its plain version (``tests/test_torch_cuda.py`` holds the kernel against
it on a GPU).
"""

import threading
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.core.btree import stack_trees as r_stack_trees  # noqa: E402
from repro.core.btree import tree_geometry as r_tree_geometry  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.core.snapshot import IndexSnapshot as RIndexSnapshot  # noqa: E402
from repro.core.snapshot import SnapshotCell as RSnapshotCell  # noqa: E402
from repro.kernels.lookup.kernel import probe_planes_many  # noqa: E402
from repro.serve import loadgen as r_loadgen  # noqa: E402
from repro.serve import tenants as r_tenants  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    keyset_from_numpy,
    stacked_tree_from_numpy,
    stacked_tree_to_numpy,
    tree_from_numpy,
)
from repro_torch.core.btree import NOT_FOUND_RID, stack_trees, tree_geometry  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.snapshot import AdmissionShed, IndexSnapshot, SnapshotCell  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels.build import pk_windows_plain  # noqa: E402
from repro_torch.kernels.lookup import probe_many_plain, probe_plain  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    MultiTenantEngine,
    SLOAdmissionController,
    SLOConfig,
    TenantRegistry,
)
from repro_torch.serve.loadgen import (  # noqa: E402
    LatencyReservoir,
    pooled_percentiles,
    run_multitenant_load,
)

PORT_BACKENDS = ("torch", "cuda")
ONES = np.uint32(0xFFFFFFFF)


def _words(seed: int, n: int, with_ones: bool = False) -> np.ndarray:
    """Exactly ``n`` unique 2-word keys masked with 0x00FF0F0F (bit 0x10
    of each word is outside the mask, so flipping it makes a miss);
    ``with_ones`` swaps one key for the all-ones key."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(2 * n + 64, 2), dtype=np.uint32)
    pool &= np.uint32(0x00FF0F0F)
    uniq = np.unique(pool, axis=0)
    words = uniq[rng.permutation(uniq.shape[0])[:n]]
    if with_ones:
        words[n // 2] = ONES
    return words


@lru_cache(maxsize=None)
def _tenant(seed: int, n: int, with_ones: bool = False):
    """(words, rids, reference tree, the same tree carried to the port)."""
    words = _words(seed, n, with_ones)
    rids = np.arange(10_000 * seed, 10_000 * seed + n, dtype=np.uint32)
    ks = RKeySet(words=words, lengths=np.full(n, 8, np.int32), rids=rids)
    rtree = RPipeline(backend="jnp").run(ks).tree
    return words, rids, rtree, _to_port(rtree)


def _to_port(rtree):
    return tree_from_numpy(
        [{k: np.asarray(v) for k, v in lv.items()} for lv in rtree.levels],
        {k: np.asarray(v) for k, v in rtree.leaf.items()},
        np.asarray(rtree.sorted_full), np.asarray(rtree.sorted_rids), rtree.n_keys,
        rtree.config, device="cpu")


def _queries(words: np.ndarray, seed: int, q: int) -> np.ndarray:
    """Half hits, half misses, one all-ones query."""
    rng = np.random.default_rng(seed)
    qs = words[rng.integers(0, words.shape[0], size=q)].copy()
    qs[::2] ^= np.uint32(0x10)
    qs[-1] = ONES
    return qs


def _reference_many(backend: str, rtrees, queries, n_valid=None):
    be = r_get_backend(backend, **({"interpret": True} if backend == "pallas" else {}))
    found, rid = be.lookup_many(r_stack_trees(rtrees), jnp.asarray(queries), n_valid)
    return np.asarray(found), np.asarray(rid)


def _port_many(backend: str, trees, queries, n_valid=None):
    found, rid = get_backend(backend, device="cpu").lookup_many(
        stack_trees(trees), to_carrier(queries, "cpu"), n_valid)
    return found.numpy(), to_u32(rid)


def _assert_answers(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# stacked trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [511, 512, 513])
def test_tree_geometry_matches_reference(n):
    _, _, rtree, tree = _tenant(1, n)
    assert tree_geometry(tree) == r_tree_geometry(rtree)
    assert tree_geometry(_tenant(2, n)[3]) == tree_geometry(tree)


def test_tree_geometry_mismatch_refuses_to_stack():
    a, b = _tenant(1, 511)[3], _tenant(1, 513)[3]
    assert tree_geometry(a) != tree_geometry(b)
    with pytest.raises(ValueError, match="geometry"):
        stack_trees([a, b])
    with pytest.raises(ValueError, match="capacity"):
        stack_trees([a, a, a], capacity=2)
    with pytest.raises(ValueError):
        stack_trees([])


@pytest.mark.parametrize("n", [511, 512, 513])
def test_stack_trees_matches_reference(n):
    """Three trees stack to capacity 4; every slot, the pad slot that
    replicates tree 0 included, equals the reference's stack."""
    tenants = [_tenant(s, n) for s in (1, 2, 3)]
    stacked = stack_trees([t[3] for t in tenants])
    rstacked = r_stack_trees([t[2] for t in tenants])
    assert int(stacked.sorted_full.shape[0]) == 4
    members = stacked_tree_to_numpy(stacked)
    assert len(members) == 4
    for slot, m in enumerate(members):
        for lv, rlv in zip(m["levels"], rstacked.levels):
            for k in rlv:
                np.testing.assert_array_equal(lv[k], np.asarray(rlv[k][slot]), err_msg=k)
                assert lv[k].dtype == np.asarray(rlv[k]).dtype, k
        for k in rstacked.leaf:
            np.testing.assert_array_equal(m["leaf"][k], np.asarray(rstacked.leaf[k][slot]))
        np.testing.assert_array_equal(m["sorted_full"], np.asarray(rstacked.sorted_full[slot]))
        np.testing.assert_array_equal(m["sorted_rids"], np.asarray(rstacked.sorted_rids[slot]))
    # and back: the numpy members restack into the same arena
    again = stacked_tree_to_numpy(stacked_tree_from_numpy(members, stacked.config, "cpu"))
    np.testing.assert_array_equal(again[3]["sorted_full"], members[0]["sorted_full"])


# ---------------------------------------------------------------------------
# lookup_many against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [511, 512, 513])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_lookup_many_matches_reference(backend, n):
    """Two tenants at 2^k±1 keys: equal to the reference's jnp
    ``lookup_many`` and, per tenant, to the port's single-tree lookup."""
    tenants = [_tenant(s, n) for s in (1, 2)]
    queries = np.stack([_queries(t[0], s, 48) for s, t in enumerate(tenants)])
    got = _port_many(backend, [t[3] for t in tenants], queries)
    _assert_answers(got, _reference_many("jnp", [t[2] for t in tenants], queries))
    be = get_backend(backend, device="cpu")
    for i, t in enumerate(tenants):
        f1, r1 = be.lookup(t[3], to_carrier(queries[i], "cpu"))
        np.testing.assert_array_equal(got[0][i], f1.numpy())
        np.testing.assert_array_equal(got[1][i], to_u32(r1))
    assert got[0].any() and not got[0].all()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_lookup_many_t1_matches_reference(backend):
    """T = 1 is the single-snapshot path."""
    words, _, rtree, tree = _tenant(4, 512)
    queries = _queries(words, 4, 64)[None]
    got = _port_many(backend, [tree], queries)
    assert got[0].shape == (1, 64) and got[1].shape == (1, 64)
    _assert_answers(got, _reference_many("jnp", [rtree], queries))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_lookup_many_partial_arena_dead_lanes_match_reference(backend):
    """Three tenants in capacity 4 with ragged ``n_valid``: dead lanes are
    all-ones queries, so the tenant whose tree holds the all-ones key
    answers them found, the others NOT_FOUND_RID — as in the reference."""
    tenants = [_tenant(5, 512), _tenant(6, 512, with_ones=True), _tenant(7, 512)]
    queries = np.stack([_queries(t[0], 10 + s, 32) for s, t in enumerate(tenants)])
    n_valid = np.array([7, 5, 0], np.uint32)
    got = _port_many(backend, [t[3] for t in tenants], queries, n_valid)
    _assert_answers(got, _reference_many("jnp", [t[2] for t in tenants], queries, n_valid))
    found, rid = got
    ones_rid = tenants[1][1][np.flatnonzero((tenants[1][0] == ONES).all(1))[0]]
    assert found[1, 5:].all() and (rid[1, 5:] == ones_rid).all()
    assert not found[0, 7:].any() and (rid[0, 7:] == NOT_FOUND_RID).all()
    assert not found[2].any()


def test_cuda_lookup_many_matches_reference_pallas():
    """The reference's kernel path (tenant-major probe, interpret mode) on
    a partial arena with dead lanes."""
    tenants = [_tenant(5, 512), _tenant(6, 512, with_ones=True), _tenant(7, 512)]
    queries = np.stack([_queries(t[0], 20 + s, 32) for s, t in enumerate(tenants)])
    n_valid = np.array([32, 9, 1], np.uint32)
    _assert_answers(_port_many("cuda", [t[3] for t in tenants], queries, n_valid),
                    _reference_many("pallas", [t[2] for t in tenants], queries, n_valid))


def test_lookup_many_rejects_bad_shapes():
    words, _, _, tree = _tenant(4, 512)
    be = get_backend("torch", device="cpu")
    stacked = stack_trees([tree])
    q = to_carrier(_queries(words, 1, 8), "cpu")
    with pytest.raises(ValueError, match="T, q, W"):
        be.lookup_many(stacked, q)
    with pytest.raises(ValueError, match="capacity"):
        be.lookup_many(stacked, torch.stack([q, q]))
    with pytest.raises(ValueError, match="n_valid"):
        be.lookup_many(stacked, q[None], [1, 2])


# ---------------------------------------------------------------------------
# the tenant-major probe's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pk", [1, 16, 32])
def test_probe_many_plain_matches_reference_kernel_and_probe(pk):
    """Random stacked leaves with windows on word boundaries and in the
    last word: equal to the reference's tenant-major kernel (interpret)
    on the same pairs, and each tenant row to the single-tree probe."""
    rng = np.random.default_rng(pk)
    t_cap, t, q, w, n_leaves, lc = 4, 3, 37, 2, 9, 12
    queries = rng.integers(0, 2**32, size=(t, q, w), dtype=np.uint32)
    dpos = rng.integers(-2, 32 * w, size=(t_cap, n_leaves, lc))
    dpos[:, :3] = 31  # start on the word boundary
    dpos[:, 3:5] = 32 * w - 2  # start in the last bit
    node = rng.integers(0, n_leaves, size=(t, q))
    leaf_pk = rng.integers(0, 1 << pk, size=(t_cap, n_leaves, lc)).astype(np.uint32)
    tenant = np.arange(t)[:, None]
    for ti in range(t):  # every third query's leaf stores its windows
        for i in range(0, q, 3):
            starts = torch.as_tensor(dpos[ti, node[ti, i]] + 1)
            words = to_carrier(np.repeat(queries[ti, i][None], lc, axis=0), "cpu")
            leaf_pk[ti, node[ti, i]] = to_u32(pk_windows_plain(words, starts, pk))
    got = probe_many_plain(to_carrier(queries, "cpu"), torch.as_tensor(node),
                           torch.as_tensor(dpos), to_carrier(leaf_pk, "cpu"), pk).numpy()
    pair_q = np.repeat(queries, lc, axis=1)  # (t, q*lc, w)
    want = np.asarray(probe_planes_many(
        jnp.asarray(np.pad(np.swapaxes(pair_q, 1, 2), ((0, 0), (0, 0), (0, 512 - q * lc)))),
        jnp.asarray(np.pad((dpos[tenant, node] + 1).reshape(t, -1), ((0, 0), (0, 512 - q * lc)))),
        jnp.asarray(np.pad(leaf_pk[tenant, node].reshape(t, -1), ((0, 0), (0, 512 - q * lc)))),
        pk, tile=128, interpret=True))[:, : q * lc].astype(bool).reshape(t, q, lc)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    for ti in range(t):
        one = probe_plain(to_carrier(queries[ti], "cpu"), torch.as_tensor(node[ti]),
                          torch.as_tensor(dpos[ti]), to_carrier(leaf_pk[ti], "cpu"), pk)
        np.testing.assert_array_equal(got[ti], one.numpy())


# ---------------------------------------------------------------------------
# registry: geometry buckets, migration, epoch pins — in lockstep with the
# reference registry on the same trees
# ---------------------------------------------------------------------------


def _snaps(tenant, epoch=0):
    """The same tree frozen as a reference and as a port snapshot."""
    _, _, rtree, tree = tenant
    rsnap = RIndexSnapshot(epoch=epoch, tree=rtree, meta=None, comp_sorted=None,
                           rid_sorted=None, row_sorted=None, extract_bitmap=None,
                           watermark=None)
    snap = IndexSnapshot(epoch=epoch, tree=tree, meta=None, comp_sorted=None,
                         rid_sorted=None, row_sorted=None, extract_bitmap=None,
                         watermark=None)
    return rsnap, snap


def _arena_state(reg, tenant):
    a = reg.arena_of(tenant)
    return None if a is None else (a.tenants, a.slots, a.epochs, a.capacity)


def test_registry_migration_matches_reference():
    rreg, reg = r_tenants.TenantRegistry(), TenantRegistry()
    a, b, a2 = _tenant(1, 512), _tenant(2, 512), _tenant(3, 513)

    def publish(name, tenant, epoch=0):
        rsnap, snap = _snaps(tenant, epoch)
        rreg.publish(name, rsnap)
        reg.publish(name, snap)

    publish("a", a)
    publish("b", b)
    assert reg.arena_of("a") is reg.arena_of("b") and reg.arena_of("a").capacity == 2
    publish("a", a2, epoch=1)  # 'a' rebuilds at another size: migrates
    st = reg.stats()
    assert st == rreg.stats()
    assert st["n_migrations"] == 1 and st["n_arenas"] == 2
    assert reg.arena_of("b").tenants == ("b",)
    for name, tenant in (("a", a2), ("b", b)):
        assert _arena_state(reg, name) == _arena_state(rreg, name)
        arena, rarena = reg.arena_of(name), rreg.arena_of(name)
        slot = arena.slots[name]
        qb = np.full((arena.capacity, 16, 2), ONES, np.uint32)
        qb[slot] = tenant[0][:16]
        nv = np.zeros(arena.capacity, np.uint32)
        nv[slot] = 16
        found, rid = get_backend("cuda", device="cpu").lookup_many(
            arena.stacked, to_carrier(qb, "cpu"), nv)
        rf, rr = r_get_backend("jnp").lookup_many(rarena.stacked, jnp.asarray(qb), nv)
        np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
        np.testing.assert_array_equal(to_u32(rid), np.asarray(rr))
        np.testing.assert_array_equal(to_u32(rid)[slot], tenant[1][:16])
    reg.retire("a")
    rreg.retire("a")
    assert reg.arena_of("a") is None and reg.stats() == rreg.stats()
    with pytest.raises(KeyError):
        reg.retire("a")


def test_registry_publish_pins_cell_epoch():
    """Publishing from a SnapshotCell leases the epoch until republish;
    the cell counters move as the reference's do."""
    cells = {"port": SnapshotCell(), "ref": RSnapshotCell()}
    regs = {"port": TenantRegistry(), "ref": r_tenants.TenantRegistry()}
    pipes = {"port": ReconstructionPipeline(backend="torch", device="cpu"),
             "ref": RPipeline(backend="jnp")}

    def run(seed):
        words = _words(seed, 512)
        rids = np.arange(512, dtype=np.uint32)
        pipes["ref"].run(RKeySet(words=words, lengths=np.full(512, 8, np.int32), rids=rids),
                         publish_to=cells["ref"])
        pipes["port"].run(keyset_from_numpy(words, np.full(512, 8, np.int32), rids),
                          publish_to=cells["port"])

    run(1)
    for side in cells:
        regs[side].publish("t", cells[side])
    run(2)
    for side in cells:  # epoch 0 retired by the publish, pinned by the registry
        assert cells[side].stats()["retired"] == 1
        regs[side].publish("t", cells[side])  # re-pin at epoch 1 releases epoch 0
        assert cells[side].stats()["retired"] == 0
        assert regs[side].arena_of("t").epochs["t"] == 1
        regs[side].retire("t")
    stats = {side: cells[side].stats() for side in cells}
    assert stats["port"]["pinned"] == 0
    for st in stats.values():
        st.pop("park_wait_s")
    assert stats["port"] == stats["ref"]


# ---------------------------------------------------------------------------
# engine: fused dispatch, tenant leaving mid-batch
# ---------------------------------------------------------------------------


def _fleet(n_tenants):
    reg = TenantRegistry()
    fleet = {t: _tenant(t + 1, 512) for t in range(n_tenants)}
    for t, tenant in fleet.items():
        reg.publish(t, _snaps(tenant)[1])
    return reg, fleet


def _submit_all(eng, asks):
    """Submit each (tenant, queries) from its own thread; return the
    results and errors once the engine holds them all pending."""
    out, err = {}, {}

    def ask(t, qs):
        try:
            out[t] = eng.submit(t, qs)
        except AdmissionShed as e:
            err[t] = e

    threads = [threading.Thread(target=ask, args=a) for a in asks]
    for th in threads:
        th.start()
    while eng.stats()["pending"] < len(asks):
        pass
    return threads, out, err


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_engine_fuses_cross_tenant_batch(backend):
    reg, fleet = _fleet(3)
    be = get_backend(backend, device="cpu")
    eng = MultiTenantEngine(reg, be, auto_dispatch=False)
    asks = [(t, _queries(tenant[0], t, 24)) for t, tenant in fleet.items()]
    threads, out, _ = _submit_all(eng, asks)
    assert eng.flush() == 3
    for th in threads:
        th.join(timeout=10.0)
    st = eng.stats()
    assert st["n_dispatches"] == 1 and st["n_batches"] == 1  # ONE lookup_many
    assert st["served_per_tenant"] == {0: 1, 1: 1, 2: 1}
    for t, qs in asks:
        found, rid, epoch = out[t]
        f1, r1 = be.lookup(fleet[t][3], to_carrier(qs, "cpu"))
        np.testing.assert_array_equal(found, f1.numpy())
        np.testing.assert_array_equal(rid, to_u32(r1))
        assert epoch == 0 and found.any() and not found.all()
    eng.shutdown()


def test_tenant_leaving_mid_batch():
    """Retire between enqueue and flush: only the leaver's request sheds."""
    reg, fleet = _fleet(2)
    eng = MultiTenantEngine(reg, get_backend("cuda", device="cpu"), auto_dispatch=False)
    threads, out, err = _submit_all(eng, [(t, fleet[t][0][:16]) for t in (0, 1)])
    reg.retire(1)
    eng.flush()
    for th in threads:
        th.join(timeout=10.0)
    assert 1 in err and "retired" in str(err[1])
    found, rid, _ = out[0]
    assert found.all()
    np.testing.assert_array_equal(rid, fleet[0][1][:16])
    eng.shutdown()


# ---------------------------------------------------------------------------
# SLO admission and pooled percentiles, against the reference's
# ---------------------------------------------------------------------------


def _slo_pair(**cfg):
    return (SLOAdmissionController(SLOConfig(**cfg)),
            r_tenants.SLOAdmissionController(r_tenants.SLOConfig(**cfg)))


def test_slo_windowed_aimd_matches_reference():
    ctl, rctl = _slo_pair(target_p99_us=1000.0, window=8, fairness_limit=4)
    for c in (ctl, rctl):
        for _ in range(8):
            c.observe("t", 5000.0)  # one overshooting window
    assert ctl.stats()["t"]["shed_frac"] == pytest.approx(0.15)
    for c in (ctl, rctl):
        for _ in range(16):
            c.observe("t", 100.0)  # two clear windows -> multiplicative decay
    assert ctl.stats()["t"]["shed_frac"] == pytest.approx(0.15 * 0.7 * 0.7)
    for c in (ctl, rctl):
        for _ in range(20 * 8):
            c.observe("t", 100.0)
    assert ctl.stats()["t"]["shed_frac"] < 0.01
    assert ctl.stats() == rctl.stats()


def test_slo_sheds_but_never_starves_like_reference():
    ctl, rctl = _slo_pair(target_p99_us=1.0, window=4, fairness_limit=3)
    for c in (ctl, rctl):
        for _ in range(4 * 10):
            c.observe("t", 1e6)
    assert ctl.stats()["t"]["shed_frac"] == pytest.approx(0.9)
    verdicts = [ctl.admit("t") for _ in range(200)]
    assert verdicts == [rctl.admit("t") for _ in range(200)]
    st = ctl.stats()["t"]
    assert st["n_shed"] > 0 and st["forced_admits"] > 0
    assert sum(verdicts) >= 200 // (3 + 1)  # never starves
    gap = worst = 0
    for v in verdicts:
        gap = 0 if v else gap + 1
        worst = max(worst, gap)
    assert worst <= 3
    assert ctl.stats() == rctl.stats()


def test_pooled_percentiles_weight_by_stream_length():
    """A slow 8-request thread must not drag the pooled p99 of a
    10000-request fleet to its own tail; seeded reservoirs pool exactly
    as the reference's do."""
    pools = []
    for cls in (LatencyReservoir, r_loadgen.LatencyReservoir):
        fast, slow = cls(capacity=64, seed=0), cls(capacity=64, seed=1)
        for _ in range(10_000):
            fast.record(1.0)
        for _ in range(8):
            slow.record(100.0)
        mixed = cls(capacity=32, seed=2)
        for v in np.random.default_rng(3).exponential(50.0, size=500):
            mixed.record(float(v))
        pools.append([fast, slow, mixed])
    pooled = pooled_percentiles(pools[0][:2])
    assert pooled["p99_us"] == pytest.approx(1.0)
    assert pooled["p50_us"] == pytest.approx(1.0)
    assert pooled_percentiles(pools[0]) == r_loadgen.pooled_percentiles(pools[1])
    assert pooled_percentiles([]) == r_loadgen.pooled_percentiles([])


# ---------------------------------------------------------------------------
# the closed-loop load harness, short
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slo", [False, True])
def test_multitenant_load_smoke(slo):
    rep = run_multitenant_load(
        backend="cuda", device="cpu", n_tenants=2, n_keys=256, n_words=2, batch=32,
        n_readers=2, duration_s=0.3, mutation_batch=16, seed=3,
        target_p99_us=1.0 if slo else None, slo_window=4)
    assert rep["torn_reads"] == 0 and rep["stale_epochs"] == 0
    assert rep["errors"] == []
    assert rep["n_requests"] > 0 and set(rep["served_per_tenant"]) == {0, 1}
    assert rep["epochs_published"] > 2 and "warm_traces" not in rep
    if slo:
        assert rep["slo"] is not None and set(rep["slo"]) == {0, 1}
