"""The port's distributed backend against the JAX reference's, on the CPU.

``repro_torch.backends.distributed`` (the sample sort, owner-routed merge
and lookup, tenant- and batch-axis shards over a ``torch.distributed``
group) and ``repro_torch.core.distsort`` are held byte for byte against
``repro``:

* at p = 1 in this process, the counterparts of the reference's
  single-device cases (a 1,999-key run, non-ascending rows with massive
  ties, rows >= n, all-duplicate keys, the one-device sample sort);
* in one 4-rank gloo group (``repro_torch.tools.rankgroup``, started once
  for the module), the counterparts of the reference's 4-device cases:
  the pipeline's run and ``run_incremental``, the routed lookup,
  ``lookup_many`` over the tenant axis, ``run_many`` over the batch axis
  and the sample sorts of ``tests/test_system.py``; every rank's outputs
  equal every other rank's and the reference's jnp results, and the
  ``last_info`` routing counts equal the reference backend's on the same
  data;
* against one reference subprocess on a 4-device host mesh
  (``--xla_force_host_platform_device_count=4``, the reference's own
  pattern): the global ``DistSortResult`` arrays (splitters, buckets,
  capacity, sentinel rows, overflow) of a uniform input and of the skewed
  overflow input at capacity 0.5, and the backend's retries.

The rank code below imports neither ``jax`` nor ``repro`` (the spawned
ranks import this module); the reference runs in the test process.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.tools.rankgroup import RankError, run_group  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
P = 4


# ---------------------------------------------------------------------------
# inputs: numpy, from seeds, shared by the ranks, the reference and the tests
# ---------------------------------------------------------------------------

def _keyset_arrays(seed, n, w=3, mask=0x00FF0F0F):
    """Duplicate-heavy keys with shuffled rids (``tests/test_pipeline.py``)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)
    rids = np.arange(n, dtype=np.uint32)
    rng.shuffle(rids)
    return words, np.full(n, w * 4, np.int32), rids


def _skewed():
    """The reference's overflow input: nearly every key in one bucket."""
    rng = np.random.default_rng(0)
    n = 4 * 1024
    words = np.zeros((n, 2), dtype=np.uint32)
    words[: n - 8, 1] = 1
    words[n - 8:, 0] = rng.integers(1, 2**31, 8).astype(np.uint32)
    return words, np.arange(n, dtype=np.uint32)


def _tenant_arrays(seed, n=300, w=2):
    """``tests/test_multitenant.py``'s tenants: distinct two-word keys."""
    r = np.random.default_rng(seed)
    pool = r.integers(0, 2**32, size=(2 * n + 64, w), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    uniq = np.unique(pool, axis=0)
    words = uniq[r.permutation(uniq.shape[0])[:n]]
    rids = np.arange(1000 * seed, 1000 * seed + n, dtype=np.uint32)
    return words, np.full(n, w * 4, np.int32), rids


def _inputs() -> dict:
    base = _keyset_arrays(7, 4096)
    delta = _keyset_arrays(8, 300)
    delta = (delta[0], delta[1], np.arange(5000, 5300, dtype=np.uint32))
    keep = np.random.default_rng(9).random(4096) >= 0.05
    rng = np.random.default_rng(10)
    hits = base[0][rng.integers(0, 4096, size=40)]
    misses = base[0][rng.integers(0, 4096, size=20)] ^ np.uint32(1)
    queries = np.concatenate([hits, misses, np.full((3, 3), 0xFFFFFFFF, np.uint32)])
    tenants = [_tenant_arrays(s + 1) for s in range(8)]
    rng = np.random.default_rng(99)
    t_queries = np.stack([t[0][rng.integers(0, 300, size=32)] for t in tenants])
    t_queries[:, ::2] ^= np.uint32(0x10)  # misses outside the mask
    many = [_keyset_arrays(s, 600) for s in range(8)]
    random_words = np.random.default_rng(0).integers(0, 2**32, size=(8 * 512, 2),
                                                     dtype=np.uint32)
    return dict(uniform=(base[0], base[2]), skew=_skewed(),
                base=base, delta=delta, keep=keep, queries=queries, tenants=tenants,
                t_queries=t_queries, many=many, random_words=random_words)


def _zipf_comp():
    """``tests/test_system.py``'s Zipf reconstruction input, cut to a
    multiple of the group: (comp keys, rids) through the port's own
    generator, D-bitmap and extraction."""
    from repro_torch.configs.paper_index import ZipfConfig
    from repro_torch.core import compress as C
    from repro_torch.core import dbits as D
    from repro_torch.data.synthetic import zipf_keys

    ks = zipf_keys(ZipfConfig(1.5, 40, 0, n_keys=4096), seed=2)
    n = (ks.n // P) * P
    words = to_carrier(ks.words[:n], "cpu")
    plan = C.make_plan(to_u32(D.compute_dbitmap(words)), ks.n_words)
    return C.extract_bits(words, plan), torch.arange(n, dtype=torch.int64)


# ---------------------------------------------------------------------------
# the rank side: every 4-rank case in one group
# ---------------------------------------------------------------------------

def _rank_cases(rank, p, inp) -> dict:
    from repro_torch.core import plancache
    from repro_torch.core.btree import stack_trees
    from repro_torch.core.distsort import sample_sort
    from repro_torch.core.pipeline import ReconstructionPipeline

    def c(a):
        return to_carrier(a, "cpu")

    def dist_sort(words, rids, capacity):
        res = sample_sort(c(words) if isinstance(words, np.ndarray) else words,
                          c(rids) if isinstance(rids, np.ndarray) else rids,
                          capacity_factor=capacity)
        return {"keys": to_u32(res.keys), "rids": to_u32(res.rids),
                "valid": res.valid.numpy(), "overflow": res.overflow}

    out = {"uniform": dist_sort(*inp["uniform"], 1.5),
           "skew": dist_sort(*inp["skew"], 0.5)}
    be = get_backend("distributed", device="cpu", capacity_factor=0.5)
    sk, sr = be.sort(c(inp["skew"][0]), c(inp["skew"][1]))
    out["skew_sort"] = {"keys": to_u32(sk), "rows": to_u32(sr), "info": dict(be.last_info)}

    pipe = ReconstructionPipeline(backend="distributed", device="cpu",
                                  backend_opts={"capacity_factor": 2.0})
    base = keyset_from_numpy(*inp["base"])
    res = pipe.run(base)
    out["run"] = {"result": result_to_numpy(res),
                  "stats": {k: res.stats[k] for k in ("mesh_devices", "overflow",
                                                      "capacity_retries", "capacity_factor")}}
    inc, _ = pipe.run_incremental(res, base, keyset_from_numpy(*inp["delta"]),
                                  keep_rows=inp["keep"])
    out["incremental"] = {"result": result_to_numpy(inc), "info": dict(pipe.backend.last_info),
                          "incremental": inc.stats["incremental"]}
    found, rid = pipe.backend.lookup(res.tree, c(inp["queries"]))
    out["lookup"] = {"found": found.numpy(), "rid": to_u32(rid),
                     "info": dict(pipe.backend.last_info)}

    trees = [pipe.run(keyset_from_numpy(*t)).tree for t in inp["tenants"]]
    stacked = stack_trees(trees)
    dist = get_backend("distributed", device="cpu")
    found, rid = dist.lookup_many(stacked, c(inp["t_queries"]))
    traces = plancache.cache_stats()["traces"]
    again = dist.lookup_many(stacked, c(inp["t_queries"]))
    out["lookup_many"] = {
        "found": found.numpy(), "rid": to_u32(rid), "info": dict(dist.last_info),
        "again_equal": bool(torch.equal(again[0], found) and torch.equal(again[1], rid)),
        "warm_traces": plancache.cache_stats()["traces"] - traces}

    many = pipe.run_many([keyset_from_numpy(*m) for m in inp["many"]])
    out["run_many"] = {"results": [result_to_numpy(r) for r in many],
                       "batched": [r.stats.get("batched") for r in many],
                       "batch_per_shard": [r.stats.get("batch_per_shard") for r in many]}

    out["random"] = dist_sort(inp["random_words"],
                              np.arange(inp["random_words"].shape[0], dtype=np.uint32), 1.5)
    out["zipf"] = dist_sort(*_zipf_comp(), 4.0)
    return out


def _rank_fails(rank, p):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as tdist

    tdist.barrier()  # the other ranks wait in a collective that never completes


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs):
    """One 4-rank gloo group for the module: each rank's outputs."""
    return run_group(_rank_cases, P, inputs, timeout=60.0, deadline=300.0)


# ---------------------------------------------------------------------------
# the reference: a 4-device subprocess, and jnp in this process
# ---------------------------------------------------------------------------

_REF_4DEV = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.backends import get_backend
from repro.compat import make_mesh
from repro.core.distsort import sample_sort
from repro.core.keyformat import KeySet
from repro.core.pipeline import ReconstructionPipeline
d = np.load(sys.argv[1])
mesh = make_mesh((4,), ("data",))
out, info = {}, {}
for name, cap in (("uniform", 1.5), ("skew", 0.5)):
    res = sample_sort(jnp.asarray(d[name + "_words"]), jnp.asarray(d[name + "_rids"]),
                      mesh, "data", capacity_factor=cap)
    out[name + "_keys"] = np.asarray(res.keys)
    out[name + "_rids"] = np.asarray(res.rids)
    out[name + "_valid"] = np.asarray(res.valid)
    info[name + "_overflow"] = int(res.overflow)
be = get_backend("distributed", mesh=mesh, capacity_factor=0.5)
be.sort(jnp.asarray(d["skew_words"]), jnp.asarray(d["skew_rids"]))
info["skew_sort"] = {k: float(v) if isinstance(v, float) else v for k, v in be.last_info.items()}
ks = KeySet(words=d["base_words"], lengths=d["base_lengths"], rids=d["base_rids"])
res = ReconstructionPipeline(backend="distributed",
                             backend_opts={"mesh": mesh, "capacity_factor": 2.0}).run(ks)
info["run"] = {k: res.stats[k] for k in ("mesh_devices", "overflow", "capacity_retries",
                                         "capacity_factor")}
np.savez(sys.argv[2], **out)
print(json.dumps(info))
"""


@pytest.fixture(scope="module")
def ref4(inputs, tmp_path_factory):
    """The reference's 4-device mesh run, in a subprocess."""
    tmp = tmp_path_factory.mktemp("ref4")
    base = inputs["base"]
    np.savez(tmp / "in.npz", uniform_words=inputs["uniform"][0],
             uniform_rids=inputs["uniform"][1], skew_words=inputs["skew"][0],
             skew_rids=inputs["skew"][1], base_words=base[0], base_lengths=base[1],
             base_rids=base[2])
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_4DEV),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    arrays = dict(np.load(tmp / "out.npz"))
    return arrays, json.loads(r.stdout.strip().splitlines()[-1])


def _ref_keyset(arrays):
    from repro.core.keyformat import KeySet

    return KeySet(words=arrays[0], lengths=arrays[1], rids=arrays[2])


def _ref_tree_numpy(tree) -> dict:
    return {
        "levels": [{k: np.asarray(v) for k, v in level.items()} for level in tree.levels],
        "leaf": {k: np.asarray(v) for k, v in tree.leaf.items()},
        "sorted_full": np.asarray(tree.sorted_full),
        "sorted_rids": np.asarray(tree.sorted_rids),
        "n_keys": tree.n_keys,
    }


def _assert_equal_nested(got, want, where="") -> None:
    """Deep equality of dicts, lists and arrays (dtypes included)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_equal_nested(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_nested(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _assert_result_equals_reference(got: dict, ref) -> None:
    """A port result (``result_to_numpy``) against a reference result."""
    np.testing.assert_array_equal(got["comp_sorted"], np.asarray(ref.comp_sorted))
    np.testing.assert_array_equal(got["rid_sorted"], np.asarray(ref.rid_sorted))
    np.testing.assert_array_equal(got["row_sorted"], np.asarray(ref.row_sorted))
    want = _ref_tree_numpy(ref.tree)
    _assert_equal_nested(got["tree"], want, "tree")
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(got["meta"][field], getattr(ref.meta, field))


# ---------------------------------------------------------------------------
# p = 1, in this process
# ---------------------------------------------------------------------------


def test_p1_run_matches_reference_jnp():
    """The one-rank wrapper (shard pad, capacity buckets, valid-mask
    compaction) is an identity over the jnp order
    (``tests/test_pipeline.py:111-122``)."""
    from repro.core.pipeline import ReconstructionPipeline as RPipeline
    from repro_torch.core.pipeline import ReconstructionPipeline

    arrays = _keyset_arrays(3, 1999)  # divisible by nothing
    ref = RPipeline(backend="jnp").run(_ref_keyset(arrays))
    res = ReconstructionPipeline(backend="distributed", device="cpu").run(
        keyset_from_numpy(*arrays))
    _assert_result_equals_reference(result_to_numpy(res), ref)
    assert res.stats["overflow"] == 0 and res.stats["mesh_devices"] == 1


def test_p1_sort_contract_nonascending_rows():
    """Ties break on the row *value* for any distinct rows
    (``tests/test_pipeline.py:203-222``): against a numpy lexsort."""
    rng = np.random.default_rng(12)
    n = 1024
    keys = rng.integers(0, 4, size=(n, 2), dtype=np.uint32)  # massive ties
    rows = np.arange(n, dtype=np.uint32)
    rng.shuffle(rows)
    sk, sr = get_backend("distributed", device="cpu").sort(to_carrier(keys, "cpu"),
                                                           to_carrier(rows, "cpu"))
    got = np.concatenate([to_u32(sk), to_u32(sr)[:, None]], axis=1)
    order = np.lexsort(tuple(np.concatenate([keys, rows[:, None]], axis=1).T[::-1]))
    want = np.concatenate([keys[order], rows[order][:, None]], axis=1)
    np.testing.assert_array_equal(got, want)


def test_p1_rejects_out_of_range_rows():
    rng = np.random.default_rng(13)
    keys = to_carrier(rng.integers(0, 2**32, size=(17, 2), dtype=np.uint32), "cpu")
    rows = to_carrier(np.arange(100, 117, dtype=np.uint32), "cpu")  # >= n
    with pytest.raises(ValueError, match="row positions"):
        get_backend("distributed", device="cpu").sort(keys, rows)


def test_p1_all_duplicate_keys():
    """An empty D-bitmap carries through the build
    (``tests/test_pipeline.py:233-250``)."""
    from repro.core.keyformat import encode_int32, keys_to_words
    from repro.core.pipeline import ReconstructionPipeline as RPipeline
    from repro_torch.core.btree import search_batch
    from repro_torch.core.pipeline import ReconstructionPipeline

    rks = keys_to_words([encode_int32(7)] * 16)
    ref = RPipeline(backend="jnp").run(rks)
    res = ReconstructionPipeline(backend="distributed", device="cpu").run(
        keyset_from_numpy(rks.words, rks.lengths, rks.rids))
    assert res.stats["distinction_bits"] == 0
    found, _, _ = search_batch(res.tree, to_carrier(rks.words[:1], "cpu"))
    assert bool(found[0])
    _assert_result_equals_reference(result_to_numpy(res), ref)


def test_p1_sample_sort_equals_reference_one_device():
    """At p = 1 the global arrays (valid prefix, sentinel tail) equal the
    reference's one-device mesh run."""
    import jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.core.distsort import sample_sort as r_sample_sort
    from repro_torch.core.distsort import sample_sort

    words, _, rids = _keyset_arrays(14, 600)
    want = r_sample_sort(jnp.asarray(words), jnp.asarray(rids), make_mesh((1,), ("data",)),
                         "data", capacity_factor=1.5)
    got = sample_sort(to_carrier(words, "cpu"), to_carrier(rids, "cpu"), capacity_factor=1.5)
    np.testing.assert_array_equal(to_u32(got.keys), np.asarray(want.keys))
    np.testing.assert_array_equal(to_u32(got.rids), np.asarray(want.rids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.overflow == int(want.overflow) == 0


def test_backend_options_are_forwarded():
    from repro_torch.core.pipeline import ReconstructionPipeline

    be = get_backend("distributed", device="cpu", capacity_factor=3.0, max_capacity_retries=2)
    assert (be.capacity_factor, be.max_capacity_retries, be.p) == (3.0, 2, 1)
    assert be.local.name == "torch" and be.last_info == {"mesh_devices": 1}
    pipe = ReconstructionPipeline(backend="distributed", device="cpu",
                                  backend_opts={"capacity_factor": 2.0})
    assert pipe.backend.capacity_factor == 2.0


# ---------------------------------------------------------------------------
# the 4-rank group
# ---------------------------------------------------------------------------


def test_group_ranks_agree(ranks):
    """Every rank returns the whole result: all four ranks' outputs are
    equal, case by case."""
    assert len(ranks) == P
    for r in range(1, P):
        _assert_equal_nested(ranks[r], ranks[0], f"rank{r}")


@pytest.mark.parametrize("case", ["uniform", "skew"])
def test_sample_sort_equals_reference_global_arrays(ranks, ref4, case):
    """The global ``DistSortResult`` equals the reference's 4-device run
    byte for byte: the valid mask and sentinel rows place the splitters,
    buckets and capacity; the overflow count is reported alike."""
    arrays, info = ref4
    got = ranks[0][case]
    np.testing.assert_array_equal(got["keys"], arrays[case + "_keys"])
    np.testing.assert_array_equal(got["rids"], arrays[case + "_rids"])
    np.testing.assert_array_equal(got["valid"], arrays[case + "_valid"])
    assert got["overflow"] == info[case + "_overflow"]
    if case == "skew":
        assert got["overflow"] > 0  # reported, never dropped silently


def test_backend_retries_skewed_overflow(ranks, ref4, inputs):
    """Capacity 0.5 on the skewed input: the backend retries (as many
    times as the reference's) to an overflow-free run in the oracle
    order (``tests/test_pipeline.py:171-200``)."""
    _, info = ref4
    got = ranks[0]["skew_sort"]
    assert got["info"] == info["skew_sort"]
    assert got["info"]["overflow"] == 0 and got["info"]["capacity_retries"] >= 1
    words, rows = inputs["skew"]
    order = np.lexsort(tuple(np.concatenate([words, rows[:, None]], axis=1).T[::-1]))
    np.testing.assert_array_equal(got["keys"], words[order])
    np.testing.assert_array_equal(got["rows"], rows[order])


def test_group_run_matches_reference(ranks, ref4, inputs):
    """``run`` at p = 4, capacity 2.0 (``tests/test_pipeline.py:146-168``):
    the reference jnp result byte for byte, the reference's 4-device
    stats."""
    from repro.core.pipeline import ReconstructionPipeline as RPipeline

    ref = RPipeline(backend="jnp").run(_ref_keyset(inputs["base"]))
    _assert_result_equals_reference(ranks[0]["run"]["result"], ref)
    assert ranks[0]["run"]["stats"] == ref4[1]["run"]
    assert ranks[0]["run"]["stats"]["mesh_devices"] == P


def _ref_routed_backend(monkeypatch):
    """The reference's backend with its routing at p = 4 (its own lookup
    test's pattern): the routed paths run on the host, so the counts
    depend only on the data."""
    from repro.backends import get_backend as r_get_backend
    from repro.backends.distributed import DistributedBackend

    be = r_get_backend("distributed")
    monkeypatch.setattr(DistributedBackend, "n_devices", property(lambda self: P))
    return be


def test_group_run_incremental_routes_the_merge(ranks, inputs, monkeypatch):
    """``run_incremental`` takes the owner-routed merge: the reference jnp
    result byte for byte, and the reference backend's per-chunk delta
    counts on the same two runs."""
    import jax.numpy as jnp
    from repro.core import compress as RC
    from repro.core.pipeline import ReconstructionPipeline as RPipeline

    rpipe = RPipeline(backend="jnp")
    base = _ref_keyset(inputs["base"])
    prev = rpipe.run(base)
    ref, _ = rpipe.run_incremental(prev, base, _ref_keyset(inputs["delta"]),
                                   keep_rows=inputs["keep"])
    got = ranks[0]["incremental"]
    assert got["incremental"] is True
    _assert_result_equals_reference(got["result"], ref)
    # the two runs the pipeline merges, made by the reference
    keep = inputs["keep"]
    row_sorted = np.asarray(prev.row_sorted)
    kept = keep[row_sorted]
    new_row = np.cumsum(keep) - 1
    base_comp = np.asarray(prev.comp_sorted)[kept]
    base_rows = new_row[row_sorted][kept].astype(np.uint32)
    plan = RC.make_plan(prev.extract_bitmap, base.n_words)
    comp_d = RC.extract_bits(jnp.asarray(inputs["delta"][0]), plan)
    dk, dr = rpipe.sort(comp_d, jnp.arange(comp_d.shape[0], dtype=jnp.uint32))
    be = _ref_routed_backend(monkeypatch)
    be.merge_sorted(jnp.asarray(base_comp), jnp.asarray(base_rows), dk,
                    dr + jnp.uint32(int(kept.sum())))
    assert got["info"] == be.last_info
    assert sum(got["info"]["delta_routed"]) == inputs["delta"][0].shape[0]


def test_group_lookup_routes_by_owner(ranks, inputs, monkeypatch):
    """The routed lookup (``tests/test_lookup.py:98-116``): answers equal
    the reference's on the same tree, the routed counts the reference
    backend's, spread over at least two ranks."""
    import jax.numpy as jnp
    from repro.core.pipeline import ReconstructionPipeline as RPipeline

    tree = RPipeline(backend="jnp").run(_ref_keyset(inputs["base"])).tree
    q = inputs["queries"]
    be = _ref_routed_backend(monkeypatch)
    wf, wr = be.lookup(tree, jnp.asarray(q))
    got = ranks[0]["lookup"]
    np.testing.assert_array_equal(got["found"], np.asarray(wf))
    np.testing.assert_array_equal(got["rid"], np.asarray(wr))
    assert got["info"] == be.last_info
    routed = got["info"]["lookup_routed"]
    assert len(routed) == P and sum(routed) == q.shape[0]
    assert sum(1 for c in routed if c) >= 2


def test_group_lookup_many_shards_tenants(ranks, inputs):
    """8 tenants over 4 ranks, 2 per rank (``tests/test_multitenant.py:
    327-380``): each tenant's row equals the reference's single-tree
    lookup; a second call traces nothing."""
    import jax.numpy as jnp
    from repro.backends import get_backend as r_get_backend
    from repro.core.pipeline import ReconstructionPipeline as RPipeline

    rpipe, rbe = RPipeline(backend="jnp"), r_get_backend("jnp")
    got = ranks[0]["lookup_many"]
    assert got["info"] == {"mesh_devices": P, "tenants_per_shard": 2}
    for i, t in enumerate(inputs["tenants"]):
        tree = rpipe.run(_ref_keyset(t)).tree
        f1, r1 = rbe.lookup(tree, jnp.asarray(inputs["t_queries"][i]))
        np.testing.assert_array_equal(got["found"][i], np.asarray(f1))
        np.testing.assert_array_equal(got["rid"][i], np.asarray(r1))
    assert got["again_equal"] and got["warm_traces"] == 0


def test_group_run_many_shards_the_batch(ranks, inputs):
    """8 keysets of 600 over 4 ranks (``tests/test_chunked_sort.py:
    114-154``): each member equals the reference's jnp run."""
    from repro.core.pipeline import ReconstructionPipeline as RPipeline

    rpipe = RPipeline(backend="jnp")
    got = ranks[0]["run_many"]
    assert got["batched"] == [8] * 8 and got["batch_per_shard"] == [2] * 8
    for res, arrays in zip(got["results"], inputs["many"]):
        _assert_result_equals_reference(res, rpipe.run(_ref_keyset(arrays)))


@pytest.mark.parametrize("case", ["random", "zipf"])
def test_group_sample_sort_orders(ranks, inputs, case):
    """``tests/test_system.py:258-300`` at 4 ranks: random full-width
    words, and the Zipf reconstruction's compressed keys at capacity 4.0;
    no overflow, the valid rows in the reference's sorted order."""
    import jax.numpy as jnp
    from repro.core import dbits as RD

    got = ranks[0][case]
    assert got["overflow"] == 0
    if case == "random":
        words = inputs["random_words"]
        rids = np.arange(words.shape[0], dtype=np.uint32)
    else:
        comp, rids_t = _zipf_comp()
        words, rids = to_u32(comp), to_u32(rids_t)
    want_k, want_r = RD.sort_words_keyed(jnp.asarray(words), jnp.asarray(rids))
    np.testing.assert_array_equal(got["keys"][got["valid"]], np.asarray(want_k))
    np.testing.assert_array_equal(got["rids"][got["valid"]], np.asarray(want_r))
    if case == "zipf":  # the port's generator and extraction are the reference's
        from repro.configs.paper_index import ZipfConfig as RZipf
        from repro.core import compress as RC
        from repro.data.synthetic import zipf_keys as r_zipf_keys

        ks = r_zipf_keys(RZipf(1.5, 40, 0, n_keys=4096), seed=2)
        w = jnp.asarray(ks.words[: words.shape[0]])
        plan = RC.make_plan(np.asarray(RD.compute_dbitmap(w)), ks.n_words)
        np.testing.assert_array_equal(words, np.asarray(RC.extract_bits(w, plan)))


def test_rank_failure_raises_with_its_traceback():
    """A rank that raises fails the group in the parent with that rank's
    traceback; the rank waiting in a collective is stopped, not waited
    for."""
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_group(_rank_fails, 2, timeout=30.0, deadline=120.0)
