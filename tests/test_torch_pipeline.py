"""The port's slice end to end against the JAX reference pipeline.

``ReconstructionPipeline.run`` on the port's ``"torch"`` backend and on its
``"cuda"`` backend (on ``device="cpu"`` every kernel wrapper takes its
plain version) must give the reference ``jnp`` pipeline's ``comp_sorted``,
``rid_sorted``, ``row_sorted``, every tree array and the refreshed meta,
byte for byte; one small case also runs the reference ``pallas`` pipeline
(interpret mode).  Lookups must agree on a tree built by either package,
carried across with ``repro_torch.convert``.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.configs.paper_index import ZipfConfig as RZipf  # noqa: E402
from repro.core.btree import BTree as RBTree  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.data.synthetic import zipf_keys as r_zipf_keys  # noqa: E402
from repro_torch.backends import available_backends, get_backend  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    keyset_from_numpy,
    meta_from_numpy,
    result_to_numpy,
    tree_from_numpy,
    tree_to_numpy,
)
from repro_torch.core.btree import NOT_FOUND_RID, search_batch  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline, fold_keyset  # noqa: E402
from repro_torch.core.reconstruct import full_key_reconstruct, reconstruct_index  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402

PORT_BACKENDS = ("torch", "cuda")


def _words(case: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, case)))
    kind, n, w = case.split("_")
    n, w = int(n), int(w)
    if kind == "dup":  # duplicate-heavy
        return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    if kind == "identical":  # empty D-bitmap
        return np.tile(rng.integers(0, 2**32, size=(1, w), dtype=np.uint32), (n, 1))
    if kind == "ones":
        return np.full((n, w), 0xFFFFFFFF, np.uint32)
    if kind == "wide":
        return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(0x01010101)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)


# shapes repeat on purpose (n in one bucket, same W): the reference compiles
# once per shape, so each further case costs little
CASES = ["dup_255_3", "dup_257_3", "identical_300_3", "ones_257_3", "rand_1023_16",
         "wide_200_128"]


def _keysets(words: np.ndarray, seed: int = 0):
    n = words.shape[0]
    rids = np.random.default_rng(seed).permutation(n).astype(np.uint32)
    lengths = np.full(n, words.shape[1] * 4, np.int32)
    return (RKeySet(words=words, lengths=lengths, rids=rids),
            keyset_from_numpy(words, lengths, rids))


@lru_cache(maxsize=None)
def _reference(case: str, full_keys: bool = False):
    """The reference ``jnp`` pipeline's result on ``case`` (seed-0 rids),
    run once and shared by the tests that compare with it."""
    rks, _ = _keysets(_words(case))
    return RPipeline(backend="jnp").run(rks, full_keys=full_keys)


def _tree_numpy(tree) -> dict:
    """Every array of a reference ``BTree`` as numpy."""
    return {
        "levels": [{k: np.asarray(v) for k, v in level.items()} for level in tree.levels],
        "leaf": {k: np.asarray(v) for k, v in tree.leaf.items()},
        "sorted_full": np.asarray(tree.sorted_full),
        "sorted_rids": np.asarray(tree.sorted_rids),
        "n_keys": tree.n_keys,
    }


def _assert_trees_equal(got: dict, want: dict):
    assert got["n_keys"] == want["n_keys"]
    assert len(got["levels"]) == len(want["levels"])
    for lg, lw in zip(got["levels"], want["levels"]):
        assert lg.keys() == lw.keys()
        for k in lw:
            assert lg[k].dtype == lw[k].dtype, k
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
    assert got["leaf"].keys() == want["leaf"].keys()
    for k in want["leaf"]:
        assert got["leaf"][k].dtype == want["leaf"][k].dtype, k
        np.testing.assert_array_equal(got["leaf"][k], want["leaf"][k], err_msg=k)
    np.testing.assert_array_equal(got["sorted_full"], want["sorted_full"])
    np.testing.assert_array_equal(got["sorted_rids"], want["sorted_rids"])


def _assert_results_equal(res, ref):
    got = result_to_numpy(res)
    np.testing.assert_array_equal(got["comp_sorted"], np.asarray(ref.comp_sorted))
    np.testing.assert_array_equal(got["rid_sorted"], np.asarray(ref.rid_sorted))
    np.testing.assert_array_equal(got["row_sorted"], np.asarray(ref.row_sorted))
    _assert_trees_equal(got["tree"], _tree_numpy(ref.tree))
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(got["meta"][field], getattr(ref.meta, field))
    np.testing.assert_array_equal(res.extract_bitmap, ref.extract_bitmap)


def _queries(words: np.ndarray, seed: int) -> np.ndarray:
    """Hits, one-bit misses and all-ones keys in one batch."""
    rng = np.random.default_rng(seed)
    n, w = words.shape
    return np.concatenate([
        words[rng.integers(0, n, size=40)],
        words[rng.integers(0, n, size=20)] ^ np.uint32(1),
        np.full((3, w), 0xFFFFFFFF, np.uint32),
    ])


# ---------------------------------------------------------------------------
# the slice: run() parity with the reference jnp pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_matches_reference_jnp(case, backend):
    _, tks = _keysets(_words(case))
    ref = _reference(case)
    res = ReconstructionPipeline(backend=backend, device="cpu").run(tks)
    _assert_results_equal(res, ref)
    assert res.stats["backend"] == backend
    for key in ("n_keys", "distinction_bits", "comp_sort_key_words", "tree_height",
                "tree_bytes"):
        assert res.stats[key] == ref.stats[key], key


@pytest.mark.parametrize("case", ["dup_257_3", "ones_257_3", "rand_1023_16", "wide_200_128"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_full_key_run_matches_reference_jnp(case, backend):
    _, tks = _keysets(_words(case))
    ref = _reference(case, full_keys=True)
    res = ReconstructionPipeline(backend=backend, device="cpu").run(tks, full_keys=True)
    _assert_results_equal(res, ref)


@pytest.mark.parametrize("case", ["dup_257_3"])
def test_cuda_backend_matches_reference_pallas(case):
    """The reference's kernel pipeline (interpret mode) on the same input:
    the cuda backend's counterpart, byte for byte, lookups included."""
    words = _words(case)
    rks, tks = _keysets(words, seed=2)
    r_pallas = r_get_backend("pallas", interpret=True)
    ref = RPipeline(backend=r_pallas).run(rks)
    res = ReconstructionPipeline(backend="cuda", device="cpu").run(tks)
    _assert_results_equal(res, ref)
    q = _queries(words, 3)
    rf, rr = r_pallas.lookup(ref.tree, jnp.asarray(q))
    found, rid = get_backend("cuda", device="cpu").lookup(res.tree, to_carrier(q, "cpu"))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(rid), np.asarray(rr))


def test_zipf_slice_end_to_end():
    """The slice's configuration at a CPU size: Zipf(1.5, 64, 0) keys, rows
    shuffled, rids = row index; hits return their rid, misses (byte 63 set
    to 'A', which the generator never emits) return NOT_FOUND_RID."""
    ks = r_zipf_keys(RZipf(1.5, 64, 0, 1000), seed=0)
    rng = np.random.default_rng(0)
    words = ks.words[rng.permutation(ks.n)]
    rids = np.arange(ks.n, dtype=np.uint32)
    rks = RKeySet(words=words, lengths=ks.lengths, rids=rids)
    ref = RPipeline(backend="jnp").run(rks)
    res = ReconstructionPipeline(backend="cuda", device="cpu",
                                 chunk_threshold=1 << 24).run(keyset_from_numpy(
                                     words, ks.lengths, rids))
    _assert_results_equal(res, ref)
    hit_rows = rng.integers(0, ks.n, size=64)
    misses = words[rng.integers(0, ks.n, size=64)].copy()
    misses[:, -1] = (misses[:, -1] & np.uint32(0xFFFFFF00)) | np.uint32(ord("A"))
    q = np.concatenate([words[hit_rows], misses])
    found, rid = get_backend("cuda", device="cpu").lookup(res.tree, to_carrier(q, "cpu"))
    expect = np.concatenate([hit_rows, np.full(64, NOT_FOUND_RID)]).astype(np.uint32)
    np.testing.assert_array_equal(to_u32(rid), expect)
    np.testing.assert_array_equal(found.numpy(), expect != NOT_FOUND_RID)


def test_reconstruct_wrappers_match_reference():
    from repro.core.reconstruct import full_key_reconstruct as r_full
    from repro.core.reconstruct import reconstruct_index as r_index

    rks, tks = _keysets(_words("dup_257_3"), seed=4)
    _assert_results_equal(reconstruct_index(tks, device="cpu"), r_index(rks))
    _assert_results_equal(full_key_reconstruct(tks, device="cpu"), r_full(rks))


def test_run_with_given_meta_matches_reference():
    words = _words("dup_257_3")
    rks, tks = _keysets(words, seed=5)
    ref_meta_src = RPipeline(backend="jnp").run(rks).meta
    meta = meta_from_numpy(ref_meta_src.dbitmap, ref_meta_src.varbitmap,
                           ref_meta_src.refkey, ref_meta_src.n_words)
    ref = RPipeline(backend="jnp").run(rks, meta=ref_meta_src)
    res = ReconstructionPipeline(backend="cuda", device="cpu").run(tks, meta=meta)
    _assert_results_equal(res, ref)


# ---------------------------------------------------------------------------
# lookup parity on trees built by either package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dup_257_3", "ones_257_3", "rand_1023_16"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_port_lookup_on_reference_tree(case, backend):
    words = _words(case)
    ref = _reference(case)
    q = _queries(words, 7)
    rf, rr = r_get_backend("jnp").lookup(ref.tree, jnp.asarray(q))
    t = _tree_numpy(ref.tree)
    tree = tree_from_numpy(t["levels"], t["leaf"], t["sorted_full"], t["sorted_rids"],
                           t["n_keys"], ref.tree.config, device="cpu")
    _assert_trees_equal(tree_to_numpy(tree), t)
    found, rid = get_backend(backend, device="cpu").lookup(tree, to_carrier(q, "cpu"))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(rid), np.asarray(rr))
    # search_batch agrees on the hits
    sf, srid, _ = search_batch(tree, to_carrier(q, "cpu"))
    np.testing.assert_array_equal(sf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(srid)[sf.numpy()], np.asarray(rr)[np.asarray(rf)])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_reference_lookup_on_port_tree(backend):
    words = _words("dup_300_3")
    _, tks = _keysets(words, seed=8)
    res = ReconstructionPipeline(backend=backend, device="cpu").run(tks)
    t = tree_to_numpy(res.tree)
    rtree = RBTree(
        levels=tuple({k: jnp.asarray(v) for k, v in lv.items()} for lv in t["levels"]),
        leaf={k: jnp.asarray(v) for k, v in t["leaf"].items()},
        sorted_full=jnp.asarray(t["sorted_full"]),
        sorted_rids=jnp.asarray(t["sorted_rids"]),
        n_keys=t["n_keys"],
        config=type(RPipeline().config)(res.tree.config.pk_bits, res.tree.config.fill_factor),
    )
    q = _queries(words, 9)
    rf, rr = r_get_backend("jnp").lookup(rtree, jnp.asarray(q))
    found, rid = get_backend(backend, device="cpu").lookup(res.tree, to_carrier(q, "cpu"))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(to_u32(rid), np.asarray(rr))


# ---------------------------------------------------------------------------
# what this slice does not do raises instead of running something else
# ---------------------------------------------------------------------------


def test_registry_lists_both_backends():
    assert {"torch", "cuda"} <= set(available_backends())
    with pytest.raises(KeyError):
        get_backend("no-such-backend", device="cpu")


def test_run_above_chunk_threshold_takes_chunked_path():
    rks, tks = _keysets(_words("dup_300_3"))
    ref = RPipeline(backend="jnp", chunk_threshold=256, chunk_size=128).run(rks)
    res = ReconstructionPipeline(backend="cuda", device="cpu", chunk_threshold=256,
                                 chunk_size=128).run(tks)
    _assert_results_equal(res, ref)
    assert res.stats["chunked"] == ref.stats["chunked"] == 3
    assert res.stats["cascade_merges"] == ref.stats["cascade_merges"] == 2


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_merge_sorted_backend_op_matches_reference(backend):
    """Two sorted halves of a sorted run with disjoint rows merge back into
    the reference backend's merge, byte for byte."""
    ref = _reference("dup_255_3")
    keys, rows = np.asarray(ref.comp_sorted), np.asarray(ref.row_sorted)
    odd = rows % 2 == 1
    runs = [(keys[odd], rows[odd]), (keys[~odd], rows[~odd])]
    wk, wr = r_get_backend("jnp").merge_sorted(*(jnp.asarray(a) for run in runs for a in run))
    gk, gr = get_backend(backend, device="cpu").merge_sorted(
        *(to_carrier(a, "cpu") for run in runs for a in run))
    np.testing.assert_array_equal(to_u32(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_u32(gr), np.asarray(wr))
    np.testing.assert_array_equal(to_u32(gk), keys)


@pytest.mark.parametrize("op", ["fused_extract_sort", "batched_extract_sort"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_later_slice_backend_ops_raise(op, backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(get_backend(backend, device="cpu"), op)()


def test_run_incremental_runs_and_matches_reference():
    """Deletes and a delta folded into a previous run equal the
    reference's ``run_incremental``, which equals its full run."""
    from repro.core.metadata import meta_from_keys as r_meta_from_keys

    words = _words("dup_300_3")
    rks, tks = _keysets(words[:255], seed=6)
    drks, dtks = _keysets(words[255:], seed=7)
    rmeta = r_meta_from_keys(words)
    meta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    keep = np.random.default_rng(1).random(255) < 0.8
    rpipe = RPipeline(backend="jnp")
    ref, _ = rpipe.run_incremental(rpipe.run(rks, meta=rmeta), rks, drks,
                                   keep_rows=keep, meta=rmeta)
    pipe = ReconstructionPipeline(backend="torch", device="cpu")
    res, _ = pipe.run_incremental(pipe.run(tks, meta=meta), tks, dtks, keep_rows=keep,
                                  meta=meta)
    assert res.stats["incremental"] is True
    _assert_results_equal(res, ref)


@pytest.mark.parametrize("method", ["run_many"])
def test_later_slice_pipeline_methods_raise(method):
    pipe = ReconstructionPipeline(backend="torch", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(pipe, method)()


def test_fold_keyset_matches_reference():
    from repro.core.pipeline import fold_keyset as r_fold

    rks, tks = _keysets(_words("dup_100_3"))
    drks, dtks = _keysets(_words("rand_10_3"), seed=3)
    keep = np.random.default_rng(0).random(100) < 0.7
    got, want = fold_keyset(tks, keep, dtks), r_fold(rks, keep, drks)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_cpu_run_launches_no_kernel():
    _, tks = _keysets(_words("dup_300_3"))
    cudalib.reset_launches()
    res = ReconstructionPipeline(backend="cuda", device="cpu").run(tks)
    get_backend("cuda", device="cpu").lookup(res.tree, to_carrier(_queries(_words(
        "dup_300_3"), 1), "cpu"))
    assert all(v == 0 for v in cudalib.LAUNCHES.values())
