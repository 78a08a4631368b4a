"""The port's merge path against the JAX reference: the rank and merge
primitives, the bucketed merge, the chunked sort's ladder, the
incremental delta merge, the dbit pass of the refresh and the chunk tuner.

Every input is made with numpy from a seed and fed to both packages; the
outputs are integers and must be equal byte for byte.  The reference's
merge-rank and dbit kernels run in Pallas interpret mode, as
``tests/test_kernels.py`` runs them.  The port's ``"cuda"`` backend runs
here on ``device="cpu"``, where every kernel wrapper takes its plain
version; ``tests/test_torch_cuda.py`` holds the kernels against those
plain versions on a GPU.
"""

import bisect
from collections import Counter
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dbits as RD  # noqa: E402
from repro.core import plancache as RP  # noqa: E402
from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.metadata import meta_from_keys as r_meta_from_keys  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.kernels.dbit import ops as r_dbit  # noqa: E402
from repro.kernels.merge import ops as r_merge  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, meta_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core import dbits as TD  # noqa: E402
from repro_torch.core import plancache as TP  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.reconstruct import reconstruct_index  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels import merge as t_merge  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits, adjacent_dbits_plain  # noqa: E402
from repro_torch.kernels.dbit.ref import adjacent_dbits_ref  # noqa: E402
from repro_torch.kernels.merge.ref import merge_ranks_ref  # noqa: E402

PORT_BACKENDS = ("torch", "cuda", "distributed")


def _t(a):
    return to_carrier(np.asarray(a), "cpu")


def _sorted_run(rng, n, w, mask, row_base=0):
    """An ascending (key, row) run of ``n`` keys with distinct rows."""
    keys = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)
    rows = (row_base + rng.permutation(n)).astype(np.uint32)
    order = np.lexsort((rows,) + tuple(keys[:, i] for i in range(w - 1, -1, -1)))
    return keys[order], rows[order]


def _run_pair(case: str):
    """(searched run, query run) of one merge case, numpy uint32."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "dup":  # ties fall to the row word
        return _sorted_run(rng, 300, 3, 0x3, 0), _sorted_run(rng, 257, 3, 0x3, 300)
    if case == "ones":  # all-ones keys against pad rows of both ranges
        ks = np.full((200, 2), 0xFFFFFFFF, np.uint32)
        rs = np.concatenate([np.arange(100), RP.ROW_PAD_A + np.arange(100)]).astype(np.uint32)
        kq = np.full((130, 2), 0xFFFFFFFF, np.uint32)
        rq = np.concatenate([np.arange(100, 150), RP.ROW_PAD_B + np.arange(80)]).astype(np.uint32)
        return (ks, rs), (kq, rq)
    if case == "ns1":
        return _sorted_run(rng, 1, 3, 0xFF, 0), _sorted_run(rng, 257, 3, 0xFF, 1)
    if case == "pow2m1":
        return _sorted_run(rng, 255, 3, 0x0F0F, 0), _sorted_run(rng, 300, 3, 0x0F0F, 255)
    if case == "pow2p1":
        return _sorted_run(rng, 257, 3, 0x0F0F, 0), _sorted_run(rng, 100, 3, 0x0F0F, 257)
    if case == "wide":
        return _sorted_run(rng, 129, 128, 0x1, 0), _sorted_run(rng, 64, 128, 0x1, 129)
    if case == "sparse":  # windows past the staging budget: 300 queries in 8193 rows
        return _sorted_run(rng, 8193, 3, 0x0F0F0F0F, 0), _sorted_run(rng, 300, 3, 0x0F0F0F0F, 8193)
    if case == "unsorted":  # a query run out of order
        (ks, rs), (kq, rq) = _sorted_run(rng, 257, 3, 0x0F0F, 0), _sorted_run(rng, 600, 3, 0x0F0F, 257)
        order = rng.permutation(len(kq))
        order[512:] = np.sort(order[512:])  # an ascending last tile beside unsorted ones
        return (ks, rs), (kq[order], rq[order])
    if case == "empty_s":
        return _sorted_run(rng, 0, 3, 0xFF, 0), _sorted_run(rng, 50, 3, 0xFF, 0)
    if case == "empty_q":
        return _sorted_run(rng, 50, 3, 0xFF, 0), _sorted_run(rng, 0, 3, 0xFF, 50)
    raise KeyError(case)


MERGE_CASES = ["dup", "ones", "ns1", "pow2m1", "pow2p1", "wide", "empty_s", "empty_q"]


# ---------------------------------------------------------------------------
# rank and merge primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", MERGE_CASES)
def test_ranks_match_reference(case):
    (ks, rs), (kq, rq) = _run_pair(case)
    want = np.asarray(RD.rank_in_sorted_keyed(jnp.asarray(ks), jnp.asarray(rs),
                                              jnp.asarray(kq), jnp.asarray(rq)))
    got = TD.rank_in_sorted_keyed(_t(ks), _t(rs), _t(kq), _t(rq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_merge.merge_ranks_plain(_t(kq), _t(rq), _t(ks), _t(rs))
                                  .numpy(), want)
    np.testing.assert_array_equal(merge_ranks_ref(kq, rq, ks, rs), want)


@pytest.mark.parametrize("case", ["dup", "pow2p1"])
def test_merge_ranks_plain_matches_reference_kernel(case):
    """The reference's merge-rank kernel, in interpret mode, at n <= 1024."""
    (ks, rs), (kq, rq) = _run_pair(case)
    want = np.asarray(r_merge.merge_ranks(jnp.asarray(kq), jnp.asarray(rq),
                                          jnp.asarray(ks), jnp.asarray(rs),
                                          tile=128, interpret=True))
    got = t_merge.merge_ranks(_t(kq), _t(rq), _t(ks), _t(rs))
    np.testing.assert_array_equal(got.numpy(), want)


def _tiled_ranks_model(kq, rq, ks, rs, tile, cap, samples, slack, lanes):
    """A numpy model of ``csrc/merge_rank.cu``: the (lanes + 1)-way search
    of each tile's first query (and of the last query) to within ``slack``
    rows, the ascending check over
    the tile and the next tile's first query, the dense staged window, the
    splitter sample of a larger window with its few probes, and the
    per-query search of a tile that does not ascend.  Returns the ranks and
    how many tiles took each path."""
    n_q, n_s = len(kq), len(ks)
    q = [tuple(map(int, k)) + (int(r),) for k, r in zip(kq, rq)]
    s = [tuple(map(int, k)) + (int(r),) for k, r in zip(ks, rs)]
    out = np.zeros(n_q, np.int32)
    paths = Counter()
    if n_q == 0 or n_s == 0:
        return out, paths

    def bound(x):  # a group of lanes probes, a ballot counts those below
        lo, hi = 0, n_s
        while hi - lo > slack:
            p = [lo + (lane + 1) * (hi - lo) // (lanes + 1) for lane in range(lanes)]
            below = [s[i] < x for i in p]
            c = sum(below)
            assert below == [True] * c + [False] * (lanes - c)
            if c > 0:
                lo = p[c - 1] + 1
            if c < lanes:
                hi = p[c]
        assert lo <= bisect.bisect_left(s, x) <= hi
        return lo, hi

    def search(x, lo, hi):  # a binary search in device memory: (rank, probes)
        probes = 0
        while lo < hi:
            mid = (lo + hi) // 2
            probes += 1
            lo, hi = (mid + 1, hi) if s[mid] < x else (lo, mid)
        return lo, probes

    n_tiles = -(-n_q // tile)
    bounds = [bound(q[min(t * tile, n_q - 1)]) for t in range(n_tiles + 1)]
    for t in range(n_tiles):
        q0 = t * tile
        tq = min(tile, n_q - q0)
        staged = q[q0:q0 + tq + 1]  # and the next tile's first, if any
        if any(b < a for a, b in zip(staged, staged[1:])):
            paths["unsorted"] += 1
            for i in range(tq):
                out[q0 + i] = search(q[q0 + i], 0, n_s)[0]
            continue
        lo, hi = bounds[t][0], max(bounds[t + 1][1], bounds[t][0])
        if hi - lo <= cap:
            paths["dense"] += 1
            window = s[lo:hi]
            for i in range(tq):
                out[q0 + i] = lo + bisect.bisect_left(window, q[q0 + i])
            continue
        paths["sparse"] += 1
        stride = -(-(hi - lo) // samples)
        sample = s[lo:hi:stride]
        assert len(sample) <= samples
        for i in range(tq):
            a = bisect.bisect_left(sample, q[q0 + i])
            rank = lo
            if a > 0:
                rank, probes = search(q[q0 + i], lo + (a - 1) * stride + 1,
                                      min(lo + a * stride, hi))
                assert probes <= max(1, (stride - 1).bit_length())
            out[q0 + i] = rank
    return out, paths


#: (queries per tile, window rows staged, sample rows of a larger window,
#: rows a bound's range keeps, lanes per bound): the kernel's own (its
#: staging buffer at the key's width), and a tiny one under which every
#: case crosses tiles and most windows are sparse
_MODEL_CONFIGS = {"kernel": (256, None, 256, 32, 16), "tiny": (8, 4, 2, 1, 2)}
_MODEL_CASES = ["dup", "ones", "ns1", "pow2m1", "pow2p1", "wide", "sparse", "unsorted"]


@lru_cache(maxsize=None)
def _reference_ranks(case: str) -> np.ndarray:
    """The reference merge-rank kernel's ranks (interpret mode), equal to
    the numpy oracle's."""
    (ks, rs), (kq, rq) = _run_pair(case)
    want = np.asarray(r_merge.merge_ranks(jnp.asarray(kq), jnp.asarray(rq), jnp.asarray(ks),
                                          jnp.asarray(rs), tile=128, interpret=True))
    np.testing.assert_array_equal(merge_ranks_ref(kq, rq, ks, rs), want)
    return want


@pytest.mark.parametrize("config", sorted(_MODEL_CONFIGS))
@pytest.mark.parametrize("case", _MODEL_CASES)
def test_tiled_rank_model_matches_reference_kernel(case, config):
    """The tiled design's numpy model against the reference kernel: dense
    and sparse windows, windows past the staging budget, unsorted queries,
    ties that fall to the row, n_s = 1 and 2^k +- 1, pad rows >= 2^31; the
    port's plain version too."""
    (ks, rs), (kq, rq) = _run_pair(case)
    tile, cap, samples, slack, lanes = _MODEL_CONFIGS[config]
    if cap is None:  # a 16 KiB buffer for the tile (KW <= 8 words and the row,
        kw = min(ks.shape[1], 8)  # rounded to 16 bytes) and the window (KW words a row)
        cap = (16 * 1024 - -(-(tile + 1) * (kw + 1) // 4) * 16) // (4 * kw)
        samples = min(samples, cap)
    got, paths = _tiled_ranks_model(kq, rq, ks, rs, tile, cap, samples, slack, lanes)
    want = _reference_ranks(case)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_merge.merge_ranks_plain(_t(kq), _t(rq), _t(ks), _t(rs)).numpy(), want)
    if case == "unsorted":
        assert paths["unsorted"] > 0 and paths["dense"] + paths["sparse"] > 0
    if case == "sparse" or config == "tiny" and case in ("dup", "pow2m1", "pow2p1"):
        assert paths["sparse"] > 0
    if config == "kernel" and case in ("dup", "pow2m1", "pow2p1", "wide", "ones") or \
            case == "ns1":
        assert paths == {"dense": len(kq) // tile + (len(kq) % tile > 0)}


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_words_keyed_matches_reference(case):
    (ka, ra), (kb, rb) = _run_pair(case)
    wk, wr = RD.merge_words_keyed(jnp.asarray(ka), jnp.asarray(ra),
                                  jnp.asarray(kb), jnp.asarray(rb))
    for fn in (TD.merge_words_keyed, t_merge.merge_sorted):
        gk, gr = fn(_t(ka), _t(ra), _t(kb), _t(rb))
        np.testing.assert_array_equal(to_u32(gk), np.asarray(wk))
        np.testing.assert_array_equal(to_u32(gr), np.asarray(wr))


@pytest.mark.parametrize("case", ["dup", "ns1", "pow2m1", "empty_q"])
@pytest.mark.parametrize("counted", [False, True])
def test_merge_padded_matches_reference(case, counted):
    """Whole ``keep_padded`` outputs, tail included, and the sliced merge;
    ``counted`` hands bucket-shaped runs whose pad lanes hold garbage."""
    (ka, ra), (kb, rb) = _run_pair(case)
    kw = {}
    if counted:
        rng = np.random.default_rng(1)
        na, nb = len(ka), len(kb)
        ba, bb = RP.bucket_for("merge", na), RP.bucket_for("merge", nb)
        ka = np.concatenate([ka, rng.integers(0, 2**32, (ba - na, ka.shape[1]), np.uint32)])
        ra = np.concatenate([ra, rng.integers(0, 2**32, ba - na, np.uint32)])
        kb = np.concatenate([kb, rng.integers(0, 2**32, (bb - nb, kb.shape[1]), np.uint32)])
        rb = np.concatenate([rb, rng.integers(0, 2**32, bb - nb, np.uint32)])
        kw = {"n_valid_a": na, "n_valid_b": nb}
    for keep_padded in (True, False):
        wk, wr = RP.merge_padded(jnp.asarray(ka), jnp.asarray(ra), jnp.asarray(kb),
                                 jnp.asarray(rb), keep_padded=keep_padded, **kw)
        # the reference's distributed merge re-pads its merged run with
        # pad_run, so its tail is held against that backend's own
        dk, dr = r_get_backend("distributed").merge_sorted(
            jnp.asarray(ka), jnp.asarray(ra), jnp.asarray(kb), jnp.asarray(rb),
            keep_padded=keep_padded, **kw)
        for backend in PORT_BACKENDS:
            gk, gr = get_backend(backend, device="cpu").merge_sorted(
                _t(ka), _t(ra), _t(kb), _t(rb), keep_padded=keep_padded, **kw)
            if backend == "distributed":
                wk, wr = dk, dr
            np.testing.assert_array_equal(to_u32(gk), np.asarray(wk), err_msg=backend)
            np.testing.assert_array_equal(to_u32(gr), np.asarray(wr), err_msg=backend)


def test_pad_run_matches_reference():
    (ka, ra), _ = _run_pair("pow2m1")
    for base in (RP.ROW_PAD_A, RP.ROW_PAD_B):
        wk, wr = RP.pad_run(jnp.asarray(ka), jnp.asarray(ra), 512, base)
        gk, gr = TP.pad_run(_t(ka), _t(ra), 512, int(base))
        np.testing.assert_array_equal(to_u32(gk), np.asarray(wk))
        np.testing.assert_array_equal(to_u32(gr), np.asarray(wr))


# ---------------------------------------------------------------------------
# the chunked sort's ladder
# ---------------------------------------------------------------------------


def _keyset_pair(n, w=3, mask=0x0FFF00FF, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)
    rids = rng.permutation(n).astype(np.uint32)
    lengths = np.full(n, w * 4, np.int32)
    return (RKeySet(words=words, lengths=lengths, rids=rids),
            keyset_from_numpy(words, lengths, rids))


def _tree_numpy(tree) -> dict:
    return {
        "levels": [{k: np.asarray(v) for k, v in lv.items()} for lv in tree.levels],
        "leaf": {k: np.asarray(v) for k, v in tree.leaf.items()},
        "sorted_full": np.asarray(tree.sorted_full),
        "sorted_rids": np.asarray(tree.sorted_rids),
        "n_keys": tree.n_keys,
    }


def _assert_same(got: dict, want: dict, where=""):
    """Every array of two results (as numpy dicts) equal."""
    for k in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}{k}")
    gt, wt = got["tree"], want["tree"]
    assert gt["n_keys"] == wt["n_keys"]
    assert len(gt["levels"]) == len(wt["levels"])
    for i, (lg, lw) in enumerate(zip(gt["levels"], wt["levels"])):
        assert lg.keys() == lw.keys()
        for k in lw:
            np.testing.assert_array_equal(lg[k], lw[k], err_msg=f"{where}level{i}.{k}")
    for k in wt["leaf"]:
        np.testing.assert_array_equal(gt["leaf"][k], wt["leaf"][k], err_msg=f"{where}leaf.{k}")
    for k in ("sorted_full", "sorted_rids"):
        np.testing.assert_array_equal(gt[k], wt[k], err_msg=f"{where}{k}")
    for k in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(got["meta"][k], want["meta"][k], err_msg=f"{where}meta.{k}")


def _ref_numpy(res) -> dict:
    return {
        "comp_sorted": np.asarray(res.comp_sorted),
        "rid_sorted": np.asarray(res.rid_sorted),
        "row_sorted": np.asarray(res.row_sorted),
        "tree": _tree_numpy(res.tree),
        "meta": {k: np.asarray(getattr(res.meta, k)) for k in ("dbitmap", "varbitmap", "refkey")},
    }


_CHUNK = {"chunk_threshold": 1024, "chunk_size": 256}
CASCADE_STATS = ("chunked", "cascade_merges", "cascade_peak_live_runs")


@lru_cache(maxsize=None)
def _ref_chunked(n: int, full_keys: bool):
    rks, _ = _keyset_pair(n)
    return RPipeline(backend="jnp", **_CHUNK).run(rks, full_keys=full_keys)


@pytest.mark.parametrize("n,full_keys", [(1025, False), (1500, False), (1500, True)])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_chunked_run_matches_reference(backend, n, full_keys):
    """n = 1025 leaves a last chunk of one row, 1500 a ragged one; the
    cascade stats and every output equal the reference's chunked run."""
    _, tks = _keyset_pair(n)
    ref = _ref_chunked(n, full_keys)
    res = ReconstructionPipeline(backend=backend, device="cpu", **_CHUNK).run(
        tks, full_keys=full_keys)
    _assert_same(result_to_numpy(res), _ref_numpy(ref))
    assert res.stats["chunked"] == -(-n // 256)
    for key in CASCADE_STATS:
        assert res.stats[key] == ref.stats[key], key
    assert res.stats["cascade_merges"] == res.stats["chunked"] - 1


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_chunked_ragged_run_equals_monolithic(backend):
    _, tks = _keyset_pair(1500)
    mono = ReconstructionPipeline(backend=backend, device="cpu").run(tks)
    chunked = ReconstructionPipeline(backend=backend, device="cpu", **_CHUNK).run(tks)
    assert mono.stats["chunked"] == 0 and chunked.stats["chunked"] == 6
    _assert_same(result_to_numpy(chunked), result_to_numpy(mono))


@pytest.mark.parametrize("flags", [{"async_dispatch": True}, {"stage_timings": False},
                                   {"async_dispatch": True, "stage_timings": True}])
def test_chunked_run_flags_keep_outputs(flags):
    """async_dispatch and stage_timings move sync points only."""
    _, tks = _keyset_pair(1500)
    flags = dict(flags)
    stage_timings = flags.pop("stage_timings", None)
    pipe = ReconstructionPipeline(backend="cuda", device="cpu", **_CHUNK, **flags)
    res = pipe.run(tks, stage_timings=stage_timings)
    _assert_same(result_to_numpy(res), _ref_numpy(_ref_chunked(1500, False)))
    sync = stage_timings if stage_timings is not None else not pipe.async_dispatch
    assert res.stats["async_dispatch"] == (not sync)
    assert "sync" in res.timings


def test_default_threshold_takes_the_chunked_path_above_2_19():
    """``ReconstructionPipeline()`` and ``reconstruct_index()`` with the
    default threshold (2**19) and chunk size (2**17) rebuild 2**19 + 1
    keys: five chunks, the last of one row."""
    n = (1 << 19) + 1
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(n, 1), dtype=np.uint32)
    ks = keyset_from_numpy(words, np.full(n, 4, np.int32), np.arange(n, dtype=np.uint32))
    res = reconstruct_index(ks, device="cpu")
    assert res.stats["chunked"] == 5 and res.stats["cascade_merges"] == 4
    want = np.lexsort((np.arange(n), words[:, 0]))
    np.testing.assert_array_equal(res.row_sorted.numpy(), want)
    assert ReconstructionPipeline(device="cpu").chunk_threshold == 1 << 19


def test_chunk_size_must_be_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        ReconstructionPipeline(device="cpu", chunk_size=1000)


# ---------------------------------------------------------------------------
# run_incremental
# ---------------------------------------------------------------------------


def _incremental_case(kind: str):
    """(base, delta or None, keep mask or None, union meta) as reference
    and port objects; the union meta covers the delta's keys."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    n, nd, w = 300, 40, 3
    words = rng.integers(0, 2**32, size=(n + nd, w), dtype=np.uint32) & np.uint32(0x00FF0F0F)
    rids = rng.permutation(n + nd).astype(np.uint32)
    lengths = np.full(n + nd, 4 * w, np.int32)
    keep = None
    if kind in ("deletes", "both"):
        keep = rng.random(n) > 0.3
    elif kind == "all_but_one":
        keep = np.zeros(n, bool)
        keep[rng.integers(0, n)] = True
    has_delta = kind in ("inserts", "both", "all_but_one")
    if kind == "dbitmap_changed":
        meta_words = words[:n]  # the delta sets a D-bit the base lacks
        words[n:, 0] |= np.uint32(0x40000000)
    else:
        meta_words = words if has_delta else words[:n]
    base = (RKeySet(words[:n], lengths[:n], rids[:n]),
            keyset_from_numpy(words[:n], lengths[:n], rids[:n]))
    delta = (None, None)
    if has_delta or kind == "dbitmap_changed":
        delta = (RKeySet(words[n:], lengths[n:], rids[n:]),
                 keyset_from_numpy(words[n:], lengths[n:], rids[n:]))
    rmeta = r_meta_from_keys(meta_words)
    tmeta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    return base, delta, keep, (rmeta, tmeta)


def _incremental_pair(kind: str, backend: str):
    """The reference's and the port's ``run_incremental`` on one case."""
    (rbase, tbase), (rdelta, tdelta), keep, (rmeta, tmeta) = _incremental_case(kind)
    rpipe = RPipeline(backend="jnp")
    tpipe = ReconstructionPipeline(backend=backend, device="cpu")
    rprev, tprev = rpipe.run(rbase, meta=rmeta), tpipe.run(tbase, meta=tmeta)
    if kind == "dbitmap_changed":  # the current meta covers the delta
        rmeta = r_meta_from_keys(np.concatenate([rbase.words, rdelta.words]))
        tmeta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    if kind == "no_extract_bitmap":
        rprev.extract_bitmap = None
        tprev.extract_bitmap = None
    kw = {"keep_rows": keep}
    ref, rfold = rpipe.run_incremental(rprev, rbase, rdelta, meta=rmeta, **kw)
    res, tfold = tpipe.run_incremental(tprev, tbase, tdelta, meta=tmeta, **kw)
    np.testing.assert_array_equal(tfold.words, rfold.words)
    np.testing.assert_array_equal(tfold.rids, rfold.rids)
    return res, ref


@pytest.mark.parametrize("kind", ["deletes", "inserts", "both", "all_but_one"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_incremental_matches_reference(backend, kind):
    res, ref = _incremental_pair(kind, backend)
    _assert_same(result_to_numpy(res), _ref_numpy(ref))
    assert res.stats["incremental"] is True and ref.stats["incremental"] is True
    for key in ("n_delta", "n_deleted", "n_keys"):
        assert res.stats[key] == ref.stats[key], key
    assert {"filter", "extract", "sort", "merge", "build", "refresh_meta",
            "sync"} <= res.timings.keys()


@pytest.mark.parametrize("kind", ["dbitmap_changed", "no_extract_bitmap"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_incremental_fallbacks_match_reference(backend, kind):
    res, ref = _incremental_pair(kind, backend)
    _assert_same(result_to_numpy(res), _ref_numpy(ref))
    assert res.stats["incremental"] is False
    assert res.stats["incremental_fallback"] == ref.stats["incremental_fallback"] == kind


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_incremental_noop_matches_reference(backend):
    (rbase, tbase), _, _, (rmeta, tmeta) = _incremental_case("deletes")
    rpipe = RPipeline(backend="jnp")
    tpipe = ReconstructionPipeline(backend=backend, device="cpu")
    rprev, tprev = rpipe.run(rbase, meta=rmeta), tpipe.run(tbase, meta=tmeta)
    keep = np.ones(rbase.n, bool)
    ref, _ = rpipe.run_incremental(rprev, rbase, None, keep_rows=keep, watermark=7)
    cudalib.reset_launches()
    res, _ = tpipe.run_incremental(tprev, tbase, None, keep_rows=keep, watermark=7)
    assert res.stats["noop"] is True and ref.stats["noop"] is True
    assert res.watermark == 7 and res.comp_sorted is tprev.comp_sorted
    assert all(v == 0.0 for v in res.timings.values())
    _assert_same(result_to_numpy(res), _ref_numpy(ref))


# ---------------------------------------------------------------------------
# the dbit pass of refresh_meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,w,mask", [(257, 3, 0x0000FF0F), (1000, 2, 0x3), (300, 128, 0x1)])
def test_adjacent_dbits_plain_matches_reference_kernel(n, w, mask):
    rng = np.random.default_rng(n)
    words = np.sort(rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask),
                    axis=0)
    words[5] = words[4]  # an equal pair
    words[9, -1] = words[8, -1] ^ np.uint32(1)  # a difference in the last bit only
    words[9, :-1] = words[8, :-1]
    want = np.asarray(r_dbit.adjacent_dbits(jnp.asarray(words), tile=256, interpret=True))
    got = adjacent_dbits_plain(_t(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(adjacent_dbits(_t(words)).numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RD.adjacent_dbit_positions(jnp.asarray(words))))
    np.testing.assert_array_equal(adjacent_dbits_ref(words), want)
    assert want[4] == TD.NO_DBIT and want[8] == 32 * w - 1


@pytest.mark.parametrize("n", [0, 1, 2])
def test_adjacent_dbits_tiny_runs(n):
    got = adjacent_dbits(torch.zeros((n, 2), dtype=torch.int64))
    assert got.shape == (max(n - 1, 0),) and got.dtype == torch.int32


def test_cuda_refresh_meta_matches_torch_and_reference():
    """The refresh of a sorted run, whole and as a bucket whose pad lanes
    hold garbage, equals the reference backend's on both port backends."""
    (rbase, tbase), _, _, (rmeta, tmeta) = _incremental_case("deletes")
    comp = np.asarray(RPipeline(backend="jnp").run(rbase, meta=rmeta).comp_sorted)
    n_valid = tbase.n - 7
    padded = np.concatenate([comp[:n_valid], np.full((9, comp.shape[1]), 5, np.uint32)])
    r_be = r_get_backend("jnp")
    for keys, nv in ((comp, None), (padded, n_valid)):
        want = r_be.refresh_meta(jnp.asarray(keys), rmeta, rbase.words[0], n_valid=nv)
        for backend in PORT_BACKENDS:
            got = get_backend(backend, device="cpu").refresh_meta(
                _t(keys), tmeta, tbase.words[0], n_valid=nv)
            for field in ("dbitmap", "varbitmap", "refkey"):
                np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                              err_msg=f"{backend}:{field}")


# ---------------------------------------------------------------------------
# chunk tuning
# ---------------------------------------------------------------------------


def test_tune_chunking_measures_and_persists():
    pipe = ReconstructionPipeline("cuda", device="cpu")
    plan = pipe.tune_chunking(candidates=(256, 512), ref_n=1 << 13, iters=2)
    assert plan.backend == "cuda"
    assert plan.chunk_size in (256, 512)
    assert plan.chunk_threshold & (plan.chunk_threshold - 1) == 0
    assert plan.chunk_threshold >= 2 * plan.chunk_size or plan.chunk_threshold == plan.ref_n
    assert set(plan.sort_warm) == set(plan.merge_cold) == {256, 512}
    assert all(v > 0 for v in plan.sort_cold.values())
    assert pipe.chunk_size == plan.chunk_size
    assert pipe.chunk_threshold == plan.chunk_threshold
    assert pipe.chunk_plan is plan
    _, tks = _keyset_pair(700)
    res = pipe.run(tks)
    assert res.stats["chunk_tuned"] is True
    assert res.stats["chunk_size"] == plan.chunk_size
    assert res.stats["chunk_threshold"] == plan.chunk_threshold
    with pytest.raises(ValueError, match="power"):
        TP.tune_chunking(pipe.backend, candidates=(256, 300))


def test_auto_tune_triggers_lazily():
    pipe = ReconstructionPipeline("torch", device="cpu", auto_tune_chunks=True,
                                  chunk_threshold=1024, chunk_size=512)
    pipe.run(_keyset_pair(600)[1])
    assert pipe.chunk_plan is None  # below the threshold: no probe
    calls = []
    orig = pipe.tune_chunking

    def spy(**kw):
        calls.append(kw)
        return orig(candidates=(256, 512), ref_n=1 << 13)

    pipe.tune_chunking = spy
    _, big = _keyset_pair(1500)
    res1, res2 = pipe.run(big), pipe.run(big)
    assert len(calls) == 1  # calibrated once, then reused
    assert pipe.chunk_plan is not None
    assert res1.stats["chunk_tuned"] and res2.stats["chunk_tuned"]
    _assert_same(result_to_numpy(res1), _ref_numpy(_ref_chunked(1500, False)))
