"""The port's batched and fused reconstruction against the JAX reference.

``extract_bits_dynamic`` (the runtime-bitmap extraction), the backends'
``batched_extract_sort`` and ``fused_extract_sort``, the fused ``run``
and ``run_many`` (grouped by bucket, members padded with all-ones keys
and reserved rows, single members and mixed shapes falling back to
``run``) are fed the same numpy inputs as ``repro`` (jnp, and pallas in
interpret mode) and compared byte for byte: the tolerance is exact
equality.  A model of the ``"cuda"`` backend's stacked layout (members
rounded up to whole 512-row blocks) checks that one block sort over the
stack equals the block sort of each member alone.  ``"cuda"`` runs on the CPU here (``device="cpu"``: each kernel
wrapper takes its plain version); the GPU tests in
``tests/test_torch_cuda.py`` hold the stacked bitonic launch against
per-member sorts.  The cases mirror ``tests/test_pipeline.py``'s and
``tests/test_plancache.py``'s ``run_many`` cases at their shapes (W = 3,
n of 600-1000).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.core.compress import extract_bits_dynamic as r_extract_dynamic  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.metadata import meta_from_keys as r_meta_from_keys  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.core.plancache import ROW_PAD_A  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.compress import extract_bits_dynamic, make_plan  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402

PORT_BACKENDS = ("torch", "cuda", "distributed")


def _words(seed, n, w=3, mask=0x00FF0F0F):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


def _keysets(words, seed=0):
    """Reference and port keysets over the same words, shuffled rids."""
    n, w = words.shape
    rids = np.random.default_rng(seed).permutation(n).astype(np.uint32)
    lengths = np.full(n, 4 * w, np.int32)
    return (RKeySet(words=words, lengths=lengths, rids=rids),
            keyset_from_numpy(words, lengths, rids))


def _assert_results_equal(res, ref):
    got = result_to_numpy(res)
    for name in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)), err_msg=name)
    tree = got["tree"]
    np.testing.assert_array_equal(tree["sorted_full"], np.asarray(ref.tree.sorted_full))
    np.testing.assert_array_equal(tree["sorted_rids"], np.asarray(ref.tree.sorted_rids))
    for k, v in ref.tree.leaf.items():
        np.testing.assert_array_equal(tree["leaf"][k], np.asarray(v), err_msg=k)
    assert len(tree["levels"]) == len(ref.tree.levels)
    for lg, lw in zip(tree["levels"], ref.tree.levels):
        for k, v in lw.items():
            np.testing.assert_array_equal(lg[k], np.asarray(v), err_msg=k)
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(res.meta, field), getattr(ref.meta, field))
    np.testing.assert_array_equal(res.extract_bitmap, ref.extract_bitmap)


# ---------------------------------------------------------------------------
# extract_bits_dynamic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 3, 16, 128])
@pytest.mark.parametrize("kind", ["empty", "one_bit", "last_bit", "full", "random"])
def test_extract_bits_dynamic_matches_reference(w, kind):
    rng = np.random.default_rng(w)
    words = rng.integers(0, 2**32, size=(257, w), dtype=np.uint32)
    words[0] = 0xFFFFFFFF
    bitmap = np.zeros(w, np.uint32)
    if kind == "one_bit":
        bitmap[0] = 0x80000000
    elif kind == "last_bit":
        bitmap[-1] = 1
    elif kind == "full":
        bitmap[:] = 0xFFFFFFFF
    elif kind == "random":
        bitmap = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    n_bits = int(np.unpackbits(bitmap.astype(">u4").view(np.uint8)).sum())
    for n_words_out in sorted({max(1, -(-n_bits // 32)), 1}):
        want = np.asarray(r_extract_dynamic(jnp.asarray(words), jnp.asarray(bitmap),
                                            n_words_out))
        got = extract_bits_dynamic(to_carrier(words, "cpu"), to_carrier(bitmap, "cpu"),
                                   n_words_out)
        np.testing.assert_array_equal(to_u32(got), want)
        # the numpy bitmap form and the backend op give the same words
        np.testing.assert_array_equal(
            to_u32(get_backend("cuda", device="cpu").extract_dynamic(
                to_carrier(words, "cpu"), bitmap, n_words_out)), want)


# ---------------------------------------------------------------------------
# the backends' batched and fused extract+sort
# ---------------------------------------------------------------------------


def _stacked_batch(k=3, b=256, w=3):
    """k members padded to b rows the way ``run_many`` pads them: all-ones
    keys and reserved rows ``ROW_PAD_A + i``; members share a bitmap
    width (a union bitmap)."""
    sizes = [b - 6 * i for i in range(k)]
    words = [_words(40 + i, n, w) for i, n in enumerate(sizes)]
    union = r_meta_from_keys(np.concatenate(words))
    metas = [r_meta_from_keys(x) for x in words]
    wc = union.plan().n_words_out
    metas = [m if m.plan().n_words_out == wc else union for m in metas]
    padded = np.stack([np.concatenate([x, np.full((b - x.shape[0], w), 0xFFFFFFFF,
                                                  np.uint32)]) for x in words])
    rows = np.stack([np.concatenate([np.arange(x.shape[0], dtype=np.uint32),
                                     np.uint32(ROW_PAD_A) + np.arange(b - x.shape[0],
                                                                      dtype=np.uint32)])
                     for x in words])
    bitmaps = np.stack([m.dbitmap for m in metas])
    return padded, bitmaps, rows, metas


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batched_extract_sort_matches_reference(backend):
    words, bitmaps, rows, metas = _stacked_batch()
    want_k, want_r = r_get_backend("jnp").batched_extract_sort(
        jnp.asarray(words), jnp.asarray(bitmaps), jnp.asarray(rows),
        [m.plan() for m in metas])
    plans = [make_plan(m.dbitmap, m.n_words) for m in metas]
    be = get_backend(backend, device="cpu")
    assert be.supports_batched
    got_k, got_r = be.batched_extract_sort(to_carrier(words, "cpu"), to_carrier(bitmaps, "cpu"),
                                           to_carrier(rows, "cpu"), plans)
    assert tuple(got_k.shape) == tuple(want_k.shape) and tuple(got_r.shape) == want_r.shape
    # the build's kernels take dense rows of each member
    assert got_k.is_contiguous() and got_r.is_contiguous()
    np.testing.assert_array_equal(to_u32(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(to_u32(got_r), np.asarray(want_r))


def test_fused_extract_sort_matches_reference():
    words = _words(50, 300)
    meta = r_meta_from_keys(words)
    rows = np.arange(300, dtype=np.uint32)
    want = r_get_backend("jnp").fused_extract_sort(jnp.asarray(words), meta.plan(),
                                                   jnp.asarray(rows))
    be = get_backend("torch", device="cpu")
    assert be.supports_fused and not get_backend("cuda", device="cpu").supports_fused
    plan = make_plan(meta.dbitmap, meta.n_words)
    got = be.fused_extract_sort(to_carrier(words, "cpu"), plan, to_carrier(rows, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    # bucket-shaped input with garbage pads, kept padded: pads sort last
    b = plancache.bucket(300)
    wp = to_carrier(np.concatenate([words, _words(51, b - 300)]), "cpu")
    ks, rs = plancache.fused_extract_sort_padded(wp, plan, plancache.iota(b, "cpu"),
                                                 n_valid=300, keep_padded=True)
    np.testing.assert_array_equal(to_u32(ks[:300]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_u32(rs[300:]), ROW_PAD_A + np.arange(300, b))
    with pytest.raises(NotImplementedError, match="no fused path"):
        get_backend("cuda", device="cpu").fused_extract_sort(wp, plan, rs)


@pytest.mark.parametrize("case", ["dup_300_3", "rand_1000_3"])
def test_fused_run_matches_reference(case):
    kind, n, w = case.split("_")
    words = _words(60, int(n), int(w), 0x00FF0F0F if kind == "dup" else 0xFFFFFFFF)
    rks, tks = _keysets(words)
    ref = RPipeline(backend="jnp", fused=True).run(rks)
    res = ReconstructionPipeline(backend="torch", device="cpu", fused=True).run(tks)
    assert res.stats["fused"] is ref.stats["fused"] is True
    assert res.timings["extract"] == 0.0
    _assert_results_equal(res, ref)
    # no fused path on "cuda": the flag is ignored, the output the same
    res_c = ReconstructionPipeline(backend="cuda", device="cpu", fused=True).run(tks)
    assert res_c.stats["fused"] is False
    _assert_results_equal(res_c, ref)


# ---------------------------------------------------------------------------
# the stacked block layout of the "cuda" batched sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [256, 512, 1024])
def test_stacked_block_layout_keeps_members_apart(b):
    """The layout the ``"cuda"`` backend hands the bitonic kernel: each
    member's bucket ``b`` rounded up to whole blocks, the extra rows
    all-ones keys with row ids above the pipeline's pad rows.  Every
    block then holds one member's rows only, so one block sort over the
    stack (the plain network, row for row the kernel's) equals the block
    sort of each member alone; at ``b`` = 256 without the rounding a
    block holds two members and the per-member sorts differ."""
    from repro_torch.core.plancache import ROW_PAD_B
    from repro_torch.kernels.bitonic import DEFAULT_BLOCK, block_sort_plain

    k, w = 3, 2
    n_pad = -(-b // DEFAULT_BLOCK) * DEFAULT_BLOCK
    assert n_pad % DEFAULT_BLOCK == 0 and n_pad - b < DEFAULT_BLOCK
    rng = np.random.default_rng(b)
    keys = rng.integers(0, 2**32, size=(k, b, w), dtype=np.uint32) & np.uint32(0x000F00FF)
    rows = np.tile(np.arange(b, dtype=np.uint32), (k, 1))
    stack = np.concatenate([keys, np.full((k, n_pad - b, w), 0xFFFFFFFF, np.uint32)], axis=1)
    srows = np.concatenate([rows, np.tile(ROW_PAD_B + np.arange(b, n_pad, dtype=np.uint32),
                                          (k, 1))], axis=1)
    member_of_row = np.repeat(np.arange(k), n_pad).reshape(-1, DEFAULT_BLOCK)
    assert (member_of_row == member_of_row[:, :1]).all()  # no block straddles
    got_k, got_r = block_sort_plain(to_carrier(stack.reshape(-1, w), "cpu"),
                                    to_carrier(srows.reshape(-1), "cpu"))
    got_k, got_r = to_u32(got_k).reshape(k, n_pad, w), to_u32(got_r).reshape(k, n_pad)
    for i in range(k):
        wk, wr = block_sort_plain(to_carrier(stack[i], "cpu"), to_carrier(srows[i], "cpu"))
        np.testing.assert_array_equal(got_k[i], to_u32(wk))
        np.testing.assert_array_equal(got_r[i], to_u32(wr))
        # the extra rows sort last in their member, so [:b] is the member
        assert (got_r[i, b:] >= ROW_PAD_B).all()
    if b % DEFAULT_BLOCK:
        flat_k, _ = block_sort_plain(to_carrier(keys.reshape(-1, w), "cpu"),
                                     to_carrier(rows.reshape(-1), "cpu"))
        own, _ = block_sort_plain(to_carrier(keys[0], "cpu"), to_carrier(rows[0], "cpu"))
        assert not np.array_equal(to_u32(flat_k)[:b], to_u32(own))


# ---------------------------------------------------------------------------
# run_many
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_many_matches_reference_member_by_member(backend):
    """Three keysets of different masks and sizes drifting inside one
    bucket batch together; each member equals the reference's run_many
    member and the port's own single run."""
    sets = [_keysets(_words(70 + i, n, 3, m), seed=i)
            for i, (n, m) in enumerate([(900, 0x00FF0F0F), (950, 0x0FF000FF),
                                        (1000, 0x000FFF0F)])]
    refs = RPipeline(backend="jnp").run_many([r for r, _ in sets])
    pipe = ReconstructionPipeline(backend=backend, device="cpu")
    cudalib.reset_launches()
    got = pipe.run_many([t for _, t in sets])
    assert all(v == 0 for v in cudalib.LAUNCHES.values())  # CPU: plain versions
    for (_, tks), res, ref in zip(sets, got, refs):
        assert res.stats["batched"] == ref.stats["batched"] == 3
        assert res.stats["fused"] is False
        _assert_results_equal(res, ref)
        single = pipe.run(tks)
        np.testing.assert_array_equal(to_u32(res.comp_sorted), to_u32(single.comp_sorted))
        np.testing.assert_array_equal(to_u32(res.rid_sorted), to_u32(single.rid_sorted))


def test_run_many_matches_pallas_reference():
    """Members of 300, 280 and 270 keys (no multiple of the 512 block)
    drift inside the 512 bucket: the reference's pallas ``run_many``
    (interpret mode: per-member pext, one vmapped bitonic sort) and the
    port's ``"cuda"`` ``run_many`` agree member by member."""
    sets = [_keysets(_words(75, n, 3, 0x00FF0F0F), seed=i)
            for i, n in enumerate([300, 280, 270])]
    refs = RPipeline(backend="pallas").run_many([r for r, _ in sets])
    got = ReconstructionPipeline(backend="cuda", device="cpu").run_many([t for _, t in sets])
    for res, ref in zip(got, refs):
        assert res.stats["batched"] == ref.stats["batched"] == 3
        _assert_results_equal(res, ref)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_many_mixed_shapes_fall_back(backend):
    """Mixed widths and buckets: a group of one takes ``run`` (no
    ``batched`` stat); the two same-bucket members still batch."""
    sets = [_keysets(_words(80, 600, 2), seed=1), _keysets(_words(81, 900, 4), seed=2),
            _keysets(_words(82, 1000, 3), seed=3), _keysets(_words(83, 990, 3), seed=4)]
    refs = RPipeline(backend="jnp").run_many([r for r, _ in sets])
    got = ReconstructionPipeline(backend=backend, device="cpu").run_many(
        [t for _, t in sets])
    for res, ref in zip(got, refs):
        assert res.stats.get("batched") == ref.stats.get("batched")
        _assert_results_equal(res, ref)
    assert [r.stats.get("batched") for r in got] == [None, None, 2, 2]


def test_run_many_with_given_metas_and_no_batched_backend():
    """Given metas are used as is; a backend without ``supports_batched``
    runs each member through ``run``."""
    words = [_words(90 + i, 700) for i in range(2)]
    union = r_meta_from_keys(np.concatenate(words))
    sets = [_keysets(x, seed=i) for i, x in enumerate(words)]
    refs = RPipeline(backend="jnp").run_many([r for r, _ in sets], metas=[union, union])
    from repro_torch.convert import meta_from_numpy

    meta = meta_from_numpy(union.dbitmap, union.varbitmap, union.refkey, union.n_words)
    be = get_backend("torch", device="cpu")
    got = ReconstructionPipeline(backend=be).run_many([t for _, t in sets], metas=[meta, meta])
    for res, ref in zip(got, refs):
        assert res.stats["batched"] == 2
        _assert_results_equal(res, ref)
    be.supports_batched = False
    plain = ReconstructionPipeline(backend=be).run_many([t for _, t in sets], metas=[meta, meta])
    for res, ref in zip(plain, refs):
        assert "batched" not in res.stats
        _assert_results_equal(res, ref)
    with pytest.raises(ValueError, match="align"):
        ReconstructionPipeline(backend=be).run_many([t for _, t in sets], metas=[meta])
