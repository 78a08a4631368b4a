"""Parity of the PyTorch port's key algebra with the JAX reference.

The same numpy inputs, made from a seed, go through ``repro.core.*`` and
its counterpart in ``repro_torch.core``; integer outputs must be equal
byte for byte (``assert_array_equal`` after casting to uint32/int32).
Edge cases: 2^k±1 keys, duplicate keys, all-identical keys (empty
D-bitmap), all-ones keys and 128-word keys.  The reference's key algebra
is called under ``jax.jit``, as its pipeline calls it: one compile per
shape instead of one per operation, with the same integer results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_index import ZipfConfig as RZipf  # noqa: E402
from repro.core import compress as RC  # noqa: E402
from repro.core import dbits as RD  # noqa: E402
from repro.core import keyformat as RK  # noqa: E402
from repro.core import metadata as RM  # noqa: E402
from repro.core import plancache as RP  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro_torch.configs.paper_index import IndexDatasetConfig, ZipfConfig  # noqa: E402
from repro_torch.core import compress as TC  # noqa: E402
from repro_torch.core import dbits as TD  # noqa: E402
from repro_torch.core import keyformat as TK  # noqa: E402
from repro_torch.core import metadata as TM  # noqa: E402
from repro_torch.core import plancache as TP  # noqa: E402
from repro_torch.core.sortkeys import word_comparison_counts  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402

r_lex_less = jax.jit(RD.lex_less)
r_lex_le = jax.jit(RD.lex_compare_le)
r_sort_words = jax.jit(RD.sort_words, static_argnames="num_key_words")
r_sort_keyed = jax.jit(RD.sort_words_keyed)
r_pairwise = jax.jit(RD.dbit_position_pairwise)
r_adjacent = jax.jit(RD.adjacent_dbit_positions)
r_dbitmap = jax.jit(RD.compute_dbitmap)
r_variant = jax.jit(RD.compute_variant_bitmap)


def _case(name: str) -> np.ndarray:
    """(n, W) uint32 keys for one named edge case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "dup_257x3":
        return rng.integers(0, 2**32, size=(257, 3), dtype=np.uint32) & np.uint32(0x000F0F03)
    if name == "rand_255x3":
        return rng.integers(0, 2**32, size=(255, 3), dtype=np.uint32)
    if name == "masked_255x3":
        return rng.integers(0, 2**32, size=(255, 3), dtype=np.uint32) & np.uint32(0x00FF00FF)
    if name == "identical_257x3":
        return np.tile(rng.integers(0, 2**32, size=(1, 3), dtype=np.uint32), (257, 1))
    if name == "allones_257x3":
        return np.full((257, 3), 0xFFFFFFFF, np.uint32)
    if name == "wide_200x128":
        return rng.integers(0, 2**32, size=(200, 128), dtype=np.uint32) & np.uint32(0x01010101)
    raise KeyError(name)


# shapes repeat on purpose: the reference compiles once per shape, so each
# further case of a shape costs little
CASES = ["dup_257x3", "identical_257x3", "allones_257x3", "rand_255x3", "masked_255x3",
         "wide_200x128"]


def _t(a):
    return to_carrier(np.asarray(a, np.uint32), "cpu")


def _eq_u32(got, want):
    np.testing.assert_array_equal(to_u32(got), np.asarray(want, np.uint32))


def _eq_i32(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.asarray(want, np.int32))


# ---------------------------------------------------------------------------
# key formats and generators
# ---------------------------------------------------------------------------


def test_keys_to_words_matches_reference():
    rng = np.random.default_rng(3)
    keys = [bytes(rng.integers(0, 256, size=int(k), dtype=np.uint8))
            for k in rng.integers(1, 30, size=50)]
    want = RK.keys_to_words(keys, rids=np.arange(50)[::-1])
    got = TK.keys_to_words(keys, rids=np.arange(50)[::-1])
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("width", [4, 64])
def test_rows_to_keyset_matches_keys_to_words(width):
    buf = np.random.default_rng(width).integers(0, 256, size=(33, width), dtype=np.uint8)
    want = RK.keys_to_words([bytes(r) for r in buf])
    got = TS.rows_to_keyset(buf)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("s,n_bytes,m,n_keys", [
    (1.5, 64, 0, 3000), (2.5, 48, 0, 2049), (1.5, 40, 3, 1500), (1.5, 64, 5, 1023),
])
def test_zipf_keys_match_reference(s, n_bytes, m, n_keys):
    want = RS.zipf_keys(RZipf(s, n_bytes, m, n_keys), seed=7)
    got = TS.zipf_keys(ZipfConfig(s, n_bytes, m, n_keys), seed=7)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_zipf_keys_without_dedupe_match_reference():
    want = RS.zipf_keys(RZipf(2.5, 48, 0, 700), seed=1, unique=False)
    got = TS.zipf_keys(ZipfConfig(2.5, 48, 0, 700), seed=1, unique=False)
    np.testing.assert_array_equal(got.words, want.words)


@pytest.mark.parametrize("kind,key_bytes,n", [("fixed", 35, 300), ("url", 59, 200),
                                              ("title", 24, 200), ("zipf", 40, 500)])
def test_dataset_keys_match_reference(kind, key_bytes, n):
    from repro.configs.paper_index import IndexDatasetConfig as RCfg

    want = RS.dataset_keys(RCfg("x", n, key_bytes, kind), seed=2)
    got = TS.dataset_keys(IndexDatasetConfig("x", n, key_bytes, kind), seed=2)
    for field in ("words", "lengths", "rids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# ---------------------------------------------------------------------------
# distinction bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_sort_words_matches_reference(case):
    words = _case(case)
    payload = np.arange(words.shape[0], dtype=np.uint32)[::-1].copy()
    rw, rp = r_sort_words(jnp.asarray(words), jnp.asarray(payload))
    tw, tp = TD.sort_words(_t(words), _t(payload))
    _eq_u32(tw, rw)
    _eq_u32(tp, rp)


@pytest.mark.parametrize("case", CASES)
def test_sort_words_keyed_matches_reference(case):
    words = _case(case)
    rows = np.random.default_rng(1).permutation(words.shape[0]).astype(np.uint32)
    rk, rr = r_sort_keyed(jnp.asarray(words), jnp.asarray(rows))
    tk, tr = TD.sort_words_keyed(_t(words), _t(rows))
    _eq_u32(tk, rk)
    _eq_u32(tr, rr)


def test_sort_words_partial_key_is_stable():
    words = _case("dup_257x3")
    payload = np.arange(257, dtype=np.uint32)
    rw, rp = r_sort_words(jnp.asarray(words), jnp.asarray(payload), num_key_words=1)
    tw, tp = TD.sort_words(_t(words), _t(payload), num_key_words=1)
    _eq_u32(tw, rw)
    _eq_u32(tp, rp)


@pytest.mark.parametrize("case", CASES)
def test_lex_compare_matches_reference(case):
    words = _case(case)
    other = np.roll(words, 1, axis=0)
    other[::3] = words[::3]  # some equal pairs
    np.testing.assert_array_equal(
        TD.lex_less(_t(words), _t(other)).numpy(),
        np.asarray(r_lex_less(jnp.asarray(words), jnp.asarray(other))))
    np.testing.assert_array_equal(
        TD.lex_compare_le(_t(words), _t(other)).numpy(),
        np.asarray(r_lex_le(jnp.asarray(words), jnp.asarray(other))))


@pytest.mark.parametrize("case", CASES)
def test_dbit_positions_match_reference(case):
    words = _case(case)
    (sw,) = r_sort_words(jnp.asarray(words))
    _eq_i32(TD.adjacent_dbit_positions(_t(np.asarray(sw))), r_adjacent(sw))
    other = np.roll(words, 7, axis=0)
    _eq_i32(TD.dbit_position_pairwise(_t(words), _t(other)),
            r_pairwise(jnp.asarray(words), jnp.asarray(other)))


def test_clz_is_exact_on_every_bit():
    """The frexp clz at each single-bit and all-ones-below value."""
    vals = np.array([1 << b for b in range(32)] + [(1 << b) - 1 for b in range(1, 33)],
                    np.uint64).astype(np.uint32)
    a = np.zeros((vals.size, 1), np.uint32)
    b = vals[:, None]
    _eq_i32(TD.dbit_position_pairwise(_t(a), _t(b)),
            r_pairwise(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("case", CASES)
def test_dbitmap_and_variant_bitmap_match_reference(case):
    words = _case(case)
    _eq_u32(TD.compute_dbitmap(_t(words)), r_dbitmap(jnp.asarray(words)))
    rv, rr = r_variant(jnp.asarray(words))
    tv, tr = TD.compute_variant_bitmap(_t(words))
    _eq_u32(tv, rv)
    _eq_u32(tr, rr)


def test_positions_bitmap_roundtrip_matches_reference():
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.integers(0, 96, size=40), [RD.NO_DBIT] * 3, [5, 5]]).astype(np.int32)
    bm = TD.positions_to_bitmap(torch.as_tensor(pos.astype(np.int64)), 3)
    _eq_u32(bm, RD.positions_to_bitmap(jnp.asarray(pos), 3))
    np.testing.assert_array_equal(TD.bitmap_to_positions(to_u32(bm)),
                                  RD.bitmap_to_positions(to_u32(bm)))
    empty = np.zeros(3, np.uint32)
    np.testing.assert_array_equal(TD.dbit_positions_nonempty(empty),
                                  RD.dbit_positions_nonempty(empty))


# ---------------------------------------------------------------------------
# extraction plan, metadata, plan-cache pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_plan_and_extract_bits_match_reference(case):
    words = _case(case)
    bm = np.asarray(r_dbitmap(jnp.asarray(words)))
    rplan = RC.make_plan(bm, words.shape[1])
    tplan = TC.make_plan(bm, words.shape[1])
    for field in ("positions", "src_word", "src_shift", "n_words_in", "n_words_out"):
        assert getattr(tplan, field) == getattr(rplan, field)
    for key, val in rplan.as_arrays().items():
        np.testing.assert_array_equal(tplan.as_arrays()[key], val)
    _eq_u32(TC.extract_bits(_t(words), tplan), RC.extract_bits(jnp.asarray(words), rplan))


@pytest.mark.parametrize("case", ["dup_257x3", "identical_257x3", "wide_200x128"])
def test_meta_from_keys_and_rebuild_match_reference(case):
    words = _case(case)
    rmeta = RM.meta_from_keys(words)
    tmeta = TM.meta_from_keys(words, device="cpu")
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(tmeta, field), getattr(rmeta, field))
    assert tmeta.n_words == rmeta.n_words and tmeta.n_dbits == rmeta.n_dbits
    np.testing.assert_array_equal(tmeta.d_offset(), rmeta.d_offset())
    comp = np.asarray(r_sort_words(RC.extract_bits(jnp.asarray(words), rmeta.plan()))[0])
    want = RM.meta_on_rebuild(comp, rmeta, words[-1])
    got = TM.meta_on_rebuild(comp, tmeta, words[-1])
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_meta_update_rules_match_reference():
    words = _case("masked_255x3")
    rmeta = RM.meta_from_keys(words[:-1])
    tmeta = TM.meta_from_keys(words[:-1], device="cpu")
    got = TM.meta_on_insert(tmeta, words[0], words[-1], words[1])
    want = RM.meta_on_insert(rmeta, words[0], words[-1], words[1])
    np.testing.assert_array_equal(got.dbitmap, want.dbitmap)
    np.testing.assert_array_equal(got.varbitmap, want.varbitmap)
    assert TM.meta_on_delete(tmeta) is tmeta
    pinned, shed, dels = TM.shed_or_pin(tmeta, words[0], 10, 0.5, 100)
    rpinned, rshed, rdels = RM.shed_or_pin(rmeta, words[0], 10, 0.5, 100)
    np.testing.assert_array_equal(pinned.dbitmap, rpinned.dbitmap)
    assert (shed, dels) == (rshed, rdels)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1023, 1025, 4096])
def test_buckets_match_reference(n):
    assert TP.bucket(n) == RP.bucket(n)
    assert TP.bucket_for("sort", n) == RP.bucket_for("sort", n)


@pytest.mark.parametrize("case", ["dup_257x3", "allones_257x3", "masked_255x3"])
@pytest.mark.parametrize("fill", [0, 0xDEADBEEF])
def test_sort_padded_matches_reference(case, fill):
    """Pads hold garbage; the in-sort normalization makes them sort last,
    so the padded outputs equal the reference's lane for lane."""
    words = _case(case)
    n = words.shape[0]
    b = RP.bucket_for("sort", n)
    kp = np.full((b, words.shape[1]), fill, np.uint32)
    kp[:n] = words
    rp = np.full((b,), fill, np.uint32)
    rp[:n] = np.random.default_rng(0).permutation(n)
    rk, rr = RP.sort_padded(jnp.asarray(kp), jnp.asarray(rp), n_valid=n, keep_padded=True)
    tk, tr = TP.sort_padded(_t(kp), _t(rp), n_valid=n, keep_padded=True)
    _eq_u32(tk, rk)
    _eq_u32(tr, rr)
    rk, rr = RP.sort_padded(jnp.asarray(words), jnp.asarray(rp[:n]))
    tk, tr = TP.sort_padded(_t(words), _t(rp[:n]))
    _eq_u32(tk, rk)
    _eq_u32(tr, rr)


@pytest.mark.parametrize("case", ["dup_257x3", "identical_257x3", "rand_255x3"])
def test_adjacent_dpos_padded_matches_reference(case):
    (sw,) = r_sort_words(jnp.asarray(_case(case)))
    sw = np.asarray(sw)
    n = sw.shape[0]
    padded = np.concatenate([sw, np.zeros((TP.bucket(n) - n, sw.shape[1]), np.uint32)])
    want = RP.adjacent_dpos_padded(jnp.asarray(padded), n_valid=n)
    np.testing.assert_array_equal(TP.adjacent_dpos_padded(_t(padded), n_valid=n), want)
    np.testing.assert_array_equal(TP.adjacent_dpos_padded(_t(sw)), want)


def test_word_comparison_counts_bounds():
    """The reference samples pairs with jax.random, so only the exact
    corner values are comparable: identical keys take every word, keys
    differing in word 0 take one."""
    same = _t(_case("identical_257x3"))
    assert word_comparison_counts(same) == 3.0
    first = np.zeros((64, 4), np.uint32)
    first[:, 0] = np.arange(64)
    wcc = word_comparison_counts(_t(first), sample_pairs=512)
    assert 1.0 <= wcc <= 4.0
