"""The dbit kernel's two forms and the passes that take them, against the
JAX reference.

The bitmap form (the OR of every adjacent pair's D-bit, reduced on the
card) is held against the reference's Pallas dbit kernel in interpret
mode folded into a bitmap, and against ``repro.core.dbits.compute_dbitmap``;
the refresh's host half from bitmap words against the reference's
``meta_on_rebuild``; the ``"cuda"`` backend's ``run`` and
``run_incremental`` on ``device="cpu"`` (every kernel wrapper takes its
plain version) against the reference pipeline, with the passes counted.
A numpy model of the kernel's lanes (the shuffle and the halo row at
warp and tile edges, the walk over later sectors) is held against the
reference too.
``tests/test_torch_cuda.py`` holds the kernel against the plain versions
on a GPU.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compress as RC  # noqa: E402
from repro.core import dbits as RD  # noqa: E402
from repro.core import metadata as RM  # noqa: E402
from repro.core import plancache as RP  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.kernels.dbit import ops as r_dbit  # noqa: E402
from repro_torch.backends.cuda_backend import CudaBackend  # noqa: E402
from repro_torch.convert import keyset_from_numpy, meta_from_numpy, result_to_numpy  # noqa: E402
from repro_torch.core import metadata as TM  # noqa: E402
from repro_torch.core import plancache as TP  # noqa: E402
from repro_torch.core.dbits import NO_DBIT  # noqa: E402
from repro_torch.core.metadata import DSMeta  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels.dbit import (  # noqa: E402
    SECTOR_WORDS,
    adjacent_dbitmap,
    adjacent_dbitmap_plain,
    adjacent_dbits,
)
from repro_torch.kernels.dbit.ref import adjacent_dbitmap_ref  # noqa: E402

r_dbitmap_sorted = jax.jit(partial(RD.compute_dbitmap, presorted=True))
r_adjacent = jax.jit(RD.adjacent_dbit_positions)
r_sort = jax.jit(RD.sort_words)


def _t(a):
    return to_carrier(np.asarray(a), "cpu")


def _fold(positions, w: int) -> np.ndarray:
    """(m,) D-bit positions -> (w,) uint32 bitmap (NO_DBIT sets nothing)."""
    out = np.zeros(w, np.uint32)
    for p in np.asarray(positions).tolist():
        if p != NO_DBIT:
            out[p // 32] |= np.uint32(1 << (31 - p % 32))
    return out


def _sorted_keys(n: int, w: int, kind: str, seed: int = 0) -> np.ndarray:
    """(n, w) uint32 keys in ascending order.  ``masked``: random words
    under a mask (duplicates), with an equal pair and a pair that differs
    only in the last bit of the last word; ``equal``: one key repeated;
    ``last_word``: keys that differ in the last word only."""
    rng = np.random.default_rng(seed + 1000 * w + n)
    if kind == "equal":
        return np.tile(rng.integers(0, 2**32, size=(1, w), dtype=np.uint32), (n, 1))
    if kind == "last_word":
        keys = np.zeros((n, w), np.uint32)
        keys[:, -1] = np.arange(n) // 2
        return keys
    keys = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(0x0101FF0F)
    keys = keys[np.lexsort(keys.T[::-1])]
    if n > 12:
        keys[5] = keys[4]
        keys[9] = keys[8]
        keys[9, -1] ^= np.uint32(1)
        keys = keys[np.lexsort(keys.T[::-1])]
    return keys


# ---------------------------------------------------------------------------
# the bitmap form's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 3, 4, 16, 17, 128])
def test_adjacent_dbitmap_plain_matches_reference(w):
    """The plain bitmap form against the reference kernel (interpret mode)
    folded into a bitmap and against ``compute_dbitmap`` on the sorted
    keys; duplicate pairs, a last-bit pair and an all-equal run."""
    for kind in ("masked", "equal"):
        words = _sorted_keys(257, w, kind)
        positions = np.asarray(r_dbit.adjacent_dbits(jnp.asarray(words), tile=256,
                                                      interpret=True))
        want = _fold(positions, w)
        np.testing.assert_array_equal(np.asarray(r_dbitmap_sorted(jnp.asarray(words))), want)
        got = adjacent_dbitmap_plain(_t(words))
        assert got.dtype == torch.int64 and got.shape == (w,)
        np.testing.assert_array_equal(to_u32(got), want)
        np.testing.assert_array_equal(to_u32(adjacent_dbitmap(_t(words))), want)
        np.testing.assert_array_equal(adjacent_dbitmap_ref(words), want)
        if kind == "masked":
            assert positions[4] == NO_DBIT and positions[8] == 32 * w - 1
            assert want[-1] & np.uint32(1)
        else:
            assert not want.any()


@pytest.mark.parametrize("n", [0, 1, 2])
def test_adjacent_dbitmap_tiny_runs(n):
    words = _sorted_keys(2, 3, "masked")[:n]
    got = adjacent_dbitmap(_t(words).reshape(n, 3))
    assert got.shape == (3,) and got.dtype == torch.int64
    want = _fold(np.asarray(r_adjacent(jnp.asarray(words).reshape(n, 3))), 3)
    np.testing.assert_array_equal(to_u32(got), want)
    assert bool(want.any()) == (n == 2)


@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("fill", [0, 0xDEADBEEF])
def test_adjacent_dbitmap_padded_reads_only_valid_rows(w, fill):
    """A bucket-shaped run whose pad lanes hold garbage: only the first
    ``n_valid`` rows count, as in the reference's padded refresh pass."""
    words = _sorted_keys(257, w, "masked")
    n = words.shape[0]
    padded = np.full((TP.bucket(n), w), fill, np.uint32)
    padded[:n] = words
    want = _fold(RP.adjacent_dpos_padded(jnp.asarray(padded), n_valid=n), w)
    for impl in (None, adjacent_dbitmap):
        got = TP.adjacent_dbitmap_padded(_t(padded), n_valid=n, impl=impl)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TP.adjacent_dbitmap_padded(_t(words)), want)
    np.testing.assert_array_equal(
        TP.adjacent_dbitmap_padded(_t(padded), n_valid=1), np.zeros(w, np.uint32))


# ---------------------------------------------------------------------------
# the refresh's host half from bitmap words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["masked", "identical", "stale_degenerate"])
def test_meta_on_rebuild_from_bitmap_words_matches_reference(case):
    """The compressed run's bitmap words mapped through D-offset equal the
    reference's refresh from every position; ``identical`` keys leave an
    empty D-bitmap (a one-position D-offset) and ``stale_degenerate``
    refreshes such a metadata over keys that differ at bit 0."""
    rng = np.random.default_rng(7)
    if case == "masked":
        words = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint32) & np.uint32(0x00FF0F03)
    elif case == "identical":
        words = np.tile(rng.integers(0, 2**32, size=(1, 3), dtype=np.uint32), (300, 1))
    else:
        words = np.zeros((300, 3), np.uint32)
        words[::3, 0] = np.uint32(0x80000000)
    rmeta = RM.meta_from_keys(words)
    if case == "stale_degenerate":
        rmeta = RM.DSMeta(dbitmap=np.zeros(3, np.uint32), varbitmap=rmeta.varbitmap,
                          refkey=rmeta.refkey, n_words=3)
    assert len(rmeta.d_offset()) == (1 if case != "masked" else rmeta.n_dbits)
    tmeta = DSMeta(dbitmap=rmeta.dbitmap, varbitmap=rmeta.varbitmap, refkey=rmeta.refkey,
                   n_words=3)
    (comp,) = r_sort(RC.extract_bits(jnp.asarray(words), rmeta.plan()))
    comp = np.asarray(comp)
    want = RM.meta_on_rebuild(comp, rmeta, words[-1])
    bits = to_u32(adjacent_dbitmap(_t(comp)))
    got = TM.meta_on_rebuild(np.zeros((0, comp.shape[1]), np.uint32), tmeta, words[-1],
                             dbitmap_comp=bits)
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert bool(want.dbitmap.any()) == (case != "identical")


# ---------------------------------------------------------------------------
# the "cuda" pipeline on the CPU: every adjacent pass through the hooks
# ---------------------------------------------------------------------------


def _count_passes(monkeypatch) -> dict:
    """Spy on the "cuda" backend's two dbit hooks (their CPU wrappers).
    A cached program keeps the hooks it was built with, so the spies run
    in a fresh plan cache."""
    calls = {"bitmap": [], "positions": []}
    monkeypatch.setattr(TP, "_GLOBAL", TP.PlanCache())

    def bitmap(words):
        calls["bitmap"].append(tuple(words.shape))
        return adjacent_dbitmap(words)

    def positions(words):
        calls["positions"].append(tuple(words.shape))
        return adjacent_dbits(words)

    monkeypatch.setattr(CudaBackend, "dbitmap_fn", staticmethod(bitmap))
    monkeypatch.setattr(CudaBackend, "dpos_fn", staticmethod(positions))
    return calls


def _assert_same(res, ref):
    got = result_to_numpy(res)
    for name in ("comp_sorted", "rid_sorted", "row_sorted"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref, name)), err_msg=name)
    for key, val in ref.tree.leaf.items():
        np.testing.assert_array_equal(got["tree"]["leaf"][key].astype(np.asarray(val).dtype),
                                      np.asarray(val), err_msg=key)
    for g, r in zip(got["tree"]["levels"], ref.tree.levels):
        for key, val in r.items():
            np.testing.assert_array_equal(g[key].astype(np.asarray(val).dtype), np.asarray(val),
                                          err_msg=key)
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(got["meta"][field], getattr(ref.meta, field))


def test_cuda_run_and_run_incremental_take_the_dbit_hooks(monkeypatch):
    """``run`` (metadata from the keys, the build, the refresh) and
    ``run_incremental`` (the build, the refresh) on "cuda" equal the
    reference pipeline, with meta_from_keys and the refresh in the bitmap
    form and the build's dpos in the positions form."""
    calls = _count_passes(monkeypatch)
    words = np.random.default_rng(3).integers(0, 2**32, size=(300, 3), dtype=np.uint32) \
        & np.uint32(0x00FF0F0F)
    rids = np.random.default_rng(4).permutation(300).astype(np.uint32)
    lengths = np.full(300, 12, np.int32)
    rks = RKeySet(words=words[:255], lengths=lengths[:255], rids=rids[:255])
    drks = RKeySet(words=words[255:], lengths=lengths[255:], rids=rids[255:])
    tks = keyset_from_numpy(words[:255], lengths[:255], rids[:255])
    dtks = keyset_from_numpy(words[255:], lengths[255:], rids[255:])
    rpipe = RPipeline(backend="jnp")
    rprev = rpipe.run(rks)
    pipe = ReconstructionPipeline(backend="cuda", device="cpu")
    prev = pipe.run(tks)
    _assert_same(prev, rprev)
    wc = int(prev.comp_sorted.shape[1])
    assert calls == {"bitmap": [(255, 3), (255, wc)], "positions": [(255, wc)]}

    rmeta = RM.meta_from_keys(words)
    meta = meta_from_numpy(rmeta.dbitmap, rmeta.varbitmap, rmeta.refkey, rmeta.n_words)
    keep = np.random.default_rng(1).random(255) < 0.8
    ref, _ = rpipe.run_incremental(rpipe.run(rks, meta=rmeta), rks, drks, keep_rows=keep,
                                   meta=rmeta)
    prev = pipe.run(tks, meta=meta)
    calls["bitmap"].clear()
    calls["positions"].clear()
    res, folded = pipe.run_incremental(prev, tks, dtks, keep_rows=keep, meta=meta)
    assert res.stats["incremental"] is True
    _assert_same(res, ref)
    wc = int(res.comp_sorted.shape[1])
    assert calls == {"bitmap": [(folded.n, wc)], "positions": [(folded.n, wc)]}


# ---------------------------------------------------------------------------
# a numpy model of the kernel's lanes
# ---------------------------------------------------------------------------

#: threads a block of the kernel (csrc/dbit.cu)
_THREADS = 256


def _clz(x: np.ndarray) -> np.ndarray:
    """Leading zeros of nonzero 32-bit values, exactly (frexp)."""
    return 32 - np.frexp(x.astype(np.float64))[1]


def _kernel_model(words: np.ndarray):
    """The dbit kernel's lanes in numpy: (n, W) sorted keys -> ((n-1,)
    positions, (W,) bitmap).  A warp takes the 32 pairs from ``first`` on:
    lane ``l`` holds row ``first + 1 + l``'s first sector; the previous row
    comes from the lane before (``shfl_up``) or, for lane 0, the halo row
    ``first``; rows equal over a sector walk on, both rows a sector a step;
    lane ``l`` stores pair ``first + l``."""
    n, w = words.shape
    keys = words.astype(np.int64)
    lane = np.arange(32)
    warps_per_block = _THREADS // 32
    n_blocks = -(-(-(-n // 32)) // warps_per_block)
    pos_out = np.full(max(n - 1, 0), -1, np.int64)
    bitmap = np.zeros(w, np.uint32)

    def load(rows, word, live):
        out = np.zeros((32, SECTOR_WORDS), np.int64)
        for i in range(min(SECTOR_WORDS, w - word)):
            out[live, i] = keys[rows[live], word + i]
        return out

    def sector_dbit(cur, prev, word):
        pos = np.full(32, NO_DBIT, np.int64)
        for i in range(SECTOR_WORDS - 1, -1, -1):
            x = cur[:, i] ^ prev[:, i]
            pos = np.where(x != 0, 32 * (word + i) + _clz(np.maximum(x, 1)), pos)
        return pos

    for block in range(n_blocks):
        s_bits = np.zeros(w, np.uint32)
        for warp in range(block * warps_per_block, (block + 1) * warps_per_block):
            first = warp * 32
            r = first + 1 + lane
            pair = r < n
            cur = load(r, 0, pair)
            halo = load(np.full(32, first), 0, (lane == 0) & (first < n))
            prev = np.where((lane == 0)[:, None], halo, cur[np.maximum(lane - 1, 0)])
            pos = sector_dbit(cur, prev, 0)
            open_ = pair & (pos == NO_DBIT) & (SECTOR_WORDS < w)
            base = SECTOR_WORDS
            while open_.any():
                p = sector_dbit(load(r, base, open_), load(r - 1, base, open_), base)
                pos = np.where(open_ & (p != NO_DBIT), p, pos)
                open_ = open_ & (p == NO_DBIT) & (base + SECTOR_WORDS < w)
                base += SECTOR_WORDS
            for p in pos[pair & (pos != NO_DBIT)].tolist():
                s_bits[p // 32] |= np.uint32(1 << (31 - p % 32))
            pos_out[r[pair] - 1] = pos[pair]
        bitmap |= s_bits
    return pos_out, bitmap


#: widths of the model cases: the refresh's 4-word run, odd widths, one
#: and two sectors, full keys (the walk past the first sector), a word
#: past a whole sector, one word and 128 words
_MODEL_WIDTHS = [4, 3, 8, 16, 17, 33, 1, 128]


@pytest.mark.parametrize("w", _MODEL_WIDTHS)
@pytest.mark.parametrize("tiles", [3, 4, 5])
def test_kernel_model_matches_reference(w, tiles):
    """2^k - 1, 2^k and 2^k + 1 tiles (blocks) of rows: equal pairs and
    pairs that differ only in the last word straddle warp and tile edges,
    where the halo row is read."""
    rows_per_block = _THREADS  # a lane a pair
    n = tiles * rows_per_block + 1  # pairs fill the tiles
    words = _sorted_keys(n, w, "masked", seed=tiles)
    if w > 1:
        for edge in range(1, tiles):  # equal pairs on both sides of a tile's halo row
            words[edge * rows_per_block] = words[edge * rows_per_block - 1]
            words[edge * rows_per_block + 1] = words[edge * rows_per_block]
        words[rows_per_block + 8:rows_per_block + 40, :-1] = words[rows_per_block + 7, :-1]
        words = words[np.lexsort(words.T[::-1])]
    want = np.asarray(r_adjacent(jnp.asarray(words)))
    pos, bits = _kernel_model(words)
    np.testing.assert_array_equal(pos, want)
    np.testing.assert_array_equal(bits, _fold(want, w))
    assert (want == NO_DBIT).any() and (want != NO_DBIT).any()
