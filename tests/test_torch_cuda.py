"""The port's CUDA kernels against their plain-PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no GPU is present (decided inside the fixture, at run time).
This file imports no JAX, so it runs on a machine with only PyTorch and
the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import compute_dbitmap, sort_words_keyed  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.snapshot import SnapshotCell  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data.synthetic import rows_to_keyset  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import (  # noqa: E402
    gather_windows, gather_windows_plain, pk_windows, pk_windows_plain)
from repro_torch.kernels.dbit import (  # noqa: E402
    adjacent_dbitmap, adjacent_dbitmap_plain, adjacent_dbits, adjacent_dbits_plain)
from repro_torch.core import btree  # noqa: E402
from repro_torch.core.btree import _as_stack  # noqa: E402
from repro_torch.kernels.lookup import (  # noqa: E402
    leaf_stage,
    leaf_stage_many,
    leaf_stage_many_plain,
    probe,
    probe_many,
    probe_many_plain,
    probe_plain,
)
from repro_torch.kernels.lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.lookup.ref import leaf_arena, member_tree  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
from repro_torch.kernels.pext.ops import pext_segments  # noqa: E402
from repro_torch.serve import MultiTenantEngine, TenantRegistry  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The GPU, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _keys(seed, n, w, mask=0xFFFFFFFF):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


@pytest.mark.parametrize("n,w", [(5003, 3), (300, 128), (4099, 16)])
def test_pext_kernel_matches_plain(dev, n, w):
    words = to_carrier(_keys(n, n, w, 0x0F0F0F0F), dev)
    plan = make_plan(to_u32(compute_dbitmap(words)), w)
    before = cudalib.LAUNCHES["pext"]
    assert torch.equal(pext(words, plan), pext_plain(words, plan))
    assert cudalib.LAUNCHES["pext"] == before + 1


#: plans at the segment compiler's edges: name -> (kept bit positions, W)
_PLAN_EDGES = {
    "one_bit": ([77], 4),
    "32_bits": (list(range(0, 64, 2)), 4),
    "33_bits": (list(range(5, 38)), 3),
    "straddling_bytes": (list(range(3, 33)) + list(range(40, 46)), 2),
    "every_bit_of_a_word": ([1, 2] + list(range(32, 64)), 3),
    "every_bit_of_128_words": (list(range(128 * 32)), 128),
}


@pytest.mark.parametrize("name", sorted(_PLAN_EDGES))
def test_pext_kernel_on_plan_edges(dev, name):
    positions, w = _PLAN_EDGES[name]
    bm = np.zeros(w, np.uint32)
    for p in positions:
        bm[p // 32] |= np.uint32(1 << (31 - p % 32))
    plan = make_plan(bm, w)
    words = to_carrier(_keys(len(positions), 4099, w), dev)
    got = pext(words, plan)
    assert torch.equal(got, pext_plain(words, plan))
    assert torch.equal(got, pext_segments(words, plan))


def _bitonic_keys(kind, n, w, seed):
    if kind == "dup":
        return np.repeat(_keys(seed, -(-n // 4), w, 0xFF), 4, axis=0)[:n]
    if kind == "ones":  # every key ties with the pad sentinel
        return np.full((n, w), 0xFFFFFFFF, np.uint32)
    if kind == "prefix":  # keys differ in the last word only
        keys = np.zeros((n, w), np.uint32)
        keys[:, -1] = _keys(seed, n, 1, 0xFF)[:, 0]
        return keys
    return _keys(seed, n, w)


@pytest.mark.parametrize("w", [1, 2, 4, 5, 8, 16, 23, 24, 64, 110, 111, 128])
def test_bitonic_kernel_matches_plain(dev, w):
    """Register widths (1-8, 16) and the shared-memory kernel (the rest, up
    to 128 words, with tie-breaks from device memory past the words that
    fit); blocks of 64, 512 and 2048 rows; n of 1, block - 1, block,
    block + 1 and 2^12 +- 1; duplicate, all-ones, random keys and keys that
    differ in the last word only."""
    for block in (64, 512, 2048):
        for n in sorted({1, block - 1, block, block + 1, 4095, 4097}):
            for kind in ("dup", "ones", "prefix", "rand"):
                words = to_carrier(_bitonic_keys(kind, n, w, n * w + block), dev)
                rows = torch.randperm(n, device=dev)
                got, want = block_sort(words, rows, block), block_sort_plain(words, rows, block)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                    (w, block, n, kind)


@pytest.mark.parametrize("pk", [1, 16, 32])
def test_pk_window_and_probe_kernels_match_plain(dev, pk):
    m, w = 4096, 16
    rng = np.random.default_rng(pk)
    words = to_carrier(_keys(pk, m, w), dev)
    starts = torch.as_tensor(np.concatenate([
        rng.integers(-40, w * 32 + 40, size=m // 2),
        32 * rng.integers(0, w, size=m // 4),
        w * 32 - 1 - rng.integers(0, 32, size=m // 4),
    ]), device=dev)
    assert torch.equal(pk_windows(words, starts, pk), pk_windows_plain(words, starts, pk))
    node = torch.randint(0, 256, (256,), device=dev)
    node[:128] = torch.arange(128, device=dev)  # these queries meet their own windows
    dpos = starts.reshape(256, 16) - 1
    leaf_pk = pk_windows_plain(words[:256].repeat_interleave(16, 0), starts, pk).reshape(256, 16)
    q = words[:256]
    got = probe(q, node, dpos, leaf_pk, pk)
    assert torch.equal(got, probe_plain(q, node, dpos, leaf_pk, pk))
    assert bool(got[:128].all())


def _window_starts(rng, m, w):
    """Starts at random, on word boundaries (sh == 0), in the last word and
    outside the key (clipped)."""
    top = w * 32
    return np.concatenate([rng.integers(-40, top + 40, size=m - m // 2),
                           32 * rng.integers(0, w, size=m // 4),
                           top - 1 - rng.integers(0, 32, size=m // 2 - m // 4)])


@pytest.mark.parametrize("w", [1, 3, 4, 16, 33, 128])
def test_pk_window_gather_and_index_forms_match_plain(dev, w):
    """The leaf form gathers rows and takes their windows in one pass
    (16-byte chunks for even widths on an aligned table, 8-byte words
    otherwise, rows of 128 words across warps); the index form windows
    ``words[rows]`` without gathering.  Row ids repeat; pk 1, 16 and 32."""
    rng = np.random.default_rng(w)
    n, m = 3001, 5000
    table = to_carrier(_keys(w, n, w), dev)
    st = torch.as_tensor(rng.permutation(_window_starts(rng, m, w)), device=dev)
    for tb in (table, table[1:]):  # aligned, and off 16 bytes for odd widths
        rows = torch.as_tensor(rng.integers(0, tb.shape[0], size=m), device=dev)
        for pk in (1, 16, 32):
            before = cudalib.LAUNCHES["pk_window"]
            full, win = gather_windows(tb, rows, st, pk)
            want_full, want_win = gather_windows_plain(tb, rows, st, pk)
            assert torch.equal(full, want_full) and torch.equal(win, want_win), (w, pk)
            assert torch.equal(full, tb[rows])
            got = pk_windows(tb, st, pk, rows)
            assert torch.equal(got, pk_windows_plain(tb, st, pk, rows)), (w, pk)
            assert torch.equal(got, win)
            assert cudalib.LAUNCHES["pk_window"] == before + 2


def test_full_key_run_of_wide_keys_on_the_card(dev):
    """23-word full keys (92 bytes) and the reference's widest, 512-byte
    keys (128 words, past what a 512-row block holds in shared memory) sort
    on the card as on the plain backend, through the bitonic kernel."""
    rng = np.random.default_rng(1)
    for width in (92, 512):
        ks = rows_to_keyset(rng.integers(97, 100, size=(700, width), dtype=np.uint8))
        before = cudalib.LAUNCHES["bitonic_block_sort"]
        got = ReconstructionPipeline(backend="cuda", device=dev).run(ks, full_keys=True)
        assert cudalib.LAUNCHES["bitonic_block_sort"] > before
        want = ReconstructionPipeline(backend="torch", device=dev).run(ks, full_keys=True)
        assert torch.equal(got.comp_sorted, want.comp_sorted)
        assert torch.equal(got.row_sorted, want.row_sorted)


def test_cuda_backend_matches_torch_backend_on_the_card(dev, leaf_key_gathers):
    buf = np.random.default_rng(0).integers(97, 123, size=(3000, 64), dtype=np.uint8)
    ks = rows_to_keyset(buf)
    cudalib.reset_launches()
    cuda_pipe = ReconstructionPipeline(backend="cuda", device=dev)
    got = cuda_pipe.run(ks)
    queries = to_carrier(np.concatenate([ks.words[::7], ks.words[::11] ^ np.uint32(1)]), dev)
    found, rid = cuda_pipe.backend.lookup(got.tree, queries)
    # every kernel of the unchunked run and its lookup (no merge below the
    # chunk threshold)
    on_path = ("pext", "bitonic_block_sort", "pk_window", "probe", "dbit")
    assert all(cudalib.LAUNCHES[name] > 0 for name in on_path), cudalib.LAUNCHES
    # the build's dpos in the positions form; meta_from_keys and the
    # refresh in the bitmap form
    assert cudalib.LAUNCHES_BY_FORM["dbit"] == {"positions": 1, "bitmap": 2}
    assert leaf_key_gathers == []  # the leaf stage ran in the kernel
    assert cudalib.LAUNCHES["merge_rank"] == 0
    want = ReconstructionPipeline(backend="torch", device=dev).run(ks)
    assert torch.equal(got.comp_sorted, want.comp_sorted)
    assert torch.equal(got.rid_sorted, want.rid_sorted)
    for key, val in want.tree.leaf.items():
        assert torch.equal(got.tree.leaf[key], val), key
    assert len(got.tree.levels) == len(want.tree.levels) >= 1
    for g, r in zip(got.tree.levels, want.tree.levels):
        for key, val in r.items():
            assert torch.equal(g[key], val), key
    assert torch.equal(got.tree.sorted_full, want.tree.sorted_full)
    np.testing.assert_array_equal(got.meta.dbitmap, want.meta.dbitmap)
    f_ref, r_ref = get_backend("torch", device=dev).lookup(want.tree, queries)
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    assert bool(found.any()) and not bool(found.all())


def _sorted_run(seed, n, w, mask, row_base):
    """An ascending (key, row) run with distinct rows, as carriers on the host."""
    keys = to_carrier(_keys(seed, n, w, mask), "cpu")
    rows = row_base + torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    keys, rows = sort_words_keyed(keys, rows)
    return keys, rows


#: (n_q, n_s, W, key mask) of the merge-rank cases
_RANK_CASES = [
    (1000, 4097, 3, 0x0F0F),  # n_q not a multiple of 256, n_s = 2^k + 1
    (300, 1, 2, 0xFF),  # n_s = 1
    (257, 4095, 4, 0x3),  # duplicate keys: ties fall to the row word
    (129, 300, 128, 0x1),  # 128-word keys
    (2000, 300001, 4, 0xFFFFFFFF),  # windows past the staging buffer: sampled
    (3000, 20000, 9, 0x1),  # 9-word keys: ties on the 8 staged words
    (1500, 100000, 16, 0x3),  # 16-word keys, sampled windows and ties
]


@pytest.mark.parametrize("n_q,n_s,w,mask", _RANK_CASES)
def test_merge_rank_kernel_matches_plain(dev, n_q, n_s, w, mask):
    ks, rs = _sorted_run(n_s, n_s, w, mask, 0)
    kq, rq = _sorted_run(n_q, n_q, w, mask, n_s)
    ks, rs, kq, rq = (t.to(dev) for t in (ks, rs, kq, rq))
    before = cudalib.LAUNCHES["merge_rank"]
    assert torch.equal(merge_ranks(kq, rq, ks, rs), merge_ranks_plain(kq, rq, ks, rs))
    assert cudalib.LAUNCHES["merge_rank"] == before + 1


@pytest.mark.parametrize("n_q,n_s,w,mask", _RANK_CASES)
@pytest.mark.parametrize("order", ["shuffled", "one_tile"])
def test_merge_rank_kernel_exact_on_unsorted_queries(dev, n_q, n_s, w, mask, order):
    """Queries out of order: every tile (or only the first) searches the
    whole run per query; the rest stage their windows."""
    ks, rs = _sorted_run(n_s, n_s, w, mask, 0)
    kq, rq = _sorted_run(n_q, n_q, w, mask, n_s)
    perm = torch.randperm(n_q, generator=torch.Generator().manual_seed(n_q))
    if order == "one_tile":
        head = perm[perm < 256]
        perm = torch.arange(n_q)
        perm[: head.numel()] = head
    ks, rs, kq, rq = (t.to(dev) for t in (ks, rs, kq[perm], rq[perm]))
    assert torch.equal(merge_ranks(kq, rq, ks, rs), merge_ranks_plain(kq, rq, ks, rs))


def test_merge_rank_kernel_on_pad_rows(dev):
    """All-ones keys against pad rows from both reserved ranges, and empty
    runs, which launch nothing."""
    ones = torch.full((600, 2), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    ar = torch.arange(300, device=dev)
    rs = torch.cat([ar, plancache.ROW_PAD_A + ar])
    rq = torch.cat([ar[:100] + 300, plancache.ROW_PAD_B + ar[:200]])
    assert torch.equal(merge_ranks(ones[:300], rq, ones, rs),
                       merge_ranks_plain(ones[:300], rq, ones, rs))
    before = cudalib.LAUNCHES["merge_rank"]
    assert merge_ranks(ones[:0], rq[:0], ones, rs).shape == (0,)
    assert torch.equal(merge_ranks(ones[:5], rq[:5], ones[:0], rs[:0]),
                       torch.zeros(5, dtype=torch.int32, device=dev))
    assert cudalib.LAUNCHES["merge_rank"] == before


@pytest.mark.parametrize("n,w", [(5000, 3), (300, 128), (2, 1)])
def test_dbit_kernel_matches_plain(dev, n, w):
    keys = torch.sort(to_carrier(_keys(n, n, w, 0x0000FF0F), "cpu"), dim=0).values
    keys[n // 2] = keys[n // 2 - 1]  # an equal pair
    if n > 4:
        keys[3] = keys[2]
        keys[3, -1] ^= 1  # a difference only in the last bit of the last word
    keys = keys.to(dev)
    got = adjacent_dbits(keys)
    assert torch.equal(got, adjacent_dbits_plain(keys))
    if n > 4:
        assert int(got[2]) == 32 * w - 1


def _dbit_runs(seed, n, w):
    """Sorted runs of n rows of w words, as carriers on the host: masked
    random keys with an equal pair, keys that differ only in the last word
    (every other pair equal, every fourth differing in its last bit), and
    one key repeated."""
    keys = torch.sort(to_carrier(_keys(seed, n, w, 0x0000FF0F), "cpu"), dim=0).values
    keys = sort_words_keyed(keys, torch.arange(n))[0]
    keys[n // 2] = keys[n // 2 - 1]
    last = torch.zeros((n, w), dtype=torch.int64)
    last[:, -1] = torch.arange(n) // 2
    same = to_carrier(np.broadcast_to(_keys(seed, 1, w), (n, w)), "cpu")
    return {"masked": keys, "last_word": last, "all_equal": same}


#: run lengths around the tile edges: a block takes 256 pairs
_DBIT_ROWS = [2, 3, 255, 256, 257, 258, 511, 512, 513, 1025, 3 * 1024 - 1, 4097]


@pytest.mark.parametrize("w", [1, 2, 3, 4, 16, 17, 33, 128])
def test_dbit_kernel_forms_match_plain_across_tile_edges(dev, w):
    """Both forms against their plain versions on runs of 2^k +- 1 rows
    across the tile edges, in place and in a run that starts off 16
    bytes."""
    for n in _DBIT_ROWS:
        for kind, keys in _dbit_runs(n, n, w).items():
            flat = torch.cat([torch.zeros(1, dtype=torch.int64), keys.reshape(-1)]).to(dev)
            for run in (keys.to(dev), flat[1:].view(n, w)):
                before = dict(cudalib.LAUNCHES_BY_FORM["dbit"])
                got_pos, got_bits = adjacent_dbits(run), adjacent_dbitmap(run)
                what = f"n={n} W={w} {kind}"
                assert torch.equal(got_pos, adjacent_dbits_plain(run)), what
                assert torch.equal(got_bits, adjacent_dbitmap_plain(run)), what
                assert cudalib.LAUNCHES_BY_FORM["dbit"] == {
                    form: count + 1 for form, count in before.items()}
    before = cudalib.LAUNCHES["dbit"]
    one = torch.zeros((1, w), dtype=torch.int64, device=dev)
    assert adjacent_dbits(one).shape == (0,)
    assert torch.equal(adjacent_dbitmap(one), torch.zeros(w, dtype=torch.int64, device=dev))
    assert cudalib.LAUNCHES["dbit"] == before


def test_chunked_run_on_the_card_equals_unchunked(dev):
    buf = np.random.default_rng(5).integers(97, 123, size=(10000, 32), dtype=np.uint8)
    ks = rows_to_keyset(buf)
    cudalib.reset_launches()
    chunked = ReconstructionPipeline(backend="cuda", device=dev, chunk_threshold=4096,
                                     chunk_size=1024).run(ks)
    assert cudalib.LAUNCHES["merge_rank"] == chunked.stats["cascade_merges"] == 9
    # meta_from_keys and the refresh (bitmap form), the build (positions)
    assert cudalib.LAUNCHES["dbit"] == 3
    assert cudalib.LAUNCHES_BY_FORM["dbit"] == {"positions": 1, "bitmap": 2}
    mono = ReconstructionPipeline(backend="cuda", device=dev).run(ks)
    for name in ("comp_sorted", "row_sorted", "rid_sorted"):
        assert torch.equal(getattr(chunked, name), getattr(mono, name)), name
    for key, val in mono.tree.leaf.items():
        assert torch.equal(chunked.tree.leaf[key], val), key
    np.testing.assert_array_equal(chunked.meta.dbitmap, mono.meta.dbitmap)


@pytest.mark.parametrize("pk", [1, 16, 32])
@pytest.mark.parametrize("t,t_cap", [(1, 1), (3, 4)])
def test_probe_many_kernel_matches_plain(dev, pk, t, t_cap):
    """T = 1 and a partial arena; q * lc = 1212, not a multiple of 256;
    windows starting on word boundaries and in the last word; all-ones
    (dead-lane) queries.  Each tenant's row equals the single-tree probe."""
    rng = np.random.default_rng(pk + t)
    q, w, n_leaves, lc = 101, 16, 300, 12
    queries = to_carrier(_keys(pk, t * q, w), dev).reshape(t, q, w)
    queries[:, -7:] = 0xFFFFFFFF
    dpos = np.concatenate([
        32 * rng.integers(0, w, size=t_cap * n_leaves * lc // 3) - 1,
        w * 32 - 2 - rng.integers(0, 32, size=t_cap * n_leaves * lc // 3),
    ])
    dpos = np.concatenate([dpos, rng.integers(0, w * 32, size=t_cap * n_leaves * lc - dpos.size)])
    leaf_dpos = torch.as_tensor(rng.permutation(dpos).reshape(t_cap, n_leaves, lc), device=dev)
    node = torch.as_tensor(rng.integers(0, n_leaves, size=(t, q)), device=dev)
    leaf_pk = to_carrier(_keys(pk + 1, t_cap * n_leaves, lc, (1 << pk) - 1), dev)
    leaf_pk = leaf_pk.reshape(t_cap, n_leaves, lc)
    for ti in range(t):  # about half the queries meet their leaf's stored windows
        rows = node[ti, : q // 2]
        leaf_pk[ti, rows] = pk_windows_plain(queries[ti, : q // 2].repeat_interleave(lc, 0),
                                             leaf_dpos[ti, rows].reshape(-1) + 1,
                                             pk).reshape(-1, lc)
    before = cudalib.LAUNCHES["probe_many"]
    got = probe_many(queries, node, leaf_dpos, leaf_pk, pk)
    assert cudalib.LAUNCHES["probe_many"] == before + 1
    assert torch.equal(got, probe_many_plain(queries, node, leaf_dpos, leaf_pk, pk))
    for ti in range(t):
        assert torch.equal(got[ti], probe(queries[ti], node[ti], leaf_dpos[ti], leaf_pk[ti], pk))
    assert bool(got.any()) and not bool(got.all())


@pytest.mark.parametrize("w", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("pk", [1, 16, 32])
@pytest.mark.parametrize("t,t_cap,lc", [(1, 1, 12), (3, 4, 14)])
def test_probe_kernel_forms_match_plain(dev, w, pk, t, t_cap, lc):
    """Both forms of the lane-group kernel, tenant-major and single-tree,
    against their plain versions on leaves shaped as the build makes them
    (``kernels.lookup.ref.leaf_arena``): T = 1 and a partial arena, 301
    queries (not a multiple of a block's 16), keys of 1 to 128 words (the
    window's second word in the next 16-word chunk, the full compare over
    several chunks), starts on word boundaries and in the last word, a
    last leaf with lanes past n, duplicate and all-ones keys, queries one
    bit off a key; pk 1 gives many candidates a query."""
    arena, queries, node = leaf_arena(w * 100 + pk + t, t, t_cap, 40, lc, w, pk, 301, dev)
    leaf = arena.leaf
    before = dict(cudalib.LAUNCHES)
    mask = probe_many(queries, node, leaf["dpos"], leaf["pk"], pk)
    assert torch.equal(mask, probe_many_plain(queries, node, leaf["dpos"], leaf["pk"], pk))
    found, rid = leaf_stage_many(arena, node, queries)
    f_ref, r_ref = leaf_stage_many_plain(arena, node, queries)
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    assert cudalib.LAUNCHES["probe_many"] == before["probe_many"] + 2
    for ti in range(t):
        member = member_tree(arena, ti)
        got = probe(queries[ti], node[ti], member.leaf["dpos"], member.leaf["pk"], pk)
        assert torch.equal(got, mask[ti])
        assert torch.equal(got, probe_plain(queries[ti], node[ti], member.leaf["dpos"],
                                            member.leaf["pk"], pk))
        one, nd, qs = _as_stack(member), node[ti : ti + 1], queries[ti : ti + 1]
        f1, r1 = leaf_stage(one, nd, qs)
        f2, r2 = leaf_stage_many_plain(one, nd, qs)
        assert torch.equal(f1, f2) and torch.equal(r1, r2)
        assert torch.equal(f1[0], found[ti]) and torch.equal(r1[0], rid[ti])
    assert cudalib.LAUNCHES["probe"] == before["probe"] + 2 * t
    assert bool(found.any()) and not bool(found.all())


def test_probe_kernel_wrappers_refuse_what_the_kernel_does_not_take(dev):
    arena, queries, node = leaf_arena(0, 2, 2, 4, 12, 4, 16, 32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        leaf_stage_many(arena, node, queries[:, ::2])
    with pytest.raises(TypeError, match="dtype"):
        probe_many(queries, node.to(torch.int32), arena.leaf["dpos"], arena.leaf["pk"], 16)
    wide = dataclasses.replace(arena, leaf={k: torch.cat([v, v], dim=2).contiguous()
                                            for k, v in arena.leaf.items()})
    with pytest.raises(ValueError, match="16 lanes"):
        leaf_stage_many(wide, node, queries)


@pytest.fixture
def leaf_key_gathers(monkeypatch):
    """Counts the plain leaf stage's gathers of every lane's full key."""
    calls = []
    orig = btree._leaf_keys_many

    def spy(*args):
        calls.append(args[1].shape)
        return orig(*args)

    monkeypatch.setattr(btree, "_leaf_keys_many", spy)
    monkeypatch.setattr(lookup_ops, "_leaf_keys_many", spy)
    return calls


def _arena(dev, n_tenants=3, n=3000):
    """``n_tenants`` same-size 64-byte keysets built on the card, published
    into a registry: (registry, {tenant: keyset}, {tenant: tree})."""
    reg, kss, trees = TenantRegistry(), {}, {}
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    for t in range(n_tenants):
        buf = np.random.default_rng(10 + t).integers(97, 123, size=(n, 64), dtype=np.uint8)
        ks = rows_to_keyset(buf)
        cell = SnapshotCell()
        trees[t] = pipe.run(ks, publish_to=cell).tree
        kss[t] = ks
        reg.publish(t, cell)
    return reg, kss, trees


def test_cuda_lookup_many_matches_torch_on_the_card(dev, leaf_key_gathers):
    """Three tenants in capacity 4, one ragged: one kernel launch, equal to
    the plain backend's lookup_many and, per tenant, to the single-tree
    ``"cuda"`` lookup of the same (dead-lane-normalized) queries; neither
    ``"cuda"`` path gathers the leaves' full keys."""
    reg, kss, trees = _arena(dev)
    arena = reg.arena_of(0)
    assert arena.capacity == 4
    q = np.stack([np.concatenate([kss[t].words[::30], kss[t].words[1::30] ^ np.uint32(1)])
                  for t in range(3)])
    n_valid = [q.shape[1], q.shape[1] - 17, 5]
    queries = to_carrier(q, dev)
    cuda = get_backend("cuda", device=dev)
    plancache.reset_cache()
    before = cudalib.LAUNCHES["probe_many"]
    # the first call traces (the eager run) and replays its new graph
    found, rid = cuda.lookup_many(arena.stacked, queries, n_valid)
    assert cudalib.LAUNCHES["probe_many"] == before + 2
    f2, r2 = cuda.lookup_many(arena.stacked, queries, n_valid)
    assert cudalib.LAUNCHES["probe_many"] == before + 3
    assert torch.equal(f2, found) and torch.equal(r2, rid)
    singles = []
    for t in range(3):
        qt = queries[t].clone()
        qt[n_valid[t]:] = 0xFFFFFFFF
        singles.append(cuda.lookup(trees[arena.slots[t]], qt))
    assert leaf_key_gathers == []
    f_ref, r_ref = get_backend("torch", device=dev).lookup_many(arena.stacked, queries, n_valid)
    # the plain stage does gather them: in its trace and in its capture
    assert len(leaf_key_gathers) == 2
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    for t, (f1, r1) in enumerate(singles):
        assert torch.equal(found[t], f1) and torch.equal(rid[t], r1)
    assert bool(found[0].any()) and not bool(found[0].all())


def test_explicit_flush_engine_on_the_card(dev):
    reg, kss, _ = _arena(dev)
    eng = MultiTenantEngine(reg, get_backend("cuda", device=dev), auto_dispatch=False)
    plancache.reset_cache()
    out = {}

    def ask(t):
        out[t] = eng.submit(t, kss[t].words[:50])

    threads = [threading.Thread(target=ask, args=(t,)) for t in range(3)]
    for th in threads:
        th.start()
    deadline = time.perf_counter() + 30
    while eng.stats()["pending"] < 3:
        assert time.perf_counter() < deadline and all(th.is_alive() for th in threads)
        time.sleep(0.001)
    before = cudalib.LAUNCHES["probe_many"]
    assert eng.flush() == 3
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads) and sorted(out) == [0, 1, 2]
    assert eng.stats()["n_dispatches"] == 1
    # one dispatch: its program's trace (the eager run) and first replay
    assert cudalib.LAUNCHES["probe_many"] == before + 2
    for t in range(3):
        found, rid, epoch = out[t]
        assert found.all() and epoch == 0
        np.testing.assert_array_equal(rid, kss[t].rids[:50])
    eng.shutdown()


# ---------------------------------------------------------------------------
# batched reconstruction (run_many) and the online index on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [256, 512, 1024])
@pytest.mark.parametrize("k", [3, 4, 5])
def test_stacked_bitonic_launch_equals_member_sorts(dev, b, k):
    """The stacked form ``run_many`` launches: k members of b rows, each
    rounded up to whole 512-row blocks with all-ones keys and rows past
    the pipeline's pad rows, sorted by one launch, equal the plain
    network run on each member alone: no block straddles two members."""
    n_pad = -(-b // 512) * 512
    keys = torch.cat([plancache.pad_tail(to_carrier(_keys(b + k + i, b, 2, 0x000F000F), dev),
                                         n_pad, plancache.SENTINEL) for i in range(k)])
    rows = torch.cat([plancache.iota(b, dev),
                      plancache.ROW_PAD_B + plancache.iota(n_pad, dev)[b:]]).repeat(k)
    before = cudalib.LAUNCHES["bitonic_block_sort"]
    got_k, got_r = block_sort(keys, rows, block=512)
    assert cudalib.LAUNCHES["bitonic_block_sort"] == before + 1
    for i in range(k):
        part = slice(i * n_pad, (i + 1) * n_pad)
        want_k, want_r = block_sort_plain(keys[part], rows[part], 512)
        assert torch.equal(got_k[part], want_k) and torch.equal(got_r[part], want_r)
        assert bool((got_r[part][b:] >= plancache.ROW_PAD_B).all())  # extras last


@pytest.mark.parametrize("b", [256, 1024])
def test_cuda_batched_extract_sort_equals_torch(dev, b):
    """The pext kernel once per member and one bitonic launch over the
    stack give the ``"torch"`` backend's runtime-bitmap extract and keyed
    sort, member by member, pads last."""
    k = 3
    words_np = [_keys(60 + i, b - 5 * i, 3, 0x00FF0F0F) for i in range(k)]
    bitmap = to_u32(compute_dbitmap(to_carrier(np.concatenate(words_np), dev)))
    plan = make_plan(bitmap, 3)
    words = torch.stack([plancache.pad_tail(to_carrier(x, dev), b, plancache.SENTINEL)
                         for x in words_np])
    rows = torch.stack([torch.cat([plancache.iota(x.shape[0], dev),
                                   plancache.ROW_PAD_A + plancache.iota(b - x.shape[0], dev)])
                        for x in words_np])
    bitmaps = to_carrier(np.stack([bitmap] * k), dev)
    before = dict(cudalib.LAUNCHES)
    got = get_backend("cuda", device=dev).batched_extract_sort(words, bitmaps, rows, [plan] * k)
    assert cudalib.LAUNCHES["pext"] == before["pext"] + k
    assert cudalib.LAUNCHES["bitonic_block_sort"] == before["bitonic_block_sort"] + 1
    want = get_backend("torch", device=dev).batched_extract_sort(words, bitmaps, rows,
                                                                 [plan] * k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1][1:, -5:] >= plancache.ROW_PAD_A).all())  # member 0 has no pads


def _results_match(got, want):
    for name in ("comp_sorted", "row_sorted", "rid_sorted"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for key, val in want.tree.leaf.items():
        assert torch.equal(got.tree.leaf[key], val), key
    for g, r in zip(got.tree.levels, want.tree.levels):
        for key, val in r.items():
            assert torch.equal(g[key], val), key
    assert torch.equal(got.tree.sorted_full, want.tree.sorted_full)
    for field in ("dbitmap", "varbitmap", "refkey"):
        np.testing.assert_array_equal(getattr(got.meta, field), getattr(want.meta, field))


def test_run_many_on_the_card_equals_single_runs_and_torch(dev):
    rng = np.random.default_rng(3)
    sets = [rows_to_keyset(rng.integers(97, 123, size=(n, 16), dtype=np.uint8))
            for n in (3000, 2900, 2500, 700)]
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    cudalib.reset_launches()
    got = pipe.run_many(sets)
    # three batched members and one of another bucket through run
    assert cudalib.LAUNCHES["pext"] == 4 and cudalib.LAUNCHES["bitonic_block_sort"] == 2
    assert [r.stats.get("batched") for r in got] == [3, 3, 3, None]
    want = ReconstructionPipeline(backend="torch", device=dev).run_many(sets)
    for ks, g, w in zip(sets, got, want):
        _results_match(g, w)
        _results_match(g, pipe.run(ks))


def test_online_index_on_the_card_equals_torch(dev):
    """Inserts, deletes, searches and the rebuild of a few thousand keys:
    the ``"cuda"`` index equals the ``"torch"`` one, meta after every
    mutation included."""
    from repro_torch.core.index import OnlineIndex

    rng = np.random.default_rng(4)
    ks = rows_to_keyset(np.unique(rng.integers(97, 123, size=(4000, 16), dtype=np.uint8),
                                  axis=0))
    fresh = rows_to_keyset(rng.integers(97, 123, size=(300, 16), dtype=np.uint8)).words
    idx = {name: OnlineIndex.build(ks, backend=name, device=dev) for name in ("cuda", "torch")}
    before = cudalib.LAUNCHES["probe"]
    for i, key in enumerate(fresh):
        for oi in idx.values():
            oi.insert(key, 100_000 + i)
        np.testing.assert_array_equal(idx["cuda"].meta.dbitmap, idx["torch"].meta.dbitmap)
    for key in list(ks.words[::40]) + list(fresh[::7]):
        assert idx["cuda"].delete(key) == idx["torch"].delete(key)
    assert cudalib.LAUNCHES["probe"] > before  # the deletes' searches
    queries = np.concatenate([ks.words[::13], fresh, fresh ^ np.uint32(1)])
    got, want = idx["cuda"].search_batch(queries), idx["torch"].search_batch(queries)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].any() and not got[0].all()
    rebuilt = {name: oi.rebuild() for name, oi in idx.items()}
    _results_match(rebuilt["cuda"].result, rebuilt["torch"].result)
    full = ReconstructionPipeline(backend="cuda", device=dev).run(
        rebuilt["cuda"].keyset, meta=idx["cuda"].meta)
    for name in ("comp_sorted", "row_sorted", "rid_sorted"):
        assert torch.equal(getattr(rebuilt["cuda"].result, name), getattr(full, name))


def test_insert_rule_rank_kernel_with_duplicate_keys(dev):
    """The replica's insert rule on the card: the merge-rank kernel ranks
    queries (row 0) in a run of sorted keys with many repeats, each with
    its row id, and must give the reference's strict-key rank (zero rows
    on both sides), queries equal to run keys, below and above it
    included."""
    from repro_torch.core.dbits import rank_in_sorted_keyed, sort_words_keyed

    rng = np.random.default_rng(6)
    for n, w in ((5000, 3), (1, 16), (700, 16)):
        keys = to_carrier(rng.integers(0, 8, size=(n, w), dtype=np.uint32), dev)
        run, rows = sort_words_keyed(keys, torch.randperm(n, device=dev))
        q = torch.cat([run[torch.randint(0, n, (900,), device=dev)],
                       to_carrier(rng.integers(0, 9, size=(300, w), dtype=np.uint32), dev)])
        zq = torch.zeros((q.shape[0],), dtype=torch.int64, device=dev)
        before = cudalib.LAUNCHES["merge_rank"]
        got = merge_ranks(q, zq, run, rows)
        assert cudalib.LAUNCHES["merge_rank"] == before + 1
        want = rank_in_sorted_keyed(run, torch.zeros_like(rows), q, zq)
        assert torch.equal(got, want)


def test_replica_on_the_card_equals_torch(dev):
    """A ``"cuda"`` replica and a ``"torch"`` one take the same batches —
    duplicates of live keys and deletes, a key with a new distinction bit
    (the fallback), two batches through ``apply_many`` — and hold the same
    state and answers after each; the ``"cuda"`` insert rule launches the
    merge-rank and dbit kernels."""
    from repro_torch.replication import ChangeLog, Replica

    rng = np.random.default_rng(8)
    ks = rows_to_keyset(np.unique(rng.integers(97, 123, size=(6000, 16), dtype=np.uint8),
                                  axis=0))
    reps = {name: Replica(ks, backend=name, device=dev) for name in ("cuda", "torch")}
    lsn = 0

    def batch(n_ins, n_del, new_bit=False):
        nonlocal lsn
        cur = reps["torch"].keyset
        log = ChangeLog(cur.n_words, start_lsn=lsn)
        ins = cur.words[rng.integers(0, cur.n, n_ins)].copy()
        if new_bit:
            ins[:, -1] |= np.uint32(0x80)
        log.append_inserts(ins, 50_000 + lsn + np.arange(n_ins))
        log.append_deletes(rng.choice(cur.rids, n_del, replace=False))
        lsn = log.next_lsn
        return log

    queries = ks.words[::7]
    for step, kind in enumerate(("apply", "apply", "new_bit", "many")):
        rank0, dbit0 = cudalib.LAUNCHES["merge_rank"], cudalib.LAUNCHES["dbit"]
        if kind == "many":
            logs = [batch(40, 10), batch(30, 5)]
            stats = {name: rep.apply_many(logs) for name, rep in reps.items()}
        else:
            log = batch(50, 20, new_bit=kind == "new_bit")
            stats = {name: rep.apply(log) for name, rep in reps.items()}
        assert cudalib.LAUNCHES["merge_rank"] > rank0 and cudalib.LAUNCHES["dbit"] > dbit0
        assert stats["cuda"]["fallback"] == stats["torch"]["fallback"]
        assert (stats["cuda"]["fallback"] == "dbitmap_changed") == (kind == "new_bit")
        a, b = reps["cuda"], reps["torch"]
        for field in ("dbitmap", "varbitmap", "refkey"):
            np.testing.assert_array_equal(getattr(a.meta, field), getattr(b.meta, field))
        _results_match(a.result, b.result)
        got, want = a.search_batch(queries), b.search_batch(queries)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_pager_on_the_card_equals_torch(dev):
    """A ``"cuda"`` pager and a ``"torch"`` one take the same fill and
    churn rounds (free, partial re-fill, re-alloc of a mapped slot,
    rebuild) and agree after each: table, free list, working meta, last
    rebuild, index byte for byte, and a get of every mapped page."""
    from repro_torch.serve.pager import PagedKVManager

    pagers = {name: PagedKVManager(n_pages=8192, page_tokens=16, backend=name, device=dev)
              for name in ("cuda", "torch")}
    rng = np.random.default_rng(9)
    for pm in pagers.values():
        for s in range(200):
            pm.pages_for(s, 16 * 32)
    before = dict(cudalib.LAUNCHES)
    for r in range(5):
        if r:
            victim, back = int(rng.integers(0, 200)), int(rng.integers(1, 33))
            mapped = [k for k in pagers["cuda"]._table if k[0] != victim]
            slot = mapped[int(rng.integers(0, len(mapped)))]
            for pm in pagers.values():
                pm.free_seq(victim)
                pm.pages_for(victim, 16 * back)
                pm.alloc(*slot)
        for pm in pagers.values():
            pm.rebuild_index()
        a, b = pagers["cuda"], pagers["torch"]
        assert list(a._table.items()) == list(b._table.items()) and a._free == b._free
        assert a.stats["last_rebuild"] == b.stats["last_rebuild"]
        for field in ("dbitmap", "varbitmap", "refkey"):
            np.testing.assert_array_equal(getattr(a._meta, field), getattr(b._meta, field))
        _results_match(a._index, b._index)
        keys = np.asarray(list(a._table), np.uint32)
        found, rid = a.lookup_batch(np.concatenate([keys, [[200, 0]]]))
        assert found[:-1].all() and not found[-1]
        np.testing.assert_array_equal(rid[:-1], np.fromiter(a._table.values(), np.uint32))
    for name in ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"):
        assert cudalib.LAUNCHES[name] > before[name], name


def test_run_load_on_the_card(dev):
    """A short closed-loop run on ``"cuda"``: readers racing incremental
    rebuilds, no torn read, no stale epoch, no error; the lookups launch
    the probe kernel."""
    from repro_torch.serve.loadgen import run_load

    before = cudalib.LAUNCHES["probe"]
    rep = run_load(backend="cuda", device=dev, n_keys=16384, n_words=2, batch=256,
                   n_readers=4, duration_s=1.0, mutation_batch=64, seed=0)
    assert rep.errors == []
    assert rep.torn_reads == 0 and rep.stale_epochs == 0
    assert rep.n_requests > 0 and rep.epochs_published >= 3
    st = rep.cell_stats
    assert st["acquires"] == st["releases"] and st["pinned"] == 0
    assert cudalib.LAUNCHES["probe"] > before


# ---------------------------------------------------------------------------
# the plan cache's lookup graphs
# ---------------------------------------------------------------------------


def _zipf_like(seed, n, width=64):
    return rows_to_keyset(np.random.default_rng(seed).integers(97, 123, size=(n, width),
                                                               dtype=np.uint8))


def _lookup_program(b, w, backend="cuda"):
    return plancache.get_cache().programs[("lookup", backend, b, w)]


def _eager(prog, tree, queries, dev):
    """The program's body run eagerly on the card, on the padded batch."""
    q = int(queries.shape[0])
    b = plancache.bucket_for("lookup", q)
    qp = plancache.pad_tail(queries, b, 0xFFFFFFFF)
    found, rid = prog.body(tree, qp, torch.tensor(q, device=dev))
    return found[:q], rid[:q]


def _churn(ks, rng, k):
    """Delete ``k`` rows and insert ``k`` redrawn keys: n, and so the tree's
    geometry, stays the same."""
    from repro_torch.core.keyformat import KeySet

    keep = np.ones(ks.n, bool)
    keep[rng.choice(ks.n, size=k, replace=False)] = False
    words = rng.integers(97, 123, size=(k, ks.n_words * 4), dtype=np.uint8)
    delta = rows_to_keyset(words)
    delta = KeySet(words=delta.words, lengths=delta.lengths,
                   rids=np.arange(10**6, 10**6 + k, dtype=np.uint32))
    return keep, delta


def test_lookup_graph_replays_equal_eager_across_epochs(dev):
    """Two same-geometry epochs of run_incremental: each is a tree copy into
    the graph's buffers, no trace, and the replay answers as the program's
    body run eagerly and as the plain backend."""
    ks = _zipf_like(40, 4000)
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    prev = pipe.run(ks)
    queries = to_carrier(np.concatenate([ks.words[::20], ks.words[1::20] ^ np.uint32(1)]), dev)
    plancache.reset_cache()
    found, rid = pipe.backend.lookup(prev.tree, queries)
    prog = _lookup_program(plancache.bucket_for("lookup", int(queries.shape[0])), 16)
    assert prog.captured and prog.captures == 1
    f_e, r_e = _eager(prog, prev.tree, queries, dev)
    assert torch.equal(found, f_e) and torch.equal(rid, r_e)
    plain = get_backend("torch", device=dev)
    plain.lookup(prev.tree, queries)  # the plain backend's own program, traced once
    rng, base = np.random.default_rng(41), ks
    lookups_traced = plancache.cache_stats()["per_op"]["lookup"]["traces"]
    for epoch in range(2):
        keep, delta = _churn(base, rng, 40)
        prev, base = pipe.run_incremental(prev, base, delta, keep_rows=keep)
        copies = prog.tree_copies
        found, rid = pipe.backend.lookup(prev.tree, queries)
        assert prog.tree_copies == copies + 1 and prog.captures == 1
        f_e, r_e = _eager(prog, prev.tree, queries, dev)
        f_t, r_t = plain.lookup(prev.tree, queries)
        assert torch.equal(found, f_e) and torch.equal(rid, r_e), epoch
        assert torch.equal(found, f_t) and torch.equal(rid, r_t), epoch
    assert plancache.cache_stats()["per_op"]["lookup"]["traces"] == lookups_traced


def test_lookup_graph_never_trusts_a_reused_address(dev):
    """A tree is freed and another of the same shapes lands at its very
    addresses (its arrays are written into the freed tree's storage): the
    graph goes by the tree object, not by address, so it copies the new
    tree in and answers the new tree's rids."""
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    ks_a, ks_b = _zipf_like(50, 3000), _zipf_like(51, 3000)
    queries = to_carrier(np.concatenate([ks_a.words[:100], ks_b.words[:100]]), dev)
    plancache.reset_cache()
    tree_a, tree_b = pipe.run(ks_a).tree, pipe.run(ks_b).tree
    f_a, _ = pipe.backend.lookup(tree_a, queries)
    assert bool(f_a[:100].all())
    prog = _lookup_program(256, 16)
    moved = dataclasses.replace(tree_a)
    for dst, src in zip(plancache._tree_tensors(moved), plancache._tree_tensors(tree_b)):
        dst.copy_(src)
    ptrs = [t.data_ptr() for t in plancache._tree_tensors(tree_a)]
    del tree_a
    assert [t.data_ptr() for t in plancache._tree_tensors(moved)] == ptrs
    captures, copies = prog.captures, prog.tree_copies
    f_b, r_b = pipe.backend.lookup(moved, queries)
    assert prog.captures == captures and prog.tree_copies == copies + 1
    f_t, r_t = get_backend("torch", device=dev).lookup(tree_b, queries)
    assert torch.equal(f_b, f_t) and torch.equal(r_b, r_t)
    assert bool(f_b[100:].all())
    np.testing.assert_array_equal(to_u32(r_b[100:]), ks_b.rids[:100])


def test_lookup_graph_readers_beside_a_capturing_writer(dev):
    """Eight reader threads replay the lookup graph of their pinned epoch
    while a writer publishes same-geometry epochs and one of a new
    geometry, capturing its graph: every answer is its epoch's."""
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    plain = get_backend("torch", device=dev)
    sets = [_zipf_like(60 + i, 3000) for i in range(3)] + [_zipf_like(70, 3500)]
    queries = to_carrier(np.concatenate([s.words[:64] for s in sets]), dev)
    trees = [pipe.run(s).tree for s in sets]
    want = [tuple(x.cpu() for x in plain.lookup(t, queries)) for t in trees]
    plancache.reset_cache()
    cell = SnapshotCell()
    published, results = [], {}  # the results stay alive, so ids stay unique

    def publish(i):
        res = pipe.run(sets[i])
        published.append(res)
        results[id(res.tree)] = i
        cell.publish(res)

    publish(0)
    pipe.backend.lookup(cell.current.tree, queries)
    stop = threading.Event()
    errors, served = [], [0] * 8

    def reader(k):
        try:
            while not stop.is_set():
                pin = cell.acquire()
                try:
                    f, r = pipe.backend.lookup(pin.tree, queries)
                    i = results[id(pin.tree)]
                finally:
                    pin.release()
                if not (torch.equal(f.cpu(), want[i][0]) and torch.equal(r.cpu(), want[i][1])):
                    errors.append(f"reader {k}: wrong answers for set {i}")
                served[k] += 1
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    try:
        for i in (1, 2, 3, 0):
            time.sleep(0.3)
            publish(i)
            # the writer captures the new geometry's graph itself
            pipe.backend.lookup(cell.current.tree, queries)
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert errors == [], errors[:3]
    assert all(n > 0 for n in served)
    assert plancache.get_cache().captures >= 2  # two geometries


def test_lookup_graph_captures_beside_a_timed_rebuild(dev):
    """One thread captures lookup graphs (two trees of different geometry
    taken in turn, so every round captures again) while another runs
    ``ReconstructionPipeline.run`` with its per-stage waits, both at once,
    for a fixed number of rounds and with no lock: every answer and every
    rebuilt tree equals a serial run's.  A device-wide synchronize in the
    rebuild would invalidate the captures."""
    rounds = 8
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    sets = [_zipf_like(90, 3000), _zipf_like(91, 3500)]
    ks_r = _zipf_like(92, 20000)
    queries = to_carrier(np.concatenate([s.words[:200] for s in sets]), dev)
    trees = [pipe.run(s).tree for s in sets]
    plancache.reset_cache()
    want = [tuple(x.cpu() for x in pipe.backend.lookup(t, queries)) for t in trees]
    want_tree = {k: v.cpu() for k, v in _tree_dict(pipe.run(ks_r).tree).items()}
    prog = _lookup_program(plancache.bucket_for("lookup", int(queries.shape[0])), 16)
    captures = prog.captures
    start = threading.Barrier(2)
    errors, done = [], {"capture": 0, "rebuild": 0}

    def capturer():
        try:
            start.wait()
            for i in range(rounds):
                f, r = pipe.backend.lookup(trees[i % 2], queries)
                if not (torch.equal(f.cpu(), want[i % 2][0])
                        and torch.equal(r.cpu(), want[i % 2][1])):
                    errors.append(f"capture round {i}: wrong answers")
                done["capture"] += 1
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    def rebuilder():
        try:
            rebuild = ReconstructionPipeline(backend="cuda", device=dev)
            start.wait()
            for i in range(rounds):
                got = _tree_dict(rebuild.run(ks_r).tree)
                if any(not torch.equal(got[k].cpu(), v) for k, v in want_tree.items()):
                    errors.append(f"rebuild round {i}: a different tree")
                done["rebuild"] += 1
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=capturer), threading.Thread(target=rebuilder)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert errors == [], errors[:3]
    assert done == {"capture": rounds, "rebuild": rounds}
    assert prog.captures == captures + rounds


def _tree_dict(tree) -> dict:
    return {str(i): t for i, t in enumerate(plancache._tree_tensors(tree))}


def test_evicted_lookup_graph_frees_its_pool(dev):
    """An LRU-evicted lookup graph and a reset cache give back every byte
    their buffers and pools held."""
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    ks = _zipf_like(80, 50_000)
    tree = pipe.run(ks).tree
    small = to_carrier(ks.words[:200], dev)
    large = to_carrier(ks.words[:400], dev)
    torch.cuda.synchronize(dev)
    with plancache.scoped_cache(plancache.PlanCache()) as alone:
        pipe.backend.lookup(tree, large)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        alone.reset()
        torch.cuda.synchronize(dev)
        large_bytes = base - torch.cuda.memory_allocated(dev)
    assert large_bytes > 6_400_000  # at least the copy of sorted_full
    m0 = torch.cuda.memory_allocated(dev)
    cache = plancache.PlanCache(max_programs=1)
    with plancache.scoped_cache(cache):
        pipe.backend.lookup(tree, small)
        first = next(iter(cache.programs.values()))
        assert first.captured and torch.cuda.memory_allocated(dev) > m0
        pipe.backend.lookup(tree, large)  # another bucket: evicts the first
        assert cache.evictions == 1 and not first.captured
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev) - m0
        assert abs(held - large_bytes) <= large_bytes // 100, (held, large_bytes)
        assert cache.graph_stats()["graphs"] == 1
        cache.reset()
        torch.cuda.synchronize(dev)
        assert torch.cuda.memory_allocated(dev) == m0


def test_lookup_graph_replays_count_their_launches(dev):
    """A replay runs kernels Python never calls: the graph adds the
    launches its capture recorded, one probe launch per lookup."""
    pipe = ReconstructionPipeline(backend="cuda", device=dev)
    ks = _zipf_like(90, 3000)
    tree = pipe.run(ks).tree
    queries = to_carrier(ks.words[:300], dev)
    plancache.reset_cache()
    cudalib.reset_launches()
    pipe.backend.lookup(tree, queries)  # trace + capture + first replay
    assert cudalib.LAUNCHES["probe"] == 2
    prog = _lookup_program(512, 16)
    assert prog.replay_launches == ({"probe": 1}, {})
    assert prog.pool_bytes > 0 and prog.buffer_bytes > tree.sorted_full.numel() * 8
    for _ in range(3):
        pipe.backend.lookup(tree, queries)
    assert cudalib.LAUNCHES["probe"] == 5
    assert plancache.get_cache().replays == 4


# ---------------------------------------------------------------------------
# the distributed backend: one rank, and a gloo group sharing the card
# ---------------------------------------------------------------------------


def _dist_keysets():
    """A base keyset, its delta, a delete mask, queries and two tenants."""
    from repro_torch.core.keyformat import KeySet

    def ks(seed, n, rid0=0):
        words = _keys(seed, n, 3, 0x00FF0F0F)
        return KeySet(words=words, lengths=np.full(n, 12, np.int32),
                      rids=np.arange(rid0, rid0 + n, dtype=np.uint32))

    base = ks(1, 6000)
    rng = np.random.default_rng(2)
    queries = np.concatenate([base.words[rng.integers(0, 6000, 300)],
                              base.words[rng.integers(0, 6000, 100)] ^ np.uint32(1)])
    return base, ks(3, 500, 10_000), rng.random(6000) >= 0.05, queries, [ks(4, 900), ks(5, 900)]


def _dist_work(dev, backend, opts=None):
    """run, run_incremental, the lookups and run_many on one backend: every
    output as numpy."""
    from repro_torch.convert import result_to_numpy
    from repro_torch.core.btree import stack_trees

    base, delta, keep, queries, tenants = _dist_keysets()
    pipe = ReconstructionPipeline(backend=backend, device=dev, backend_opts=opts)
    res = pipe.run(base)
    inc, _ = pipe.run_incremental(res, base, delta, keep_rows=keep)
    found, rid = pipe.backend.lookup(res.tree, to_carrier(queries, dev))
    trees = [pipe.run(t).tree for t in tenants]
    qs = np.stack([queries[:200], queries[200:]])
    f_m, r_m = pipe.backend.lookup_many(stack_trees(trees), to_carrier(qs, dev))
    many = pipe.run_many(tenants)
    return {"run": result_to_numpy(res), "incremental": result_to_numpy(inc),
            "lookup": [found.cpu().numpy(), to_u32(rid)],
            "lookup_many": [f_m.cpu().numpy(), to_u32(r_m)],
            "run_many": [result_to_numpy(r) for r in many]}


def _gloo_rank_on_the_card(rank, p):
    dev = torch.device("cuda", torch.cuda.current_device())
    cudalib.reset_launches()
    out = _dist_work(dev, "distributed")
    return out, dict(cudalib.LAUNCHES)


def _assert_nested_equal(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_nested_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_nested_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def test_distributed_one_rank_on_the_card_equals_cuda(dev):
    """At p = 1 every stage runs on the local ``"cuda"`` backend: the
    outputs equal ``"cuda"``'s and its kernels launch."""
    want = _dist_work(dev, "cuda")
    cudalib.reset_launches()
    got = _dist_work(dev, "distributed")
    _assert_nested_equal(got, want)
    for name in ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe",
                 "probe_many"):
        assert cudalib.LAUNCHES[name] > 0, name


def test_two_rank_gloo_group_on_the_card_equals_cuda(dev):
    """Two gloo ranks share the card: the sample sort, the routed merge and
    lookup, and the tenant and batch shards equal ``"cuda"``'s outputs on
    both ranks, and every kernel launched on the ranks."""
    from repro_torch.tools.rankgroup import run_group

    want = _dist_work(dev, "cuda")
    ranks = run_group(_gloo_rank_on_the_card, 2, timeout=120.0, deadline=600.0)
    for out, _ in ranks:
        _assert_nested_equal(out, want)
    for name in ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe",
                 "probe_many"):
        assert all(launches[name] > 0 for _, launches in ranks), name


# ---------------------------------------------------------------------------
# the LM serving path on the card against the port on the CPU
# ---------------------------------------------------------------------------

#: card against host, as a fraction of the host logits' scale (max |x|):
#: f32 products differ only in their summation order
LM_F32_TOL = 1e-4
#: at bf16 each path rounds its products' outputs in its own order
LM_BF16_TOL = 5e-2


def _lm_inputs(cfg, seed=0, b=2, t=32):
    rng = np.random.default_rng(seed)
    pre, dec = {}, {"pos": t}
    if cfg.embed_input:
        pre["tokens"] = rng.integers(0, cfg.vocab_size, (b, t))
        dec["token"] = rng.integers(0, cfg.vocab_size, (b,))
    else:
        pre["frames"] = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
        dec["frame"] = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        pre["img_embeds"] = dec["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return pre, dec


def _lm_close(got, want, tol, what):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), what
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} > {tol} x {scale}"


#: every arch at f32; at bf16 all but jamba and xlstm, whose recurrent
#: states amplify rounding past any useful bound
_LM_ARCHS = ("llama3-8b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b", "xlstm-1.3b",
             "llama-3.2-vision-90b", "musicgen-large", "llama4-scout-17b-a16e", "granite-34b",
             "minitron-4b", "internlm2-20b")
_LM_CASES = [(name, "float32") for name in _LM_ARCHS] + [
    (name, "bfloat16") for name in _LM_ARCHS if name not in ("jamba-v0.1-52b", "xlstm-1.3b")]


@pytest.mark.parametrize("name,dtype", _LM_CASES)
def test_reduced_lm_on_the_card_equals_the_host(dev, name, dtype):
    """Each reduced arch's prefill and decode step on the card, from the
    host's parameters, against the same on the host: logits and caches."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import LM

    td = getattr(torch, dtype)
    tol = LM_F32_TOL if td == torch.float32 else LM_BF16_TOL
    cfg = ARCHS[name].reduced()
    host = LM(cfg, compute_dtype=td, device="cpu")
    params = host.init(torch.Generator().manual_seed(0))
    card = LM(cfg, compute_dtype=td, device=dev)
    card_params = card.prepare(params)
    pre, dec = _lm_inputs(cfg)
    outs = []
    for model, p in ((host, params), (card, card_params)):
        cache, logits = model.prefill(p, pre, model.init_cache(2, 40))
        cache, logits2 = model.decode_step(p, cache, dec)
        outs.append((logits, logits2, cache))
    (h1, h2, hc), (c1, c2, cc) = outs
    _lm_close(c1, h1, tol, f"{name} prefill")
    _lm_close(c2, h2, tol, f"{name} decode")
    for i in hc:
        for k in hc[i]:
            _lm_close(cc[i][k], hc[i][k], tol, f"{name} cache {i}.{k}")


def test_engine_on_the_card_equals_the_host(dev):
    """``ServeEngine`` on the card (``"cuda"`` pager) and on the host give
    the same greedy tokens, page table, journal and restarts, and every
    page get answers alike; the card's restarts launch the kernels."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import LM
    from repro_torch.serve import ServeEngine

    cfg = ARCHS["llama3-8b"].reduced()
    host = LM(cfg, compute_dtype=torch.float32, device="cpu")
    params = host.init(torch.Generator().manual_seed(1))
    card = LM(cfg, compute_dtype=torch.float32, device=dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    runs = {}
    cudalib.reset_launches()
    for model, p, backend in ((host, params, "torch"), (card, card.prepare(params), "cuda")):
        eng = ServeEngine(model, p, max_seq=64, batch_size=2, page_tokens=16, backend=backend,
                          device=model.device)
        tokens = eng.generate(prompts, 8)
        st1 = eng.restart()
        eng.pager.free_seq(1)
        eng.pager.pages_for(1, 24)
        st2 = eng.restart()
        gets = [eng.lookup_page(s, q) for s in range(3) for q in range(5)]
        runs[backend] = (tokens, list(eng.pager._table.items()),
                         [{k: st[k] for k in ("index_height", "incremental",
                                              "log_entries_replayed")} for st in (st1, st2)],
                         gets)
    want, got = runs["torch"], runs["cuda"]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert want[2][1]["incremental"] is True
    for name in ("pext", "bitonic_block_sort", "merge_rank", "pk_window", "dbit", "probe"):
        assert cudalib.LAUNCHES[name] > 0, name


def test_launch_serve_runs_on_the_card(dev):
    """``python -m repro_torch.launch.serve --arch llama3-8b --reduced``
    runs on the GPU, with no device named."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "llama3-8b", "--reduced"], capture_output=True, text=True, env=env,
                         cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr
    assert torch.cuda.get_device_name(0) in out.stdout
    assert "generated (4, 32) tokens" in out.stdout and "restart (index rebuild)" in out.stdout


# ---------------------------------------------------------------------------
# the training path on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_reduced_loss_and_gradients_on_the_card_equal_the_host(dev, name):
    """``LM.loss`` and every master leaf's gradient on the card, from the
    host's f32 parameters, against the same on the host at f32."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import LM
    from repro_torch.train.optim import tree_leaves, tree_map

    cfg = ARCHS[name].reduced()
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
    host = LM(cfg, compute_dtype=torch.float32, device="cpu")
    params = host.init_master(torch.Generator().manual_seed(0))
    card = LM(cfg, compute_dtype=torch.float32, device=dev)
    outs = []
    for model, p in ((host, params), (card, tree_map(lambda t: t.to(dev), params))):
        flat = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss, metrics = model.loss(p, batch)
        outs.append((loss, metrics, torch.autograd.grad(loss, flat)))
    (hl, hm, hg), (cl, cm, cg) = outs
    _lm_close(cl, hl, LM_F32_TOL, f"{name} loss")
    for k in hm:
        _lm_close(cm[k], hm[k], LM_F32_TOL, f"{name} {k}")
    for i, (c, h) in enumerate(zip(cg, hg)):
        _lm_close(c, h, 1e-3, f"{name} grad {i}")


def test_token_pipeline_on_the_card_equals_torch(dev):
    """``shuffle_order``, ``dedup_tokens`` and the batches on ``"cuda"``
    (pext, bitonic and dbit launched) equal ``"torch"`` on the card and
    numpy's order and first occurrences."""
    from repro_torch.data import pipeline
    from repro_torch.data.synthetic import lm_tokens

    n = 100_003
    cudalib.reset_launches()
    got = pipeline.shuffle_order(n, 5, backend="cuda", device=dev)
    for name in ("pext", "bitonic_block_sort", "dbit"):
        assert cudalib.LAUNCHES[name] > 0, name
    assert torch.equal(got, pipeline.shuffle_order(n, 5, backend="torch", device=dev))
    doc = np.arange(n, dtype=np.uint32)
    key = to_u32(pipeline._fnv1a_vec(to_carrier(doc, dev), 5))
    np.testing.assert_array_equal(got.cpu().numpy(), np.lexsort((doc, key)))
    docs = lm_tokens(4096, 129, 128256, seed=2)
    rng = np.random.default_rng(2)
    docs[rng.permutation(4096)[:512]] = docs[rng.integers(0, 4096, 512)]
    kept = pipeline.dedup_tokens(docs, backend="cuda", device=dev)
    assert torch.equal(kept, pipeline.dedup_tokens(docs, backend="torch", device=dev))
    np.testing.assert_array_equal(kept.cpu().numpy(),
                                  np.sort(np.unique(docs, axis=0, return_index=True)[1]))
    pipe = pipeline.TokenPipeline(docs, 8, 128, seed=1, device=dev)
    twin = pipeline.TokenPipeline(docs, 8, 128, seed=1, backend="torch", device=dev)
    for step in (0, 511, 512, 700):
        for k, v in pipe.batch_at(step).items():
            assert v.device.type == "cuda" and torch.equal(v, twin.batch_at(step)[k])


def test_train_state_checkpoint_from_the_card(dev, tmp_path):
    """A train state on the card (f32 master leaves, an int32 step, a bf16
    leaf) saves as host arrays and restores byte for byte, through the
    manifest index rebuilt on ``"cuda"``."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.train.optim import adamw_init, tree_leaves

    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"embed": torch.randn((64, 16), generator=gen, device=dev),
              "blocks": {"0": {"ln": torch.ones((2, 16), device=dev),
                               "w": torch.randn((2, 16, 16), generator=gen, device=dev).to(
                                   torch.bfloat16)}}}
    state = (params, adamw_init(params))
    save_checkpoint(tmp_path, 5, state, extra_meta={"step": 5}, device=dev)
    cudalib.reset_launches()
    back, stats = restore_checkpoint(tmp_path, 5, state, device=dev, index_device=dev)
    assert stats["index_backend"] == "cuda" and cudalib.LAUNCHES["probe"] > 0
    for a, b in zip(tree_leaves({"p": back[0], "o": back[1]}),
                    tree_leaves({"p": state[0], "o": state[1]})):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_runs_and_resumes_on_the_card(dev, tmp_path):
    """``repro_torch.launch.train`` with no device named trains on the GPU
    and resumes from its checkpoint."""
    from repro_torch.launch.train import main

    common = ["--arch", "llama3-8b", "--reduced", "--batch", "4", "--seq", "32",
              "--ckpt-dir", str(tmp_path), "--log-every", "5"]
    first = main(common + ["--steps", "10", "--ckpt-every", "5"])
    assert next(iter(first["params"]["blocks"]["0"].values())).device.type == "cuda"
    second = main(common + ["--steps", "15", "--ckpt-every", "5"])
    assert second["restored"]["meta"]["step"] == 10
    assert sorted(second["losses"]) == list(range(11, 16))
    assert all(np.isfinite(v) for v in second["losses"].values())


#: remat against no remat on the card: the forward is the same ops, so the
#: losses agree to the bit; the backward's atomic sums (the embedding's
#: rows, the MoE combine's gathers) may add in another order, so each
#: gradient is held within this share of its leaf's largest magnitude
REMAT_GRAD_TOL = 1e-5


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-235b-a22b"])
def test_remat_on_the_card_equals_no_remat_and_holds_less(dev, name):
    """Reduced llama3-8b and qwen3-moe (``sort`` dispatch) at four
    superblocks and 4 x 256 tokens: the loss and every gradient with remat
    against the same without it, from one start, and the peak memory of
    the loss and its gradients lower with remat."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import LM
    from repro_torch.train.optim import tree_leaves

    cfg = dataclasses.replace(ARCHS[name].reduced(), dispatch_mode="sort",
                              n_layers=4 * len(ARCHS[name].pattern))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32)}
    outs = {}
    for remat in (True, False):
        model = LM(cfg, compute_dtype=torch.float32, device=dev, remat=remat)
        params = model.init_master(torch.Generator(device=dev).manual_seed(0))
        flat = [t.requires_grad_(True) for t in tree_leaves(params)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        outs[remat] = (loss.detach(), grads, torch.cuda.max_memory_allocated(dev) - base)
    (l_on, g_on, peak_on), (l_off, g_off, peak_off) = outs[True], outs[False]
    assert torch.equal(l_on, l_off)
    for i, (a, b) in enumerate(zip(g_on, g_off)):
        _lm_close(a, b, REMAT_GRAD_TOL, f"{name} grad {i}")
    assert peak_on < peak_off, (peak_on, peak_off)


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def test_sharded_step_on_the_card_matches_one_rank(dev):
    """The reduced llama3-8b's step at accum 1 and 2 (each from the same
    start, f32 compute) on four ranks sharing the card, threads of the
    threaded group on a (2, 2) ("data", "model") mesh: the loss within
    1e-5 relative and the parameters within 2e-5 of one rank's step (the
    bounds ``tests/test_torch_mesh.py`` holds the CPU's ranks to)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.launch.shardings import batch_shardings, params_shardings, place
    from repro_torch.models.lm import LM
    from repro_torch.tools.rankgroup import run_threads
    from repro_torch.train.optim import OptConfig, adamw_init, tree_map
    from repro_torch.train.trainstep import make_train_step

    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), model.init_master(torch.Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (4, 32))).to(dev) for k in ("tokens", "labels")}
    cfg = OptConfig(warmup_steps=10, decay_steps=50)
    want = {}
    for accum in (1, 2):
        params = tree_map(lambda t: t.to(dev), host)
        p, _, m = make_train_step(model, cfg, accum=accum)(params, adamw_init(params), batch)
        want[accum] = (float(m["loss"]), [t.cpu() for _, t in _flat_leaves(p)])

    def rank_fn(rank, p):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        p_sh = params_shardings(mesh, host)
        out = {}
        for accum in (1, 2):
            params = place(tree_map(lambda t: t.to(dev), host), p_sh)
            step = make_train_step(model, cfg, accum=accum, param_shardings=p_sh)
            with use_mesh(mesh):
                params, _, m = step(params, adamw_init(params), place(batch, batch_shardings(mesh, batch)))
            out[accum] = (float(m["loss"]), [t.full_tensor().cpu() for _, t in _flat_leaves(params)])
        return out

    got = run_threads(rank_fn, 4)
    for accum in (1, 2):
        for r in range(4):
            loss, leaves = got[r][accum]
            assert abs(loss - want[accum][0]) <= 1e-5 * abs(want[accum][0]), (r, accum)
            for a, b in zip(leaves, want[accum][1]):
                torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_elastic_restore_on_the_card(dev, tmp_path):
    """A checkpoint saved from one rank restores onto a (2, 2) mesh of four
    ranks sharing the card, each rebuilding the manifest index on
    ``"cuda"``: every leaf equal to the bit, on the placements the rules
    give, and the probe kernel's leaf stage launched."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.sharding import param_spec, to_placements
    from repro_torch.launch.shardings import guard_spec, params_shardings
    from repro_torch.models.lm import LM
    from repro_torch.tools.rankgroup import run_threads

    model = LM(ARCHS["llama3-8b"].reduced(), device=dev)
    params = model.init_master(torch.Generator(device=dev).manual_seed(1))
    save_checkpoint(tmp_path, 3, params, device=dev)
    cudalib.reset_launches()

    # the four threads rebuild their indexes and capture their lookup
    # graphs at once, with no lock
    def rank_fn(rank, p):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        got, stats = restore_checkpoint(tmp_path, 3, params, backend="cuda",
                                        shardings=params_shardings(mesh, params))
        assert stats["index_backend"] == "cuda"
        for (path, a), (_, b) in zip(_flat_leaves(got), _flat_leaves(params)):
            assert torch.equal(a.full_tensor(), b), path
            spec = guard_spec(mesh, param_spec(path, b), tuple(b.shape))
            assert tuple(a.placements) == to_placements(mesh, spec, b.dim()), path
        return True

    assert run_threads(rank_fn, 4) == [True] * 4
    assert cudalib.LAUNCHES["probe"] > 0
