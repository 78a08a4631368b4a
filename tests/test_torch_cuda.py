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
    before = cudalib.LAUNCHES["probe_many"]
    found, rid = cuda.lookup_many(arena.stacked, queries, n_valid)
    assert cudalib.LAUNCHES["probe_many"] == before + 1
    singles = []
    for t in range(3):
        qt = queries[t].clone()
        qt[n_valid[t]:] = 0xFFFFFFFF
        singles.append(cuda.lookup(trees[arena.slots[t]], qt))
    assert leaf_key_gathers == []
    f_ref, r_ref = get_backend("torch", device=dev).lookup_many(arena.stacked, queries, n_valid)
    assert len(leaf_key_gathers) == 1  # the plain stage does gather them
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    for t, (f1, r1) in enumerate(singles):
        assert torch.equal(found[t], f1) and torch.equal(rid[t], r1)
    assert bool(found[0].any()) and not bool(found[0].all())


def test_explicit_flush_engine_on_the_card(dev):
    reg, kss, _ = _arena(dev)
    eng = MultiTenantEngine(reg, get_backend("cuda", device=dev), auto_dispatch=False)
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
    assert cudalib.LAUNCHES["probe_many"] == before + 1
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
