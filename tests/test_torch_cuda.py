"""The port's CUDA kernels against their plain-PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no GPU is present (decided inside the fixture, at run time).
This file imports no JAX, so it runs on a machine with only PyTorch and
the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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
from repro_torch.kernels.build import pk_windows, pk_windows_plain  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits, adjacent_dbits_plain  # noqa: E402
from repro_torch.kernels.lookup import probe, probe_many, probe_many_plain, probe_plain  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
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


@pytest.mark.parametrize("kind,n,w", [("dup", 4173, 4), ("ones", 1000, 2), ("rand", 5000, 16)])
def test_bitonic_kernel_matches_plain(dev, kind, n, w):
    if kind == "dup":
        keys = np.repeat(_keys(n, -(-n // 4), w, 0xFF), 4, axis=0)[:n]
    elif kind == "ones":
        keys = np.full((n, w), 0xFFFFFFFF, np.uint32)
    else:
        keys = _keys(n, n, w)
    words = to_carrier(keys, dev)
    rows = torch.randperm(n, device=dev)
    got, want = block_sort(words, rows), block_sort_plain(words, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def test_full_key_run_of_wide_keys_on_the_card(dev):
    """23-word full keys, the widest whose 512-row block fits the kernel's
    shared memory, sort as on the plain backend; 128-word full keys do not
    fit, and the sort raises instead of launching."""
    rng = np.random.default_rng(1)
    ks = rows_to_keyset(rng.integers(97, 100, size=(700, 92), dtype=np.uint8))
    got = ReconstructionPipeline(backend="cuda", device=dev).run(ks, full_keys=True)
    want = ReconstructionPipeline(backend="torch", device=dev).run(ks, full_keys=True)
    assert torch.equal(got.comp_sorted, want.comp_sorted)
    assert torch.equal(got.row_sorted, want.row_sorted)
    wide = rows_to_keyset(rng.integers(97, 100, size=(700, 512), dtype=np.uint8))
    before = cudalib.LAUNCHES["bitonic_block_sort"]
    with pytest.raises(ValueError, match="shared memory"):
        ReconstructionPipeline(backend="cuda", device=dev).run(wide, full_keys=True)
    assert cudalib.LAUNCHES["bitonic_block_sort"] == before


def test_cuda_backend_matches_torch_backend_on_the_card(dev):
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
    assert cudalib.LAUNCHES["merge_rank"] == 0
    want = ReconstructionPipeline(backend="torch", device=dev).run(ks)
    assert torch.equal(got.comp_sorted, want.comp_sorted)
    assert torch.equal(got.rid_sorted, want.rid_sorted)
    for key, val in want.tree.leaf.items():
        assert torch.equal(got.tree.leaf[key], val), key
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


@pytest.mark.parametrize("n_q,n_s,w,mask", [
    (1000, 4097, 3, 0x0F0F),  # n_q not a multiple of 256, n_s = 2^k + 1
    (300, 1, 2, 0xFF),  # n_s = 1
    (257, 4095, 4, 0x3),  # duplicate keys: ties fall to the row word
    (129, 300, 128, 0x1),  # 128-word keys
])
def test_merge_rank_kernel_matches_plain(dev, n_q, n_s, w, mask):
    ks, rs = _sorted_run(n_s, n_s, w, mask, 0)
    kq, rq = _sorted_run(n_q, n_q, w, mask, n_s)
    ks, rs, kq, rq = (t.to(dev) for t in (ks, rs, kq, rq))
    before = cudalib.LAUNCHES["merge_rank"]
    assert torch.equal(merge_ranks(kq, rq, ks, rs), merge_ranks_plain(kq, rq, ks, rs))
    assert cudalib.LAUNCHES["merge_rank"] == before + 1


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


def test_chunked_run_on_the_card_equals_unchunked(dev):
    buf = np.random.default_rng(5).integers(97, 123, size=(10000, 32), dtype=np.uint8)
    ks = rows_to_keyset(buf)
    cudalib.reset_launches()
    chunked = ReconstructionPipeline(backend="cuda", device=dev, chunk_threshold=4096,
                                     chunk_size=1024).run(ks)
    assert cudalib.LAUNCHES["merge_rank"] == chunked.stats["cascade_merges"] == 9
    assert cudalib.LAUNCHES["dbit"] == 1
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


def test_cuda_lookup_many_matches_torch_on_the_card(dev):
    """Three tenants in capacity 4, one ragged: one kernel launch, equal to
    the plain backend's lookup_many and, per tenant, to the single-tree
    ``"cuda"`` lookup of the same (dead-lane-normalized) queries."""
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
    f_ref, r_ref = get_backend("torch", device=dev).lookup_many(arena.stacked, queries, n_valid)
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    for t in range(3):
        qt = queries[t].clone()
        qt[n_valid[t]:] = 0xFFFFFFFF
        f1, r1 = cuda.lookup(trees[arena.slots[t]], qt)
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
