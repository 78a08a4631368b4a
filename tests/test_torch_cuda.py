"""The port's CUDA kernels against their plain-PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no GPU is present (decided inside the fixture, at run time).
This file imports no JAX, so it runs on a machine with only PyTorch and
the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import compute_dbitmap, sort_words_keyed  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data.synthetic import rows_to_keyset  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import pk_windows, pk_windows_plain  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits, adjacent_dbits_plain  # noqa: E402
from repro_torch.kernels.lookup import probe, probe_plain  # noqa: E402
from repro_torch.kernels.merge import merge_ranks, merge_ranks_plain  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402

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
