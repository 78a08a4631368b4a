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
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.dbits import compute_dbitmap  # noqa: E402
from repro_torch.core.pipeline import ReconstructionPipeline  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data.synthetic import rows_to_keyset  # noqa: E402
from repro_torch.kernels import cudalib  # noqa: E402
from repro_torch.kernels.bitonic import block_sort, block_sort_plain  # noqa: E402
from repro_torch.kernels.build import pk_windows, pk_windows_plain  # noqa: E402
from repro_torch.kernels.lookup import probe, probe_plain  # noqa: E402
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
    assert all(count > 0 for count in cudalib.LAUNCHES.values()), cudalib.LAUNCHES
    want = ReconstructionPipeline(backend="torch", device=dev).run(ks)
    assert torch.equal(got.comp_sorted, want.comp_sorted)
    assert torch.equal(got.rid_sorted, want.rid_sorted)
    for key, val in want.tree.leaf.items():
        assert torch.equal(got.tree.leaf[key], val), key
    np.testing.assert_array_equal(got.meta.dbitmap, want.meta.dbitmap)
    f_ref, r_ref = get_backend("torch", device=dev).lookup(want.tree, queries)
    assert torch.equal(found, f_ref) and torch.equal(rid, r_ref)
    assert bool(found.any()) and not bool(found.all())
