"""The port's token pipeline against the JAX reference's, on the CPU.

``lm_tokens``, the FNV-1a shuffle keys, ``shuffle_order``, ``dedup_tokens``
and ``TokenPipeline.batch_at`` must equal the reference's byte for byte;
``compressed_key_sort`` and ``full_key_sort`` give the reference's sorted
keys, rids and permutation, duplicate keys included.  The port runs on the
``"torch"`` backend and on ``"cuda"`` with CPU tensors (the kernels' plain
versions); the kernels themselves are held on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.compress import make_plan as ref_make_plan  # noqa: E402
from repro.core.dbits import compute_dbitmap as ref_compute_dbitmap  # noqa: E402
from repro.core import sortkeys as ref_sortkeys  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data.synthetic import lm_tokens as ref_lm_tokens  # noqa: E402
from repro_torch.core import sortkeys  # noqa: E402
from repro_torch.core.compress import make_plan  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import lm_tokens  # noqa: E402

BACKENDS = ("torch", "cuda")


@pytest.mark.parametrize("shape", [(7, 5, 50, 0), (64, 33, 128256, 3)])
def test_lm_tokens_byte_for_byte(shape):
    n, length, vocab, seed = shape
    got, want = lm_tokens(n, length, vocab, seed), ref_lm_tokens(n, length, vocab, seed)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_fnv1a_keys_byte_for_byte(seed):
    x = np.concatenate([np.arange(3000), [2**32 - 1, 2**31, 255, 256]]).astype(np.uint32)
    got = to_u32(pipeline._fnv1a_vec(to_carrier(x, "cpu"), seed))
    want = ref_pipeline._fnv1a_vec(x, seed)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("n", [1000, 1023, 1025, 4095, 4097])
def test_shuffle_order_byte_for_byte(n, seed):
    want = np.asarray(ref_pipeline.shuffle_order(n, seed)).astype(np.int64)
    for backend in BACKENDS:
        got = pipeline.shuffle_order(n, seed, backend=backend, device="cpu")
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)
    assert sorted(want.tolist()) == list(range(n))


def _dup_docs(n, length, seed, dup_every=3):
    rng = np.random.default_rng(seed)
    docs = lm_tokens(n, length, 40, seed)
    src = rng.integers(0, n, size=n // dup_every)
    dst = rng.permutation(n)[: n // dup_every]
    docs[dst] = docs[src]  # copies of other rows at seeded positions
    return docs


DEDUP_CASES = {
    "len3": lambda: _dup_docs(300, 3, 0),
    "len65": lambda: _dup_docs(200, 65, 1),
    "len129": lambda: _dup_docs(129, 129, 2),
    "all_duplicate": lambda: np.repeat(lm_tokens(1, 65, 40, 3), 50, axis=0),
    "single_row": lambda: lm_tokens(1, 9, 40, 4),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedup_tokens_byte_for_byte(case):
    docs = DEDUP_CASES[case]()
    want = np.asarray(ref_pipeline.dedup_tokens(docs)).astype(np.int64)
    first = np.sort(np.unique(docs, axis=0, return_index=True)[1])
    np.testing.assert_array_equal(want, first)
    for backend in BACKENDS:
        got = pipeline.dedup_tokens(docs, backend=backend, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)
    if case == "all_duplicate":
        assert want.tolist() == [0]


def test_token_pipeline_batches_byte_for_byte():
    docs = lm_tokens(128, 17, 500, seed=6)
    want = ref_pipeline.TokenPipeline(docs, global_batch=4, seq_len=16, seed=3)
    got = pipeline.TokenPipeline(docs, global_batch=4, seq_len=16, seed=3, backend="cuda",
                                 device="cpu")
    assert got.per_epoch == want.per_epoch == 32
    # steps within the first epoch, its last step, and across the boundary
    for step in (0, 7, 31, 32, 33, 64 + 5):
        w, g = want.batch_at(step), got.batch_at(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32 and g[k].shape == (4, 16)
            assert g[k].numpy().tobytes() == w[k].tobytes(), (step, k)
    steps = [s for s, _ in zip(iter(got), range(3))]
    assert [s for s, _ in steps] == [0, 1, 2]


def _sort_inputs(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(600, 3), dtype=np.uint32) & np.uint32(0x0F00F00F)
    words[100:200] = words[0]  # a run of duplicate keys
    words[300:310] = words[500:510]
    rids = rng.permutation(600).astype(np.uint32) + 1000
    return words, rids


@pytest.mark.parametrize("backend", BACKENDS)
def test_key_sorts_match_reference_with_duplicates(backend):
    words, rids = _sort_inputs(8)
    bm = np.asarray(ref_compute_dbitmap(jnp.asarray(words)))
    want_c = ref_sortkeys.compressed_key_sort(jnp.asarray(words), jnp.asarray(rids),
                                              ref_make_plan(bm, 3))
    got_c = sortkeys.compressed_key_sort(words, rids, make_plan(bm, 3), backend=backend,
                                         device="cpu")
    want_f = ref_sortkeys.full_key_sort(jnp.asarray(words), jnp.asarray(rids))
    got_f = sortkeys.full_key_sort(words, rids, backend=backend, device="cpu")
    for got, want in ((got_c, want_c), (got_f, want_f)):
        assert to_u32(got.keys).tobytes() == np.asarray(want.keys).tobytes()
        assert to_u32(got.rids).tobytes() == np.asarray(want.rids).tobytes()
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    # Theorem 2: the compressed order sorts the full keys too
    np.testing.assert_array_equal(got_c.perm.numpy(), got_f.perm.numpy())
