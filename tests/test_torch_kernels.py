"""Each kernel's plain-PyTorch version against the JAX reference kernel.

The reference kernels run as ``tests/test_kernels.py`` runs them on the
CPU (Pallas ``interpret=True``); the port's plain versions are what its
CUDA wrappers fall back to on a CPU tensor and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Outputs are integers and must
be equal byte for byte.  The CUDA kernels themselves are held against
the plain versions in ``tests/test_torch_cuda.py`` (GPU only).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import btree as RB  # noqa: E402
from repro.core import compress as RC  # noqa: E402
from repro.core import dbits as RD  # noqa: E402
from repro.core import metadata as RM  # noqa: E402
from repro.kernels.bitonic import ops as r_bitonic  # noqa: E402
from repro.kernels.build import ops as r_build  # noqa: E402
from repro.kernels.lookup import ops as r_lookup  # noqa: E402
from repro.kernels.pext import ops as r_pext  # noqa: E402
from repro_torch.core import btree as TB  # noqa: E402
from repro_torch.core import compress as TC  # noqa: E402
from repro_torch.core import metadata as TM  # noqa: E402
from repro_torch.core import plancache as TP  # noqa: E402
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels.bitonic import block_sort_plain  # noqa: E402
from repro_torch.kernels.bitonic.ref import block_sort_ref  # noqa: E402
from repro_torch.kernels.build import (  # noqa: E402
    gather_windows, gather_windows_plain, pk_windows, pk_windows_plain)
from repro_torch.kernels.build.ref import pk_windows_ref  # noqa: E402
from repro_torch.kernels.dbit import adjacent_dbits  # noqa: E402
from repro_torch.kernels.lookup import probe, probe_plain  # noqa: E402
from repro_torch.kernels.lookup.ref import probe_ref  # noqa: E402
from repro_torch.kernels.pext import pext, pext_plain  # noqa: E402
from repro_torch.kernels.pext.ops import pext_segments, segment_plan  # noqa: E402
from repro_torch.kernels.pext.ref import pext_ref  # noqa: E402

r_dbitmap = jax.jit(RD.compute_dbitmap)


def _keys(seed, n, w, mask=0xFFFFFFFF):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(mask)


def _t(a, device="cpu"):
    return to_carrier(np.asarray(a), device)


def _starts(seed, m, w):
    """Window starts: random, on word boundaries (sh == 0), in the last
    word, and outside the key (clipped)."""
    rng = np.random.default_rng(seed)
    top = w * 32
    return rng.permutation(np.concatenate([
        rng.integers(-40, top + 40, size=m - m // 2),
        32 * rng.integers(0, w, size=m // 4),
        top - 1 - rng.integers(0, 32, size=m // 2 - m // 4),
    ]))


# ---------------------------------------------------------------------------
# pext
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,w,mask", [(64, 1, 0x3FC0FF03), (255, 3, 0x3FC0FF03),
                                      (257, 16, 0x0F0F0F0F)])
def test_pext_plain_matches_reference_kernel(n, w, mask):
    words = _keys(n + w, n, w, mask)
    bm = np.asarray(r_dbitmap(jnp.asarray(words)))
    rplan, tplan = RC.make_plan(bm, w), TC.make_plan(bm, w)
    want = np.asarray(r_pext.pext(jnp.asarray(words), rplan, tile=256, interpret=True))
    got = to_u32(pext_plain(_t(words), tplan))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pext_ref(words, tplan), want)


def test_pext_plain_wide_keys_matches_reference():
    """512-byte keys (128 words), the paper's ExURL maximum; the reference
    kernel's oracle is ``extract_bits`` (its interpret run of this shape
    is ``tests/test_kernels.py::test_pext_wide_keys``)."""
    words = _keys(9, 300, 128, 0x01010101)
    bm = np.asarray(r_dbitmap(jnp.asarray(words)))
    rplan, tplan = RC.make_plan(bm, 128), TC.make_plan(bm, 128)
    want = np.asarray(RC.extract_bits(jnp.asarray(words), rplan))
    np.testing.assert_array_equal(to_u32(pext(_t(words), tplan)), want)
    np.testing.assert_array_equal(pext_ref(words, tplan), want)


@pytest.mark.parametrize("n,w,mask", [(64, 1, 0x3FC0FF03), (255, 3, 0x3FC0FF03),
                                      (257, 16, 0x0F0F0F0F), (300, 128, 0x01010101)])
def test_pext_segments_match_reference(n, w, mask):
    """The CUDA kernel's plan format (per-source-byte segments and their
    tables), run by its tensor emulation, against the plain version and
    the reference: interpret-mode ``pext`` on the shapes of
    ``test_pext_plain_matches_reference_kernel``, ``extract_bits`` at 128
    words (as ``test_pext_plain_wide_keys_matches_reference``)."""
    words = _keys(n + w, n, w, mask) if w < 128 else _keys(9, n, w, mask)
    bm = np.asarray(r_dbitmap(jnp.asarray(words)))
    rplan, tplan = RC.make_plan(bm, w), TC.make_plan(bm, w)
    if w < 128:
        want = np.asarray(r_pext.pext(jnp.asarray(words), rplan, tile=256, interpret=True))
    else:
        want = np.asarray(RC.extract_bits(jnp.asarray(words), rplan))
    got = pext_segments(_t(words), tplan)
    np.testing.assert_array_equal(to_u32(got), want)
    assert torch.equal(got, pext_plain(_t(words), tplan))


def _plan_of(positions, w):
    bm = np.zeros(w, np.uint32)
    for p in positions:
        bm[p // 32] |= np.uint32(1 << (31 - p % 32))
    return TC.make_plan(bm, w)


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
def test_pext_segment_plan_edges(name):
    """Segments cover every kept bit once, in output order, and never cross
    a destination word; the emulated kernel equals the plain version and
    the scalar oracle."""
    positions, w = _PLAN_EDGES[name]
    plan = _plan_of(positions, w)
    segments, tables = segment_plan(plan)
    addr, offset, mult, dw = segments.astype(np.uint32).astype(np.int64).T
    shift = np.log2(mult).astype(np.int64)
    width = np.asarray([bin(int(m)).count("1") for m in tables.max(axis=1)])[offset // 256]
    assert width.sum() == plan.n_bits
    assert np.array_equal(dw, np.repeat(np.arange(plan.n_words_out), np.bincount(dw)))
    assert ((shift + width <= 32) & (shift >= 0)).all()
    first = dw * 32 + 32 - shift - width  # each segment's first output bit
    assert np.array_equal(first, np.concatenate([[0], np.cumsum(width)[:-1]]))
    assert np.array_equal(np.unique(addr ^ 3), np.unique(np.asarray(positions) // 8))
    words = _keys(len(positions), 129, w)
    got = pext_segments(_t(words), plan)
    assert torch.equal(got, pext_plain(_t(words), plan))
    np.testing.assert_array_equal(to_u32(got), pext_ref(words, plan))


# ---------------------------------------------------------------------------
# bitonic block sort (the network is unstable: equality with the reference
# kernel, rows included, needs the same network lane for lane)
# ---------------------------------------------------------------------------


def _bitonic_case(kind, n, w):
    if kind == "dup":
        return np.repeat(_keys(n, -(-n // 4), w, 0x000000FF), 4, axis=0)[:n]
    if kind == "ones":
        return np.full((n, w), 0xFFFFFFFF, np.uint32)
    return _keys(n * w, n, w, 0xFFFF00FF)


@pytest.mark.parametrize("kind,n,w,block", [
    ("rand", 255, 2, 64), ("dup", 255, 2, 64), ("ones", 255, 2, 64), ("dup", 257, 4, 128),
])
def test_bitonic_plain_matches_reference_kernel(kind, n, w, block):
    words = _bitonic_case(kind, n, w)
    rows = np.random.default_rng(n).permutation(n).astype(np.uint32)
    rk, rr = r_bitonic.block_sort(jnp.asarray(words), jnp.asarray(rows),
                                  block=block, interpret=True)
    tk, tr = block_sort_plain(_t(words), _t(rows), block=block)
    np.testing.assert_array_equal(to_u32(tk), np.asarray(rk))
    np.testing.assert_array_equal(to_u32(tr), np.asarray(rr))
    # against the stable numpy oracle: same keys per block, same pairs
    ok, _ = block_sort_ref(words, rows, block)
    np.testing.assert_array_equal(to_u32(tk), ok)
    key_of_row = dict(zip(rows.tolist(), map(tuple, words)))
    assert [key_of_row[r] for r in to_u32(tr).tolist()] == list(map(tuple, to_u32(tk)))


@pytest.mark.parametrize("kind,n", [("rand", 127), ("dup", 100), ("ones", 100)])
def test_bitonic_plain_wide_keys_matches_reference_kernel(kind, n):
    """24-word keys: the first width whose 512-row block does not fit the
    CUDA kernel's 48 KB of shared memory, so that the kernel keeps 23
    words there and breaks ties from device memory.  A 64-row block (both
    n pad to 128 rows: one compile of the reference)."""
    words = _bitonic_case(kind, n, 24)
    rows = np.random.default_rng(n).permutation(n).astype(np.uint32)
    rk, rr = r_bitonic.block_sort(jnp.asarray(words), jnp.asarray(rows), block=64,
                                  interpret=True)
    tk, tr = block_sort_plain(_t(words), _t(rows), block=64)
    np.testing.assert_array_equal(to_u32(tk), np.asarray(rk))
    np.testing.assert_array_equal(to_u32(tr), np.asarray(rr))
    np.testing.assert_array_equal(to_u32(tk), block_sort_ref(words, rows, 64)[0])


# ---------------------------------------------------------------------------
# pk-window and probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,w", [(1000, 4), (513, 1), (300, 16)])
@pytest.mark.parametrize("pk", [1, 16, 32])
def test_pk_window_plain_matches_reference_kernel(m, w, pk):
    words = _keys(m * w, m, w)
    starts = _starts(m + pk, m, w)
    want = np.asarray(r_build.pk_windows(jnp.asarray(words), jnp.asarray(starts, jnp.int32),
                                         pk, tile=128, interpret=True))
    got = to_u32(pk_windows(_t(words), torch.as_tensor(starts), pk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pk_windows_ref(words, starts, pk), want)


def _gathered(m, w, pk):
    """A table of ``m`` keys, ``m`` row ids into it (repeats included) and
    window starts, with the reference kernel's windows of the gathered rows
    (``table[rows]`` as (W, m) planes, interpret mode) and
    ``repro.core.btree._slice_bits`` of them; the shapes are
    ``test_pk_window_plain_matches_reference_kernel``'s."""
    table = _keys(m * w + 1, m, w)
    rows = np.random.default_rng(m + w).integers(0, m, size=m)
    starts = _starts(m + pk + 1, m, w)
    full = jnp.asarray(table[rows])
    want = np.asarray(r_build.pk_windows(full, jnp.asarray(starts, jnp.int32), pk,
                                         tile=128, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(RB._slice_bits(full, jnp.asarray(starts, jnp.int32), pk)), want)
    return table, rows, starts, want


@pytest.mark.parametrize("m,w", [(1000, 4), (513, 1), (300, 16)])
@pytest.mark.parametrize("pk", [1, 16, 32])
def test_pk_window_index_form_matches_reference_kernel(m, w, pk):
    """The upper levels' form: windows of ``words[rows]`` without gathering
    the rows; starts on word boundaries, in the last word and clipped."""
    table, rows, starts, want = _gathered(m, w, pk)
    got = pk_windows(_t(table), torch.as_tensor(starts), pk, torch.as_tensor(rows))
    np.testing.assert_array_equal(to_u32(got), want)
    plain = pk_windows_plain(_t(table), torch.as_tensor(starts), pk, torch.as_tensor(rows))
    np.testing.assert_array_equal(to_u32(plain), want)


@pytest.mark.parametrize("m,w", [(1000, 4), (513, 1), (300, 16)])
@pytest.mark.parametrize("pk", [1, 16, 32])
def test_gather_windows_plain_matches_reference_kernel(m, w, pk):
    """The leaf level's fused form: the gathered rows and their windows."""
    table, rows, starts, want = _gathered(m, w, pk)
    for fn in (gather_windows, gather_windows_plain):
        full, got = fn(_t(table), torch.as_tensor(rows), torch.as_tensor(starts), pk)
        np.testing.assert_array_equal(to_u32(full), table[rows])
        np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("n,w,mask", [(1000, 4, 0x00FF0F0F), (513, 16, 0x01010101)])
def test_build_btree_with_kernel_hooks_matches_reference(n, w, mask):
    """``build_btree`` with the pk-window kernel's two forms as its hooks
    (their plain versions on the CPU) against the reference's tree, array
    for array; every level's window goes through the row-index form, over
    the bucket-padded table (a level program's operand)."""
    words = _keys(n + 7, n, w, mask)
    rids = np.random.default_rng(n).permutation(n).astype(np.uint32)
    lengths = np.full(n, w * 4, np.int32)
    r_meta = RM.meta_from_keys(words)
    t_meta = TM.meta_from_keys(words, "cpu")
    np.testing.assert_array_equal(t_meta.dbitmap, r_meta.dbitmap)
    plan = RC.make_plan(r_meta.dbitmap, w)
    comp = np.asarray(RC.extract_bits(jnp.asarray(words), plan))
    rows = np.arange(n, dtype=np.uint32)
    r_comp, r_rows = RD.sort_words_keyed(jnp.asarray(comp), jnp.asarray(rows))
    want = RB.build_btree(r_comp, r_rows, r_meta, jnp.asarray(words), jnp.asarray(lengths),
                          rids=jnp.asarray(rids))
    calls = {"dpos": 0, "gather": 0, "slice": 0}

    def dpos_fn(comp_):
        calls["dpos"] += 1
        assert comp_.shape == (n, r_comp.shape[1])
        return adjacent_dbits(comp_)

    def gather_fn(table, rows_, starts, pk):
        calls["gather"] += 1
        return gather_windows(table, rows_, starts, pk)

    def slice_fn(words_, starts, pk, rows_):
        calls["slice"] += 1
        assert words_.shape[0] == TP.bucket_for("build", n) and rows_.shape == starts.shape
        return pk_windows(words_, starts, pk, rows_)

    got = TB.build_btree(_t(r_comp), torch.as_tensor(np.asarray(r_rows, np.int64)), t_meta,
                         _t(words), torch.as_tensor(lengths), rids=_t(rids),
                         dpos_fn=dpos_fn, slice_fn=slice_fn, gather_slice_fn=gather_fn)
    assert calls == {"dpos": 1, "gather": 1, "slice": len(want.levels)}
    assert len(want.levels) >= 1
    for name in ("pk", "dpos", "klen", "rid", "valid"):
        np.testing.assert_array_equal(np.asarray(got.leaf[name]).astype(np.asarray(
            want.leaf[name]).dtype), np.asarray(want.leaf[name]), err_msg=name)
    for g, r in zip(got.levels, want.levels):
        for name in r:
            np.testing.assert_array_equal(np.asarray(g[name]).astype(np.asarray(r[name]).dtype),
                                          np.asarray(r[name]), err_msg=name)
    np.testing.assert_array_equal(to_u32(got.sorted_full), np.asarray(want.sorted_full))
    np.testing.assert_array_equal(to_u32(got.sorted_rids), np.asarray(want.sorted_rids))


@pytest.mark.parametrize("q,w,n_leaves,lc,pk", [(200, 4, 30, 12, 16), (64, 2, 7, 3, 32),
                                                (77, 16, 11, 12, 16)])
def test_probe_plain_matches_reference_kernel(q, w, n_leaves, lc, pk):
    """The port's probe takes (query, leaf node) and gathers per pair; the
    reference kernel takes the materialized pair arrays.  Same mask."""
    rng = np.random.default_rng(q)
    queries = _keys(q + 1, q, w)
    node = rng.integers(0, n_leaves, size=q)
    dpos = _starts(q + 2, n_leaves * lc, w).reshape(n_leaves, lc) - 1
    flat_q = np.repeat(queries, lc, axis=0)
    flat_starts = (dpos[node] + 1).reshape(-1)
    windows = pk_windows_ref(flat_q, flat_starts, pk).reshape(q, lc)
    leaf_pk = _keys(q + 3, n_leaves, lc, (1 << pk) - 1)
    leaf_pk[node[: q // 2]] = windows[: q // 2]  # about half the pairs match
    want = np.asarray(r_lookup.probe(
        jnp.asarray(flat_q), jnp.asarray(flat_starts, jnp.int32),
        jnp.asarray(leaf_pk[node].reshape(-1)), pk, tile=128, interpret=True,
    )).reshape(q, lc)
    got = probe(_t(queries), torch.as_tensor(node), torch.as_tensor(dpos),
                _t(leaf_pk), pk).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        probe_ref(flat_q, flat_starts, leaf_pk[node].reshape(-1), pk).reshape(q, lc), want)
