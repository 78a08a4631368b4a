"""The port's lookup leaf stage against the JAX reference.

The leaf stage (``kernels/lookup``: ``leaf_stage_many_plain`` and ``leaf_stage``
behind the ``leaf_stage_fn`` hook of
``core.btree.lookup_batch_planned`` / ``lookup_many_planned``) is held
against ``repro``'s ``lookup`` and ``lookup_many`` on the ``jnp`` backend
and on the ``pallas`` backend (its probe kernel in interpret mode), on
trees the reference builds and carries to the port: duplicate keys (the
first lane wins), the all-ones key and dead lanes, a last leaf with lanes
past ``n``, keys of 1, 4, 16, 17 and 128 words.

A numpy model of ``csrc/probe.cu`` (a group of 16 lanes per query, the
query's leading words preloaded, window words taken by shuffle,
candidates in ballot order, the full-key confirm a chunk at a time with an
early stop) is held against the reference's probe kernel and lookup on the
same trees; the kernel itself is held against the plain versions on a GPU
in ``tests/test_torch_cuda.py``.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as r_get_backend  # noqa: E402
from repro.core import btree as RB  # noqa: E402
from repro.core.keyformat import KeySet as RKeySet  # noqa: E402
from repro.core.pipeline import ReconstructionPipeline as RPipeline  # noqa: E402
from repro.kernels.lookup import ops as r_lookup  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.core.btree import (  # noqa: E402
    NOT_FOUND_RID,
    lookup_batch_planned,
    lookup_many_planned,
    stack_trees,
)
from repro_torch.core.u32 import to_carrier, to_u32  # noqa: E402
from repro_torch.kernels.lookup import (  # noqa: E402
    leaf_stage,
    leaf_stage_many,
    leaf_stage_many_plain,
)

ONES = np.uint32(0xFFFFFFFF)
#: 25 full leaves of 12 and one with a single entry: 11 lanes past n
N_KEYS = 301
WIDTHS = [1, 4, 16, 17, 128]
N_QUERIES = 48


def _words(seed: int, n: int, w: int) -> np.ndarray:
    """``n`` keys of ``w`` words: random words masked to a few bits each
    (so D-bits are scarce), four copies of one key, a duplicate pair,
    and the all-ones key."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32) & np.uint32(0x0F00F00F)
    words[10:13] = words[40]
    words[100] = words[7]
    words[n // 2] = ONES
    return words


@lru_cache(maxsize=None)
def _tenant(seed: int, w: int):
    """(words, rids, reference tree, the same tree carried to the port)."""
    words = _words(seed, N_KEYS, w)
    rids = np.random.default_rng(seed + 1).permutation(N_KEYS).astype(np.uint32) + \
        np.uint32(1000 * seed)
    ks = RKeySet(words=words, lengths=np.full(N_KEYS, 4 * w, np.int32), rids=rids)
    rtree = RPipeline(backend="jnp").run(ks).tree
    tree = tree_from_numpy(
        [{k: np.asarray(v) for k, v in lv.items()} for lv in rtree.levels],
        {k: np.asarray(v) for k, v in rtree.leaf.items()},
        np.asarray(rtree.sorted_full), np.asarray(rtree.sorted_rids), rtree.n_keys,
        rtree.config, device="cpu")
    return words, rids, rtree, tree


def _queries(words: np.ndarray, seed: int) -> np.ndarray:
    """Hits (duplicates among them), misses one bit off a key (they share
    its windows), random misses and the all-ones key."""
    rng = np.random.default_rng(seed)
    q = words[rng.integers(0, words.shape[0], size=N_QUERIES)].copy()
    q[:4] = words[[10, 11, 40, 100]]  # duplicated keys
    flip = rng.integers(0, q.shape[1] * 32, size=N_QUERIES // 4)
    rows = np.arange(4, 4 + N_QUERIES // 4)
    q[rows, flip // 32] ^= (np.uint32(1) << (31 - flip % 32)).astype(np.uint32)
    q[-6:-1] = rng.integers(0, 2**32, size=(5, q.shape[1]), dtype=np.uint32)
    q[-1] = ONES
    return q


def _ref_lookup(backend, rtree, q):
    be = r_get_backend(backend, **({"interpret": True} if backend == "pallas" else {}))
    found, rid = be.lookup(rtree, jnp.asarray(q))
    return np.asarray(found), np.asarray(rid)


def _ref_lookup_many(backend, rtrees, q, n_valid):
    be = r_get_backend(backend, **({"interpret": True} if backend == "pallas" else {}))
    found, rid = be.lookup_many(RB.stack_trees(rtrees), jnp.asarray(q), n_valid)
    return np.asarray(found), np.asarray(rid)


# ---------------------------------------------------------------------------
# the plain leaf stage through the hook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WIDTHS)
def test_leaf_stage_through_hook_matches_reference_lookup(w):
    """``lookup_batch_planned`` with the plain leaf stage, and with the
    kernel's wrapper (its plain version on the CPU), against the
    reference's jnp and pallas lookups: every hit's rid, the first of a
    run of duplicates, misses at ``NOT_FOUND_RID``."""
    words, rids, rtree, tree = _tenant(1, w)
    q = _queries(words, w)
    want = _ref_lookup("jnp", rtree, q)
    np.testing.assert_array_equal(_ref_lookup("pallas", rtree, q)[1], want[1])
    for fn in (leaf_stage_many_plain, leaf_stage):
        found, rid = lookup_batch_planned(tree, to_carrier(q, "cpu"), leaf_stage_fn=fn)
        np.testing.assert_array_equal(found.numpy(), want[0])
        np.testing.assert_array_equal(to_u32(rid), want[1])
    assert want[0][:4].all() and want[1][0] == want[1][1]  # keys 10 and 11 are equal
    assert not want[0][-6:-1].any() and (want[1][-6:-1] == NOT_FOUND_RID).all()
    assert want[0][-1] and want[1][-1] == rids[N_KEYS // 2]  # the all-ones key
    hit = want[0]
    sorted_rids = np.asarray(rtree.sorted_rids)
    for i in np.flatnonzero(hit):  # the first key equal to the query
        first = np.flatnonzero((np.asarray(rtree.sorted_full) == q[i]).all(1))[0]
        assert want[1][i] == sorted_rids[first]


@pytest.mark.parametrize("w", WIDTHS)
def test_leaf_stage_many_through_hook_matches_reference(w):
    """``lookup_many_planned`` over two tenants of one geometry with
    ragged ``n_valid``: dead lanes are all-ones queries, which every tenant
    finds (each holds the all-ones key); equal to the reference's jnp and
    pallas ``lookup_many``."""
    tenants = [_tenant(1, w), _tenant(2, w)]
    q = np.stack([_queries(t[0], 10 * w + i) for i, t in enumerate(tenants)])
    n_valid = np.array([N_QUERIES - 9, 3], np.uint32)
    want = _ref_lookup_many("jnp", [t[2] for t in tenants], q, n_valid)
    pallas = _ref_lookup_many("pallas", [t[2] for t in tenants], q, n_valid)
    np.testing.assert_array_equal(pallas[0], want[0])
    np.testing.assert_array_equal(pallas[1], want[1])
    stacked = stack_trees([t[3] for t in tenants])
    for fn in (leaf_stage_many_plain, leaf_stage_many):
        found, rid = lookup_many_planned(stacked, to_carrier(q, "cpu"), n_valid,
                                         leaf_stage_fn=fn)
        np.testing.assert_array_equal(found.numpy(), want[0])
        np.testing.assert_array_equal(to_u32(rid), want[1])
    for i, (nv, t) in enumerate(zip(n_valid, tenants)):
        assert want[0][i, nv:].all() and (want[1][i, nv:] == t[1][N_KEYS // 2]).all()


# ---------------------------------------------------------------------------
# a numpy model of the lane-group kernel
# ---------------------------------------------------------------------------

GROUP = 16


def _group_model(query, dpos, stored, valid, rid, full, pk, stats):
    """One group of 16 lanes on one query, as ``csrc/probe.cu`` runs it:
    -> (mask (lc,), found, rid).  Lane j < lc holds entry j; the query's
    leading words arrive with the node, one word a lane (4 for the mask
    form, 16 for the leaf-stage form), and each lane takes its window's two
    words from the lanes that hold them by shuffle, or reads a word past
    them itself; the windows of both forms agree; the valid
    candidates are taken in ballot (lane) order, each compared with the
    query a chunk at a time, stopping at the first chunk that differs and
    at the first full match."""
    w, lc = query.shape[0], dpos.shape[0]
    chunks = -(-w // GROUP)
    lane = np.arange(GROUP)
    entry = lane < lc
    d = np.zeros(GROUP, np.int64)
    d[:lc] = dpos
    start = np.clip(d + 1, 0, 32 * w - 1)
    wi, sh = start >> 5, (start & 31).astype(np.uint64)
    regs = [np.array([query[c * GROUP + k] if c * GROUP + k < w else 0 for k in lane],
                     np.uint64) for c in range(chunks)]
    windows = []
    for preload in (4, GROUP):  # the mask form's words loaded with the node, the leaf stage's
        pre = np.where(lane < preload, regs[0], np.uint64(0))
        a, b = pre[wi & 15], pre[(wi + 1) & 15]  # the two shuffles
        past = np.append(query, np.uint64(0))  # a word past the key reads as 0
        w0 = np.where(wi < preload, a, past[np.minimum(wi, w)])  # read by its lane
        w1 = np.where(wi + 1 < preload, b, past[np.minimum(wi + 1, w)])
        hi = (w0 << sh) & np.uint64(0xFFFFFFFF)
        lo = np.where(sh == 0, np.uint64(0), w1 >> (np.uint64(32) - sh))
        windows.append(((hi | lo) >> np.uint64(32 - pk))[entry])
    np.testing.assert_array_equal(windows[0], windows[1])
    hit = entry & (np.concatenate([windows[0], np.zeros(GROUP - lc, np.uint64)])
                   == np.concatenate([stored, np.zeros(GROUP - lc, np.uint64)]))
    ballot = sum(1 << j for j in range(lc) if hit[j] and valid[j])
    while ballot:
        j = (ballot & -ballot).bit_length() - 1
        ballot &= ballot - 1
        stats["candidates"] += 1
        eq = True
        for c in range(chunks):
            stats["chunk_compares"] += 1
            k = c * GROUP + lane
            same = (k >= w) | (full[j][np.minimum(k, w - 1)] == regs[c])
            if not same.all():
                eq = False
                break
        if eq:
            return hit[:lc], True, int(rid[j])
    return hit[:lc], False, NOT_FOUND_RID


@pytest.mark.parametrize("w", WIDTHS)
def test_lane_group_model_matches_reference(w):
    """The model's mask equals the reference's probe kernel (interpret
    mode) on every (query, entry) pair of the descended leaves; its found
    and rid equal the reference's lookup.  Every query confirms at most a
    few candidates; misses one bit off a key reach the full compare and
    are rejected; the chunked compare stops early; the all-ones query
    finds the only valid entry of the last leaf."""
    words, _, rtree, _ = _tenant(1, w)
    q = _queries(words, w)
    node = np.asarray(RB._descend(rtree, jnp.asarray(q)))
    leaf = {k: np.asarray(v) for k, v in rtree.leaf.items()}
    full = np.asarray(rtree.sorted_full).astype(np.uint64)
    pk, lc = rtree.config.pk_bits, rtree.config.leaf_cap
    n = rtree.n_keys
    stats = {"candidates": 0, "chunk_compares": 0}
    masks, found, rid = [], [], []
    for i in range(q.shape[0]):
        nd = int(node[i])
        lanes = np.minimum(nd * lc + np.arange(lc), n - 1)  # past n: never valid
        m, f, r = _group_model(q[i].astype(np.uint64), leaf["dpos"][nd],
                               leaf["pk"][nd].astype(np.uint64), leaf["valid"][nd],
                               leaf["rid"][nd], full[lanes], pk, stats)
        masks.append(m)
        found.append(f)
        rid.append(r)
    want_mask = np.asarray(r_lookup.probe(
        jnp.asarray(np.repeat(q, lc, axis=0)),
        jnp.asarray((leaf["dpos"][node] + 1).reshape(-1), jnp.int32),
        jnp.asarray(leaf["pk"][node].reshape(-1)), pk, tile=128, interpret=True)).reshape(-1, lc)
    np.testing.assert_array_equal(np.stack(masks), want_mask)
    want = _ref_lookup("jnp", rtree, q)
    np.testing.assert_array_equal(np.array(found), want[0])
    np.testing.assert_array_equal(np.array(rid, np.uint32), want[1])
    # the all-ones query ends in the last leaf, whose lanes past n are dead
    assert node[-1] == leaf["valid"].shape[0] - 1 and not leaf["valid"][-1].all()
    n_found = int(want[0].sum())
    assert n_found < stats["candidates"] <= 2 * q.shape[0]
    if w > GROUP:  # a rejected candidate stops at its first differing chunk
        assert stats["chunk_compares"] < stats["candidates"] * -(-w // GROUP)
