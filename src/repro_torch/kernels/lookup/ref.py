"""Scalar numpy oracle of the partial-key probe, and leaves shaped as the
build makes them for holding the probe kernel against its plain versions."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.btree import LEAF_MAX_FANOUT, BTree, BTreeConfig, _slice_bits
from repro_torch.core.u32 import to_carrier


def probe_ref(
    queries: np.ndarray, starts: np.ndarray, entry_pk: np.ndarray, pk: int
) -> np.ndarray:
    """(m, W) pair queries + (m,) starts + (m,) stored partial keys -> (m,)
    bool candidate mask (clipped start, zero word past the key end, top
    ``pk`` bits kept)."""
    q = np.asarray(queries, np.uint32)
    m, n_words = q.shape
    out = np.zeros((m,), bool)
    for i in range(m):
        start = min(max(int(starts[i]), 0), n_words * 32 - 1)
        wi, sh = start // 32, start % 32
        w0 = int(q[i, wi])
        w1 = int(q[i, wi + 1]) if wi + 1 < n_words else 0
        window = ((w0 << sh) | (w1 >> (32 - sh) if sh else 0)) & 0xFFFFFFFF
        out[i] = np.uint32(window >> (32 - pk)) == np.uint32(entry_pk[i])
    return out


def leaf_arena(seed: int, n_tenants: int, t_cap: int, n_leaves: int, lc: int, w: int,
               pk: int, q: int, device):
    """Stacked leaves shaped as ``build_btree`` makes them, with queries
    and their leaf nodes: ``(arena, queries (T, q, W), node (T, q))`` for
    holding the probe kernel's two forms against their plain versions.

    Each of ``t_cap`` members holds ``n = n_leaves * lc - min(5, lc - 1)``
    sorted-order keys of ``w`` words (few distinct bits, adjacent
    duplicates, the all-ones key), so its last leaf has lanes past ``n``.
    Entry starts (``dpos + 1``) fall at random, on word boundaries and in
    the last word; each valid entry's partial key is the ``pk``-bit window
    of its own key, as the build stores it, and a lane past ``n`` holds
    garbage.  The first ``n_tenants`` members get ``q`` queries each, with
    random leaf nodes: keys of their own leaf (hits, duplicates among
    them), the same keys one bit off (they share the windows), random keys
    and the all-ones key.
    """
    rng = np.random.default_rng(seed)
    n = n_leaves * lc - min(5, lc - 1)
    keys = rng.integers(0, 2**32, size=(t_cap, n, w), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    keys[:, 1::9] = keys[:, 0:n - 1:9]  # adjacent duplicates
    keys[:, n // 2] = 0xFFFFFFFF
    size, top = t_cap * n_leaves * lc, 32 * w
    dpos = np.concatenate([32 * rng.integers(0, w, size=size // 3) - 1,
                           top - 2 - rng.integers(0, 32, size=size // 3)])
    dpos = np.concatenate([dpos, rng.integers(-1, top, size=size - dpos.size)])
    dpos = torch.as_tensor(rng.permutation(dpos).reshape(t_cap, n_leaves, lc), device=device)
    pos = torch.arange(n_leaves * lc, device=device).reshape(n_leaves, lc)
    valid = (pos < n).expand(t_cap, n_leaves, lc).contiguous()
    full = to_carrier(keys, device)
    windows = _slice_bits(full[:, pos.clamp(max=n - 1)], dpos + 1, pk)
    garbage = to_carrier(rng.integers(0, 1 << pk, size=valid.shape, dtype=np.uint64)
                         .astype(np.uint32), device)
    rid = to_carrier(rng.integers(0, 2**32, size=valid.shape, dtype=np.uint64)
                     .astype(np.uint32), device)
    leaf = {"rid": rid, "pk": torch.where(valid, windows, garbage), "dpos": dpos,
            "klen": torch.full(valid.shape, 4 * w, dtype=torch.int64, device=device),
            "valid": valid}
    arena = BTree(levels=(), leaf=leaf, sorted_full=full,
                  sorted_rids=rid.reshape(t_cap, -1)[:, :n].contiguous(), n_keys=n,
                  config=BTreeConfig(pk_bits=pk, fill_factor=(lc + 0.5) / LEAF_MAX_FANOUT))
    node = rng.integers(0, n_leaves, size=(n_tenants, q))
    lane = np.minimum(node * lc + rng.integers(0, lc, size=node.shape), n - 1)
    queries = keys[np.arange(n_tenants)[:, None], lane]
    kind = rng.integers(0, 8, size=node.shape)
    bit = rng.integers(0, top, size=node.shape)
    near = np.flatnonzero(kind.reshape(-1) < 3)
    flat = queries.reshape(-1, w)
    flat[near, bit.reshape(-1)[near] // 32] ^= (
        np.uint32(1) << (31 - bit.reshape(-1)[near] % 32)).astype(np.uint32)
    flat[kind.reshape(-1) == 3] = rng.integers(0, 2**32, size=(int((kind == 3).sum()), w),
                                               dtype=np.uint32)
    flat[kind.reshape(-1) == 4] = 0xFFFFFFFF
    return (arena, to_carrier(flat.reshape(n_tenants, q, w), device),
            torch.as_tensor(node, device=device))


def member_tree(arena, t: int):
    """Member ``t`` of a stacked arena as a tree of its own (views)."""
    return dataclasses.replace(arena, leaf={k: v[t] for k, v in arena.leaf.items()},
                               sorted_full=arena.sorted_full[t],
                               sorted_rids=arena.sorted_rids[t])
