"""Bottom-up bulk build and batched search of the partial-key B+tree
(paper §4.2, §5.3), on tensors.

Pointer-chasing nodes are structure-of-arrays *levels*: each level is a
dict of ``(n_nodes, fanout)`` tensors, so bulk build is reshapes + gathers
and batched search is a vectorized descent.  Entry layout is the paper's:
every entry carries a ``pk``-bit partial key, the distinction bit position
against the previous entry's (highest) key, the key length, and a record
id (leaf) or child pointer + highest-key pointer (non-leaf).

Node geometry follows §5.3: 256-byte nodes, 24-byte header (+8-byte next
pointer in leaves), 16-byte leaf entries and 24-byte non-leaf entries =>
max fanout 14 (leaf) / 9 (non-leaf), filled to ``max_fanout * fill``.

Partial-key bits are obtained by paper option **C.b**: sliced from the
record's full key (the base table is memory-resident).  ``build_btree``
takes the slice as a ``slice_fn`` hook and ``lookup_batch_planned`` the
leaf screen as a ``leaf_match_fn`` hook, so the CUDA backend plugs in its
pk-window and probe kernels.  Every array equals the reference tree's:
u32 fields (``rid``, ``pk``) are int64 carriers, the others int64 holding
the reference's int32 values.

Multi-tenant serving stacks same-geometry trees (``tree_geometry``,
``stack_trees``) on a leading tenant axis; ``lookup_many_planned``
descends every tenant's queries through its own member tree in one
batched pass, with explicit per-tenant offsets into the flattened
stacked arrays where the reference ``vmap``s the single-tree descent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dbits import NO_DBIT, adjacent_dbit_positions, dbit_position_pairwise, lex_compare_le
from .metadata import DSMeta
from .u32 import MASK32

__all__ = [
    "BTreeConfig",
    "BTree",
    "build_btree",
    "search_batch",
    "lookup_batch_planned",
    "tree_geometry",
    "stack_trees",
    "lookup_many_planned",
    "NOT_FOUND_RID",
]

NODE_BYTES = 256
LEAF_HEADER = 24 + 8  # header + next-node pointer
NONLEAF_HEADER = 24
LEAF_ENTRY = 16
NONLEAF_ENTRY = 24
LEAF_MAX_FANOUT = (NODE_BYTES - LEAF_HEADER) // LEAF_ENTRY  # 14
NONLEAF_MAX_FANOUT = (NODE_BYTES - NONLEAF_HEADER) // NONLEAF_ENTRY  # 9

#: rid every backend returns for a missing query
NOT_FOUND_RID = 0xFFFFFFFF


@dataclass(frozen=True)
class BTreeConfig:
    pk_bits: int = 16
    fill_factor: float = 0.9

    @property
    def leaf_cap(self) -> int:
        return max(2, int(LEAF_MAX_FANOUT * self.fill_factor))

    @property
    def nonleaf_cap(self) -> int:
        return max(2, int(NONLEAF_MAX_FANOUT * self.fill_factor))


@dataclass
class BTree:
    """SoA partial-key B+tree (all tensors on one device).

    levels: root-first tuple of non-leaf levels, each a dict with
            child (m,c) (-1 = empty), hi (m,c) (index into the sorted key
            order), pk (m,c), dpos (m,c), klen (m,c).
    leaf:   dict with rid (L,c), pk (L,c), dpos (L,c), klen (L,c),
            valid (L,c) bool.
    sorted_full: (n, W) full keys in sorted order (the "pointer to the
            highest index key" target).
    sorted_rids: (n,) record ids in sorted order.
    """

    levels: tuple
    leaf: dict
    sorted_full: torch.Tensor
    sorted_rids: torch.Tensor
    n_keys: int
    config: BTreeConfig

    @property
    def height(self) -> int:
        return len(self.levels) + 1

    def nodes_per_level(self) -> list[int]:
        return [int(l["child"].shape[0]) for l in self.levels] + [
            int(self.leaf["rid"].shape[0])
        ]

    def memory_bytes(self) -> int:
        return sum(self.nodes_per_level()) * NODE_BYTES


def _slice_bits(words: torch.Tensor, start: torch.Tensor, pk_bits: int) -> torch.Tensor:
    """pk_bits bits of (..., W) keys starting at bit position start (...)."""
    W = words.shape[-1]
    start = start.clamp(0, W * 32 - 1)
    wi = start // 32
    sh = start % 32
    w0 = torch.gather(words, -1, wi[..., None])[..., 0]
    w1 = torch.gather(words, -1, torch.clamp(wi + 1, max=W - 1)[..., None])[..., 0]
    w1 = torch.where(wi + 1 < W, w1, torch.zeros_like(w1))
    hi = (w0 << sh) & MASK32
    lo = torch.where(sh == 0, torch.zeros_like(w1), w1 >> (32 - sh))
    return (hi | lo) >> (32 - pk_bits)


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def build_btree(
    comp_sorted: torch.Tensor,
    row_sorted: torch.Tensor,
    meta: DSMeta,
    table_words: torch.Tensor,
    table_lengths: torch.Tensor | None = None,
    config: BTreeConfig = BTreeConfig(),
    rids: torch.Tensor | None = None,
    *,
    slice_fn=None,
    n_valid: int | None = None,
) -> BTree:
    """Bulk-build the tree from sorted compressed keys + row positions (§5.3).

    ``table_words`` is the base table's full keys by *row*; ``row_sorted``
    is the sort permutation over rows; ``rids`` (optional) maps rows to
    record ids stored in leaf entries (defaults to the row index).
    Distinction bit positions of entries come from adjacent *compressed*
    keys mapped through D-offset — no full-key comparisons anywhere in the
    build, which is the point of the paper.

    ``slice_fn(words, starts, pk)`` substitutes the partial-key window
    gather (default ``_slice_bits``; the CUDA backend passes its pk-window
    kernel) and must be bit-identical to it.  ``n_valid`` marks
    ``comp_sorted``/``row_sorted`` as bucket-shaped with ``n_valid`` real
    rows; only those are read.
    """
    if slice_fn is None:
        slice_fn = _slice_bits
    n = int(comp_sorted.shape[0]) if n_valid is None else int(n_valid)
    dev = comp_sorted.device
    comp = comp_sorted[:n]
    W = int(table_words.shape[1])
    lc, nc = config.leaf_cap, config.nonleaf_cap
    pk = config.pk_bits

    d_off = torch.as_tensor(meta.d_offset().astype(np.int64), device=dev)
    n_off = int(d_off.shape[0])

    # ---------------- leaf level: gathers, dpos, windows ----------------
    rowc = row_sorted[:n].clamp(0, max(n - 1, 0))
    sorted_full = table_words[rowc]
    klen = (
        torch.full((n,), W * 4, dtype=torch.int64, device=dev)
        if table_lengths is None else table_lengths[rowc].to(torch.int64)
    )
    rid_sorted = rowc if rids is None else rids[rowc]
    # distinction bit position per sorted entry (entry 0 -> position 0)
    dpos_comp = adjacent_dbit_positions(comp)
    tail = torch.where(
        dpos_comp == NO_DBIT, torch.zeros_like(dpos_comp), d_off[dpos_comp.clamp(0, n_off - 1)]
    )
    dpos_full = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), tail])[:n]
    # partial key: pk bits following the distinction bit position
    pkeys = slice_fn(sorted_full, dpos_full + 1, pk)

    n_leaves = -(-n // lc)
    rows = n_leaves * lc
    leaf = {
        "rid": _pad_rows(rid_sorted, rows, NOT_FOUND_RID).reshape(n_leaves, lc),
        "pk": _pad_rows(pkeys, rows, 0).reshape(n_leaves, lc),
        "dpos": _pad_rows(dpos_full, rows, 0).reshape(n_leaves, lc),
        "klen": _pad_rows(klen, rows, 0).reshape(n_leaves, lc),
        "valid": (torch.arange(rows, device=dev) < n).reshape(n_leaves, lc),
    }
    # highest (sorted-order) key index of each leaf
    child_hi = torch.clamp(torch.arange(n_leaves, device=dev) * lc + lc, max=n) - 1

    # ---------------- non-leaf levels, bottom-up ----------------
    levels: list[dict] = []
    child_idx = torch.arange(n_leaves, device=dev)
    while child_idx.shape[0] > 1:
        n_nodes = -(-int(child_idx.shape[0]) // nc)
        rows = n_nodes * nc
        hi = _pad_rows(child_hi, rows, -1)
        hi_prev = torch.cat([hi[:1], hi[:-1]])
        bc = hi.clamp(0, n - 1)
        dc = dbit_position_pairwise(comp[hi_prev.clamp(0, n - 1)], comp[bc])
        dfull = torch.where(dc == NO_DBIT, torch.zeros_like(dc), d_off[dc.clamp(0, n_off - 1)])
        dfull[0] = 0
        child = _pad_rows(child_idx, rows, -1).reshape(n_nodes, nc)
        hi_grid = hi.reshape(n_nodes, nc)
        levels.append({
            "child": child,
            "hi": hi_grid,
            "pk": slice_fn(sorted_full[bc], dfull + 1, pk).reshape(n_nodes, nc),
            "dpos": dfull.reshape(n_nodes, nc),
            "klen": klen[bc].reshape(n_nodes, nc),
        })
        # parents become the children of the next level up
        last_valid = (child >= 0).sum(dim=1) - 1
        child_hi = hi_grid[torch.arange(n_nodes, device=dev), last_valid]
        child_idx = torch.arange(n_nodes, device=dev)

    levels.reverse()  # root first
    return BTree(
        levels=tuple(levels),
        leaf=leaf,
        sorted_full=sorted_full,
        sorted_rids=rid_sorted,
        n_keys=n,
        config=config,
    )


# ---------------------------------------------------------------------------
# batched search
# ---------------------------------------------------------------------------

def _first_ge(entry_keys: torch.Tensor, valid: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index of the first valid entry whose key >= query; last valid if none."""
    ge = lex_compare_le(query[:, None, :], entry_keys) & valid
    first = torch.argmax(ge.to(torch.int8), dim=1)  # first maximum
    last_valid = valid.sum(dim=1) - 1
    return torch.where(ge.any(dim=1), first, last_valid)


def _as_stack(tree: BTree) -> BTree:
    """``tree`` as a one-member arena: every tensor viewed with a leading
    tenant axis of 1 (no copy), so the single-tree search is the T = 1
    case of the stacked one and the descent is written once."""
    return BTree(
        levels=tuple({k: v[None] for k, v in level.items()} for level in tree.levels),
        leaf={k: v[None] for k, v in tree.leaf.items()},
        sorted_full=tree.sorted_full[None],
        sorted_rids=tree.sorted_rids[None],
        n_keys=tree.n_keys,
        config=tree.config,
    )


def _descend(tree: BTree, queries: torch.Tensor) -> torch.Tensor:
    """Non-leaf descent shared by every search path: (q,) leaf node ids
    (:func:`_descend_many` on a one-member arena)."""
    return _descend_many(_as_stack(tree), queries[None])[0]


def _leaf_keys(tree: BTree, node: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full keys of each descended leaf's entry lanes: (pos0, (q, lc, W))."""
    pos0 = node * tree.config.leaf_cap
    return pos0, _leaf_keys_many(_as_stack(tree), node[None])[0]


def search_batch(tree: BTree, queries: torch.Tensor):
    """Vectorized descent; returns (found (q,), rid (q,), position (q,))."""
    node = _descend(tree, queries)
    pos0, keys = _leaf_keys(tree, node)
    e = _first_ge(keys, tree.leaf["valid"][node], queries)
    key_at = keys[torch.arange(keys.shape[0], device=keys.device), e]
    found = (key_at == queries).all(dim=-1)
    rid = torch.gather(tree.leaf["rid"][node], 1, e[:, None])[:, 0]
    return found, rid, pos0 + e


def lookup_batch_planned(
    tree: BTree, queries: torch.Tensor, *, leaf_match_fn=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched point lookup (§4.3 search): ``(found (q,) bool, rid (q,))``
    with miss lanes set to :data:`NOT_FOUND_RID` — the backend ``lookup``
    op's byte-identity contract.

    It is :func:`lookup_many_planned` on a one-member arena.  The leaf
    stage runs the substitutable ``leaf_match_fn(tree, node, keys,
    queries) -> (q, lc) bool`` on the tree's own tensors (full-key
    equality by default, the probe kernel's screen plus the full compare
    on the CUDA backend), which must imply full-key equality bit for bit.
    The reference pads the batch to a compile bucket and answers the pad
    lanes as garbage; eager PyTorch needs no bucket, so only the real
    queries are descended.
    """
    many_fn = None
    if leaf_match_fn is not None:
        def many_fn(stacked, node, keys, q):
            del stacked
            return leaf_match_fn(tree, node[0], keys[0], q[0])[None]
    found, rid = lookup_many_planned(_as_stack(tree), queries[None],
                                     leaf_match_many_fn=many_fn)
    return found[0], rid[0]


# ---------------------------------------------------------------------------
# multi-tenant lookup: T same-geometry trees stacked, one batched descent
# ---------------------------------------------------------------------------


def tree_geometry(tree: BTree) -> tuple:
    """Static shape signature of a tree — the arena bucketing key.

    Two trees with equal geometry can be stacked into one arena; a rebuild
    that changes any array shape (or ``n_keys``, or the config) changes
    the geometry and must migrate to a different arena bucket.  Hashable,
    and equal to the reference's tuple for the same tree.
    """
    levels = tuple(
        tuple(sorted((k, tuple(map(int, v.shape))) for k, v in level.items()))
        for level in tree.levels
    )
    leaf = tuple(sorted((k, tuple(map(int, v.shape))) for k, v in tree.leaf.items()))
    return (
        levels,
        leaf,
        tuple(map(int, tree.sorted_full.shape)),
        tuple(map(int, tree.sorted_rids.shape)),
        int(tree.n_keys),
        int(tree.config.pk_bits),
        float(tree.config.fill_factor),
    )


def stack_trees(trees, capacity: int | None = None) -> BTree:
    """Stack T same-geometry trees on a new leading tenant axis.

    Returns a :class:`BTree` whose every tensor has shape ``(capacity,) +
    member_shape`` (``n_keys`` and ``config`` are the members' own).
    ``capacity`` defaults to the next power of two ``>= len(trees)``; pad
    slots replicate the first member (their queries are masked out by
    ``n_valid``, so the content is irrelevant but must be shape-correct).
    ``torch.stack`` copies, so an arena never aliases a member's tensors.
    """
    trees = list(trees)
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    geom = tree_geometry(trees[0])
    for i, t in enumerate(trees[1:], 1):
        if tree_geometry(t) != geom:
            raise ValueError(
                f"tree {i} geometry differs from tree 0; same-geometry "
                "trees only — bucket by tree_geometry() first"
            )
    t_live = len(trees)
    if capacity is None:
        capacity = 1 << max(0, (t_live - 1).bit_length())
    if capacity < t_live:
        raise ValueError(f"capacity {capacity} < {t_live} trees")
    padded = trees + [trees[0]] * (capacity - t_live)

    def stack(get):
        return torch.stack([get(t) for t in padded])

    return BTree(
        levels=tuple(
            {k: stack(lambda t, i=i, k=k: t.levels[i][k]) for k in level}
            for i, level in enumerate(trees[0].levels)
        ),
        leaf={k: stack(lambda t, k=k: t.leaf[k]) for k in trees[0].leaf},
        sorted_full=stack(lambda t: t.sorted_full),
        sorted_rids=stack(lambda t: t.sorted_rids),
        n_keys=trees[0].n_keys,
        config=trees[0].config,
    )


def _tenant_rows(x: torch.Tensor, t: int, node: torch.Tensor) -> torch.Tensor:
    """Rows ``node[t', i]`` of member ``t'`` of a stacked (T_cap, L, ...)
    tensor, for the first ``t`` members: (t, q, ...).  The member offset
    ``t' * L`` is added to the (already valid) node ids."""
    n_rows = int(x.shape[1])
    flat = x[:t].reshape((t * n_rows,) + tuple(x.shape[2:]))
    offset = torch.arange(t, device=node.device)[:, None] * n_rows
    return flat[node + offset]


def _descend_many(stacked: BTree, queries: torch.Tensor) -> torch.Tensor:
    """Tenant-major descent: (T, q, W) queries -> (T, q) leaf node ids,
    tenant ``t``'s row descending member tree ``t``.

    Each level compares the query against the entries' *highest index
    keys* through the highest-key pointer, as the paper's search (§4.3)
    does — vectorized over the node fanout, the query batch and the
    tenants.  The highest-key indices are clamped into ``[0, n_keys)``
    first, then offset by ``t * n_keys`` into the flattened stacked keys;
    node ids are offset by ``t * L`` into the flattened level arrays."""
    t, q, w = queries.shape
    n = stacked.n_keys
    full = stacked.sorted_full[:t].reshape(t * n, w)
    key_offset = torch.arange(t, device=queries.device)[:, None, None] * n
    flat_q = queries.reshape(t * q, w)
    node = torch.zeros((t, q), dtype=torch.int64, device=queries.device)
    for level in stacked.levels:
        c = int(level["child"].shape[-1])
        hi = _tenant_rows(level["hi"], t, node)  # (t, q, c)
        child = _tenant_rows(level["child"], t, node).reshape(t * q, c)
        hi_keys = full[hi.clamp(0, n - 1) + key_offset].reshape(t * q, c, w)
        e = _first_ge(hi_keys, child >= 0, flat_q)
        node = torch.gather(child, 1, e[:, None])[:, 0].clamp(min=0).reshape(t, q)
    return node


def _leaf_keys_many(stacked: BTree, node: torch.Tensor) -> torch.Tensor:
    """Full keys of each descended leaf's entry lanes: (T, q, lc, W)."""
    t = int(node.shape[0])
    n, lc = stacked.n_keys, stacked.config.leaf_cap
    w = int(stacked.sorted_full.shape[-1])
    lanes = (node * lc)[..., None] + torch.arange(lc, device=node.device)
    offset = torch.arange(t, device=node.device)[:, None, None] * n
    return stacked.sorted_full[:t].reshape(t * n, w)[lanes.clamp(0, n - 1) + offset]


def _leaf_match_many_full(tree, node, keys, queries):
    """Default leaf probe: full-key equality over every entry lane,
    tenant-major — ``keys`` (T, q, lc, W) against ``queries`` (T, q, W)."""
    del tree, node
    return (keys == queries[:, :, None, :]).all(dim=-1)


def lookup_many_planned(
    stacked: BTree, queries: torch.Tensor, n_valid=None, *, leaf_match_many_fn=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-tenant point lookup over a :func:`stack_trees` arena.

    ``queries`` is ``(T_q, q, W)`` (int64 carriers) with ``T_q`` at most
    the arena capacity; tenant ``t``'s block is answered against member
    tree ``t``.  ``n_valid`` (optional host sequence of ``T_q`` counts)
    gives each tenant's live lane count; lanes at or past it are
    normalized to all-ones queries before the descent, exactly as the
    reference does, so a dead lane answers whatever the all-ones key
    answers in that tenant's tree (``found`` where the tree holds it).
    Returns ``(found (T_q, q) bool, rid (T_q, q))`` with misses at
    :data:`NOT_FOUND_RID`, each tenant's row byte-identical to
    :func:`lookup_batch_planned` on that tenant's tree alone.

    The reference pads the query axis to a compile bucket and the tenant
    axis to the capacity, then slices both off; here only the ``T_q``
    given tenants and their ``q`` lanes are descended, which answers the
    kept lanes identically.  ``leaf_match_many_fn(tree, node, keys,
    queries) -> (T, q, lc) bool`` substitutes the leaf probe (the
    tenant-major probe kernel on the CUDA backend) and must imply
    full-key equality bit for bit.
    """
    if leaf_match_many_fn is None:
        leaf_match_many_fn = _leaf_match_many_full
    if queries.dim() != 3:
        raise ValueError(f"queries must be (T, q, W), got {tuple(queries.shape)}")
    t_q, q, _ = (int(s) for s in queries.shape)
    t_cap = int(stacked.sorted_full.shape[0])
    if t_q > t_cap:
        raise ValueError(f"{t_q} tenant blocks > arena capacity {t_cap}")
    if n_valid is not None:
        nv = np.asarray(n_valid, np.int64).reshape(-1)
        if nv.shape[0] != t_q:
            raise ValueError(f"n_valid has {nv.shape[0]} rows, expected {t_q}")
        nv = torch.as_tensor(np.minimum(nv, q), device=queries.device)
        live = torch.arange(q, device=queries.device)[None, :] < nv[:, None]
        queries = torch.where(live[..., None], queries, torch.full_like(queries, MASK32))
    node = _descend_many(stacked, queries)
    keys = _leaf_keys_many(stacked, node)
    valid = _tenant_rows(stacked.leaf["valid"], t_q, node)
    eq = leaf_match_many_fn(stacked, node, keys, queries) & valid
    found = eq.any(dim=2)
    e = torch.argmax(eq.to(torch.int8), dim=2)  # first maximum
    rid = torch.gather(_tenant_rows(stacked.leaf["rid"], t_q, node), 2, e[..., None])[..., 0]
    return found, torch.where(found, rid, torch.full_like(rid, NOT_FOUND_RID))
