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
takes the leaf level's row gather and slice as a ``gather_slice_fn`` hook
and the upper levels' slice as a ``slice_fn`` hook, and the lookups take
their whole leaf stage as a ``leaf_stage_fn`` hook, so the CUDA backend
plugs in its pk-window and probe kernels.  Every array equals the reference tree's:
u32 fields (``rid``, ``pk``) are int64 carriers, the others int64 holding
the reference's int32 values.

Multi-tenant serving stacks same-geometry trees (``tree_geometry``,
``stack_trees``) on a leading tenant axis; ``lookup_many_planned``
descends every tenant's queries through its own member tree in one
batched pass, with explicit per-tenant offsets into the flattened
stacked arrays where the reference ``vmap``s the single-tree descent.

The build's leaf and upper levels and both lookups run as plan-cache
programs (``repro_torch.core.plancache``); on CUDA the lookups are
captured graphs.
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


def _slice_rows(words: torch.Tensor, start: torch.Tensor, pk_bits: int,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """pk_bits bits of keys ``words[rows]`` (every row if ``rows`` is None)
    starting at bit position start: the default ``slice_fn``."""
    return _slice_bits(words if rows is None else words[rows], start, pk_bits)


def _gather_slice(table: torch.Tensor, rows: torch.Tensor, start: torch.Tensor,
                  pk_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table[rows], pk_bits bits of each gathered key from start)``: the
    default ``gather_slice_fn``."""
    full = table[rows]
    return full, _slice_bits(full, start, pk_bits)


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def _fit_rows(x: torch.Tensor | None, rows: int, fill) -> torch.Tensor | None:
    """``x`` cut or padded to ``rows`` rows (a bucket-shaped operand whose
    lanes past the valid count are never read)."""
    if x is None:
        return None
    return x[:rows] if x.shape[0] > rows else _pad_rows(x, rows, fill)


def _leaf_body(dpos_fn, gather_slice_fn, pk: int):
    """The leaf level's entries, one program: the adjacent compressed-key
    D-bits mapped through D-offset, the row gather of the sorted full keys
    with each entry's partial key, the key lengths and the rids.  Operands
    are bucket-shaped; ``n`` and ``n_off`` (the D-offset length) are data,
    and only the first ``n`` lanes are read."""

    def prog(comp_pad, words_pad, lengths_pad, rids_pad, row_pad, d_off_pad, n, n_off):
        dev = comp_pad.device
        comp = comp_pad[:n]
        rowc = row_pad[:n].clamp(0, max(n - 1, 0))
        # distinction bit position per sorted entry (entry 0 -> position 0)
        dpos_comp = dpos_fn(comp)
        tail = torch.where(
            dpos_comp == NO_DBIT, torch.zeros_like(dpos_comp),
            d_off_pad[dpos_comp.clamp(0, max(n_off - 1, 0))],
        )
        dpos_full = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), tail])[:n]
        # the full keys in sorted order, and the partial key of each: pk
        # bits following the distinction bit position
        sorted_full, pkeys = gather_slice_fn(words_pad, rowc, dpos_full + 1, pk)
        W = int(words_pad.shape[1])
        klen = (
            torch.full((n,), W * 4, dtype=torch.int64, device=dev)
            if lengths_pad is None else lengths_pad[rowc].to(torch.int64)
        )
        rid_sorted = rowc if rids_pad is None else rids_pad[rowc]
        return sorted_full, pkeys, dpos_full, klen, rid_sorted

    return prog


def _level_body(slice_fn, pk: int):
    """One non-leaf level's entries, one program over ``Bn`` bucket-padded
    node rows: the adjacent highest-key D-bits (compressed keys + D-offset,
    §5.3), each entry's partial key from its highest key's full key
    (``words[row_sorted[hi]]``, read through the row) and its key length.
    """

    def prog(hi_pad, comp_pad, words_pad, lengths_pad, row_pad, d_off_pad, n, n_off):
        hi_prev = torch.cat([hi_pad[:1], hi_pad[:-1]])
        bc = hi_pad.clamp(0, n - 1)
        dc = dbit_position_pairwise(comp_pad[hi_prev.clamp(0, n - 1)], comp_pad[bc])
        dfull = torch.where(dc == NO_DBIT, torch.zeros_like(dc),
                            d_off_pad[dc.clamp(0, max(n_off - 1, 0))])
        dfull[0] = 0
        rows = row_pad[bc].clamp(0, max(n - 1, 0))
        epk = slice_fn(words_pad, dfull + 1, pk, rows)
        W = int(words_pad.shape[1])
        klen_hi = (
            torch.full(tuple(bc.shape), W * 4, dtype=torch.int64, device=bc.device)
            if lengths_pad is None else lengths_pad[rows].to(torch.int64)
        )
        return dfull, epk, klen_hi

    return prog


def build_btree(
    comp_sorted: torch.Tensor,
    row_sorted: torch.Tensor,
    meta: DSMeta,
    table_words: torch.Tensor,
    table_lengths: torch.Tensor | None = None,
    config: BTreeConfig = BTreeConfig(),
    rids: torch.Tensor | None = None,
    *,
    dpos_fn=None,
    slice_fn=None,
    gather_slice_fn=None,
    n_valid: int | None = None,
    backend_name: str = "torch",
    program_key_extra: tuple = (),
    cache=None,
) -> BTree:
    """Bulk-build the tree from sorted compressed keys + row positions (§5.3).

    ``table_words`` is the base table's full keys by *row*; ``row_sorted``
    is the sort permutation over rows; ``rids`` (optional) maps rows to
    record ids stored in leaf entries (defaults to the row index).
    Distinction bit positions of entries come from adjacent *compressed*
    keys mapped through D-offset — no full-key comparisons anywhere in the
    build, which is the point of the paper.

    The leaf level's entries are one program and each upper level's one
    more, cached in the plan cache (``repro_torch.core.plancache``) under
    ``("build_leaf", backend, B, W, Wc, pk)`` and ``("build_level",
    backend, Bn, B, W, Wc, pk)`` plus ``program_key_extra`` (configuration
    baked into the hooks); the inputs pad to the bucket ``B`` and the
    valid count travels as data, so sizes inside a bucket replay the same
    programs.  Only reshapes run between the program calls.

    Three hooks substitute the adjacent D-bits and the partial-key windows
    (the CUDA backend passes its dbit kernel's positions form and its
    pk-window kernel's two forms) and must be bit-identical to their
    defaults: ``dpos_fn(sorted_comp)`` returns the (n-1,) D-bit positions
    of adjacent sorted entries (default ``adjacent_dbit_positions``),
    ``gather_slice_fn(table, rows, starts, pk)`` the leaf level's
    ``(table[rows], windows)`` (default ``_gather_slice``), and
    ``slice_fn(words, starts, pk, rows)`` the windows of ``words[rows]``
    for an upper level (default ``_slice_rows``).
    ``n_valid`` marks ``comp_sorted``/``row_sorted`` as bucket-shaped with
    ``n_valid`` real rows; only those are read.
    """
    from . import plancache

    cache = cache or plancache.get_cache()
    if dpos_fn is None:
        dpos_fn = adjacent_dbit_positions
    if slice_fn is None:
        slice_fn = _slice_rows
    if gather_slice_fn is None:
        gather_slice_fn = _gather_slice
    n = int(comp_sorted.shape[0]) if n_valid is None else int(n_valid)
    dev = comp_sorted.device
    W = int(table_words.shape[1])
    Wc = int(comp_sorted.shape[1])
    lc, nc = config.leaf_cap, config.nonleaf_cap
    pk = config.pk_bits

    d_off = np.asarray(meta.d_offset(), np.int64)
    n_off = int(d_off.shape[0])
    # padded to the most D-bits a W-word key can have: a fixed shape
    d_off_pad = torch.as_tensor(
        np.concatenate([d_off, np.zeros(W * 32 - n_off, np.int64)]), device=dev)

    B = int(comp_sorted.shape[0]) if n_valid is not None else plancache.bucket_for("build", n)
    comp_pad = _fit_rows(comp_sorted, B, 0)
    words_pad = _fit_rows(table_words, B, 0)
    row_pad = _fit_rows(row_sorted, B, 0)
    lengths_pad = _fit_rows(table_lengths, B, 0)
    rids_pad = _fit_rows(rids, B, 0)

    # ---------------- leaf level (one program + reshapes) ----------------
    leaf_prog = cache.program(
        ("build_leaf", backend_name, B, W, Wc, pk) + tuple(program_key_extra),
        lambda: cache.traced(_leaf_body(dpos_fn, gather_slice_fn, pk)),
    )
    sorted_full, pkeys, dpos_full, klen, rid_sorted = leaf_prog(
        comp_pad, words_pad, lengths_pad, rids_pad, row_pad, d_off_pad, n, n_off)

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
        Bn = plancache.bucket(rows)
        hi = _pad_rows(child_hi, rows, -1)
        level_prog = cache.program(
            ("build_level", backend_name, Bn, B, W, Wc, pk) + tuple(program_key_extra),
            lambda: cache.traced(_level_body(slice_fn, pk)),
        )
        dfull, epk, klen_hi = level_prog(
            _pad_rows(hi, Bn, -1), comp_pad, words_pad, lengths_pad, row_pad, d_off_pad,
            n, n_off)
        child = _pad_rows(child_idx, rows, -1).reshape(n_nodes, nc)
        hi_grid = hi.reshape(n_nodes, nc)
        levels.append({
            "child": child,
            "hi": hi_grid,
            "pk": epk[:rows].reshape(n_nodes, nc),
            "dpos": dfull[:rows].reshape(n_nodes, nc),
            "klen": klen_hi[:rows].reshape(n_nodes, nc),
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


def _lookup_body(leaf_stage_fn):
    """The batched point lookup, one program: lanes at or past ``n_valid``
    (a 0-dim tensor) become all-ones queries, then the descent and the
    leaf stage of :func:`_lookup_many_body` on the one-member arena of the
    tree.  Nothing is read back to the host, so on CUDA it is captured as
    a graph."""

    def prog(tree, queries, n_valid):
        found, rid = _lookup_many_body(leaf_stage_fn)(_as_stack(tree), queries[None],
                                                      n_valid.reshape(1))
        return found[0], rid[0]

    return prog


def lookup_batch_planned(
    tree: BTree, queries: torch.Tensor, *, leaf_stage_fn, backend_name: str = "torch",
    program_key_extra: tuple = (), cache=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched point lookup through the plan cache (§4.3 search):
    ``(found (q,) bool, rid (q,))`` with miss lanes set to
    :data:`NOT_FOUND_RID` — the backend ``lookup`` op's byte-identity
    contract.

    The batch pads to ``bucket_for("lookup", q)`` with all-ones lanes and
    runs the program cached under ``("lookup", backend_name, bucket, W)``
    plus ``program_key_extra`` (configuration baked into the leaf stage);
    the valid count travels as data and the program normalizes the pad
    lanes to all-ones queries, whose answers are sliced off.  On CUDA the
    program is a captured graph (``plancache.PlanCache.graphed``).
    ``leaf_stage_fn`` is the leaf stage of :func:`lookup_many_planned`:
    ``(stacked, (1, q) node, (1, q, W) queries) -> ((1, q) found, (1, q)
    rid)`` on :func:`_as_stack` of the tree.
    """
    from . import plancache

    cache = cache or plancache.get_cache()
    q, w = int(queries.shape[0]), int(queries.shape[1])
    b = plancache.bucket_for("lookup", q)
    prog = cache.program(
        ("lookup", backend_name, b, w) + tuple(program_key_extra),
        lambda: cache.graphed(_lookup_body(leaf_stage_fn), device=queries.device),
    )
    found, rid = prog(tree, plancache.pad_tail(queries, b, MASK32), q)
    return found[:q], rid[:q]


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


def _lookup_many_body(leaf_stage_fn):
    """The fused multi-tenant lookup, one program: lanes at or past each
    tenant's count in ``n_valid`` (a ``(T,)`` tensor) become all-ones
    queries, then the tenant-major descent and ``leaf_stage_fn``.  Nothing
    is read back to the host, so on CUDA it is captured as a graph."""

    def prog(stacked, queries, n_valid):
        lane = torch.arange(queries.shape[1], device=queries.device)
        live = lane[None, :] < n_valid[:, None]
        queries = torch.where(live[..., None], queries, torch.full_like(queries, MASK32))
        return leaf_stage_fn(stacked, _descend_many(stacked, queries), queries)

    return prog


def lookup_many_planned(
    stacked: BTree, queries: torch.Tensor, n_valid=None, *, leaf_stage_fn,
    backend_name: str = "torch", program_key_extra: tuple = (), cache=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-tenant point lookup over a :func:`stack_trees` arena,
    through the plan cache.

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

    As in the reference, the query axis pads to ``bucket_for("lookup_many",
    q)`` and the tenant axis to the capacity (zero-valid rows), and the
    program is cached under ``("lookup_many", backend_name, t_cap, bucket,
    W, tree_geometry(stacked))`` plus ``program_key_extra``, so tenants
    joining within capacity, batches drifting within a bucket and
    snapshot churn at one geometry replay one program (a graph on CUDA).
    The leaf stage is ``leaf_stage_fn(stacked, node, queries) -> (found,
    rid)`` on the (T, q) leaf nodes the descent chose
    (``kernels.lookup``'s plain leaf stage, or its kernel on the CUDA
    backend, which gathers no full key but the candidates').
    """
    from . import plancache

    cache = cache or plancache.get_cache()
    if queries.dim() != 3:
        raise ValueError(f"queries must be (T, q, W), got {tuple(queries.shape)}")
    t_q, q, w = (int(s) for s in queries.shape)
    t_cap = int(stacked.sorted_full.shape[0])
    if t_q > t_cap:
        raise ValueError(f"{t_q} tenant blocks > arena capacity {t_cap}")
    if n_valid is None:
        nv = np.full((t_q,), q, np.int64)
    else:
        nv = np.asarray(n_valid, np.int64).reshape(-1)
        if nv.shape[0] != t_q:
            raise ValueError(f"n_valid has {nv.shape[0]} rows, expected {t_q}")
    nv_full = np.zeros((t_cap,), np.int64)
    nv_full[:t_q] = np.minimum(nv, q)
    b = plancache.bucket_for("lookup_many", q)
    prog = cache.program(
        ("lookup_many", backend_name, t_cap, b, w, tree_geometry(stacked))
        + tuple(program_key_extra),
        lambda: cache.graphed(_lookup_many_body(leaf_stage_fn), device=queries.device),
    )
    qp = plancache.pad_tail(plancache.pad_tail(queries, b, MASK32, dim=1), t_cap, MASK32)
    found, rid = prog(stacked, qp, nv_full)
    return found[:t_q, :q], rid[:t_q, :q]
