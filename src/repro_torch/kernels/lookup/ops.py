"""Partial-key leaf probe of the point lookup — the CUDA kernels' wrappers,
their plain-PyTorch versions, and the ``leaf_match_fn`` /
``leaf_match_many_fn`` that plug them into
``core.btree.lookup_batch_planned`` / ``lookup_many_planned``.

The kernel (``csrc/probe.cu``) replaces the TPU kernel
``repro/kernels/lookup/kernel.py::_probe_kernel`` / ``probe_planes``.  For
each (query, leaf entry) pair it compares the query's ``pk``-bit window at
the entry's ``dpos + 1`` with the entry's stored partial key.  It takes
the query index and the leaf node instead of the reference's materialized
``repeat(queries, lc)`` pair arrays; the (q, lc) mask it returns is the
same.  It is bound by bytes (small gathers per pair, one mask byte out).

The tenant-major twin (``csrc/probe_many.cu``) replaces
``repro/kernels/lookup/kernel.py::_probe_many_kernel`` /
``probe_planes_many``: the same screen for every (tenant, query, entry)
triple of a stacked arena in one launch, each tenant's row equal to the
single-tree probe on that tenant's arrays.
"""

from __future__ import annotations

import torch

from repro_torch.core.btree import _slice_bits
from repro_torch.kernels import cudalib

__all__ = ["probe", "probe_plain", "leaf_match_fn", "probe_many", "probe_many_plain",
           "leaf_match_many_fn"]


def probe_plain(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """(q, W) queries, (q,) leaf node per query, (L, lc) leaf dpos and
    partial keys -> (q, lc) bool mask: window at dpos + 1 == stored pk."""
    q, w = queries.shape
    lc = leaf_dpos.shape[1]
    windows = _slice_bits(queries[:, None, :].expand(q, lc, w), leaf_dpos[node] + 1, pk)
    return windows == leaf_pk[node]


def probe(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """The (q, lc) candidate mask of :func:`probe_plain`.

    A CPU tensor takes :func:`probe_plain`; a CUDA tensor launches the
    kernel (or raises).  ``node`` must hold valid leaf indices, as the
    descent produces them.
    """
    if queries.device.type == "cpu":
        return probe_plain(queries, node, leaf_dpos, leaf_pk, pk)
    if not 1 <= pk <= 32:
        raise ValueError(f"pk must be in [1, 32], got {pk}")
    dev = queries.device
    cudalib.check_tensor("queries", queries, dev, torch.int64, 2)
    cudalib.check_tensor("node", node, dev, torch.int64, 1)
    cudalib.check_tensor("leaf_dpos", leaf_dpos, dev, torch.int64, 2)
    cudalib.check_tensor("leaf_pk", leaf_pk, dev, torch.int64, 2)
    q, w = queries.shape
    lc = leaf_dpos.shape[1]
    if node.shape[0] != q or leaf_pk.shape != leaf_dpos.shape:
        raise ValueError("node must have one entry per query; leaf arrays must agree")
    out = torch.empty((q, lc), dtype=torch.bool, device=dev)
    if q == 0:
        return out
    cudalib.launch(
        "probe", "repro_probe", dev,
        queries, node, leaf_dpos, leaf_pk, out, q, w, lc, pk,
    )
    return out


def leaf_match_fn(tree, node, keys, queries):
    """``lookup_batch_planned(leaf_match_fn=...)``: screen every (query,
    leaf entry) pair with the probe, then confirm with the full-key
    compare — byte-identical to the unscreened compare, since a full
    match always window-matches."""
    cand = probe(queries, node, tree.leaf["dpos"], tree.leaf["pk"], tree.config.pk_bits)
    return cand & (keys == queries[:, None, :]).all(dim=-1)


def probe_many_plain(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """(T, q, W) queries, (T, q) leaf node per query in its tenant's tree,
    (T_cap, L, lc) stacked leaf dpos and partial keys (T <= T_cap) ->
    (T, q, lc) bool mask: :func:`probe_plain` on each tenant's slice."""
    t, q, w = queries.shape
    lc = leaf_dpos.shape[2]
    tenant = torch.arange(t, device=node.device)[:, None]
    windows = _slice_bits(queries[:, :, None, :].expand(t, q, lc, w),
                          leaf_dpos[tenant, node] + 1, pk)
    return windows == leaf_pk[tenant, node]


def probe_many(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """The (T, q, lc) candidate mask of :func:`probe_many_plain`.

    A CPU tensor takes :func:`probe_many_plain`; a CUDA tensor launches
    the tenant-major kernel once for all ``T`` tenants (or raises).
    ``node`` must hold valid leaf indices, as the descent produces them.
    """
    if queries.device.type == "cpu":
        return probe_many_plain(queries, node, leaf_dpos, leaf_pk, pk)
    if not 1 <= pk <= 32:
        raise ValueError(f"pk must be in [1, 32], got {pk}")
    dev = queries.device
    cudalib.check_tensor("queries", queries, dev, torch.int64, 3)
    cudalib.check_tensor("node", node, dev, torch.int64, 2)
    cudalib.check_tensor("leaf_dpos", leaf_dpos, dev, torch.int64, 3)
    cudalib.check_tensor("leaf_pk", leaf_pk, dev, torch.int64, 3)
    t, q, w = queries.shape
    t_cap, n_leaves, lc = leaf_dpos.shape
    if tuple(node.shape) != (t, q) or leaf_pk.shape != leaf_dpos.shape:
        raise ValueError("node must be (T, q); leaf arrays must agree")
    if t > min(t_cap, 65535):  # grid.y is the tenant
        raise ValueError(f"{t} tenants: more than the arena's {t_cap} or 65535")
    out = torch.empty((t, q, lc), dtype=torch.bool, device=dev)
    if t == 0 or q == 0:
        return out
    cudalib.launch(
        "probe_many", "repro_probe_many", dev,
        queries, node, leaf_dpos, leaf_pk, out, t, q, w, lc, n_leaves, pk,
    )
    return out


def leaf_match_many_fn(tree, node, keys, queries):
    """``lookup_many_planned(leaf_match_many_fn=...)``: screen every
    (tenant, query, leaf entry) triple of the stacked tree with one
    tenant-major probe, then confirm with the full-key compare —
    byte-identical per tenant to :func:`leaf_match_fn` on that tenant's
    tree (a full match always window-matches)."""
    cand = probe_many(queries, node, tree.leaf["dpos"], tree.leaf["pk"], tree.config.pk_bits)
    return cand & (keys == queries[:, :, None, :]).all(dim=-1)
