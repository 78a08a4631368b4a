"""Partial-key leaf probe of the point lookup and the leaf stage that
consumes it — the CUDA kernel's wrappers and their plain-PyTorch versions.

One kernel template (``csrc/probe.cu``) replaces both TPU kernels:
``repro/kernels/lookup/kernel.py::_probe_kernel`` / ``probe_planes`` and
its tenant-major twin ``_probe_many_kernel`` / ``probe_planes_many``.  It
gives a group of 16 lanes to each query and takes the tenant of a stacked
arena from the grid, so the single tree is the T = 1 case.  Two forms:

* the mask form (:func:`probe`, :func:`probe_many`): for each (query, leaf
  entry) pair, the query's ``pk``-bit window at the entry's ``dpos + 1``
  against the entry's stored partial key — the TPU kernels' (q, lc) mask,
  taking the query's leaf node instead of the reference's materialized
  ``repeat(queries, lc)`` pair arrays;
* the leaf-stage form (:func:`leaf_stage_many`, and :func:`leaf_stage` on
  a one-member arena): the whole leaf stage of
  ``core.btree.lookup_many_planned`` and ``lookup_batch_planned`` — screen, full-key confirm of the valid
  candidates in lane order, and the rid of the first full match — without
  gathering every lane's full key.  Its plain version is the plain leaf
  stage, which the ``"torch"`` backend runs.  A full match always
  window-matches (each entry's partial key is the window of its own key),
  so the two agree on every tree ``build_btree`` makes.

Launches count under ``"probe"`` (single tree: :func:`probe`,
:func:`leaf_stage`) and ``"probe_many"`` (stacked arena).  Both forms are bound by bytes.
"""

from __future__ import annotations

import torch

from repro_torch.core.btree import (
    NOT_FOUND_RID,
    _leaf_keys_many,
    _slice_bits,
    _tenant_rows,
)
from repro_torch.kernels import cudalib

__all__ = ["probe", "probe_plain", "probe_many", "probe_many_plain",
           "leaf_stage", "leaf_stage_many", "leaf_stage_many_plain"]

#: lanes the kernel gives a query; a leaf (at most LEAF_MAX_FANOUT = 14
#: entries) fits
_GROUP = 16
#: grid.y is the tenant
_MAX_TENANTS = 65535


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


def _check_probe_args(queries, node, leaf_dpos, leaf_pk, pk):
    """Raise unless the stacked operands fit the kernel; returns
    (T, q, W, lc, L)."""
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
    if t > min(t_cap, _MAX_TENANTS):
        raise ValueError(f"{t} tenants: more than the arena's {t_cap} or {_MAX_TENANTS}")
    if lc > _GROUP:
        raise ValueError(f"leaf capacity {lc} exceeds the kernel's {_GROUP} lanes")
    return t, q, w, lc, n_leaves


def _probe_launch(kernel, queries, node, leaf_dpos, leaf_pk, pk) -> torch.Tensor:
    """The mask form on (T, q, W) queries and stacked leaves, counted as
    ``kernel``."""
    t, q, w, lc, n_leaves = _check_probe_args(queries, node, leaf_dpos, leaf_pk, pk)
    out = torch.empty((t, q, lc), dtype=torch.bool, device=queries.device)
    if t and q:
        cudalib.launch(kernel, "repro_probe", queries.device,
                       queries, node, leaf_dpos, leaf_pk, out, t, q, w, lc, n_leaves, pk)
    return out


def probe(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """The (q, lc) candidate mask of :func:`probe_plain`.

    A CPU tensor takes :func:`probe_plain`; a CUDA tensor launches the
    kernel with one tenant (or raises).  ``node`` must hold valid leaf
    indices, as the descent produces them.
    """
    if queries.device.type == "cpu":
        return probe_plain(queries, node, leaf_dpos, leaf_pk, pk)
    return _probe_launch("probe", queries[None], node[None], leaf_dpos[None],
                         leaf_pk[None], pk)[0]


def probe_many(
    queries: torch.Tensor, node: torch.Tensor, leaf_dpos: torch.Tensor,
    leaf_pk: torch.Tensor, pk: int,
) -> torch.Tensor:
    """The (T, q, lc) candidate mask of :func:`probe_many_plain`.

    A CPU tensor takes :func:`probe_many_plain`; a CUDA tensor launches
    the kernel once for all ``T`` tenants (or raises).  ``node`` must hold
    valid leaf indices, as the descent produces them.
    """
    if queries.device.type == "cpu":
        return probe_many_plain(queries, node, leaf_dpos, leaf_pk, pk)
    return _probe_launch("probe_many", queries, node, leaf_dpos, leaf_pk, pk)


def leaf_stage_many_plain(stacked, node: torch.Tensor, queries: torch.Tensor):
    """The lookup's leaf stage in plain PyTorch over a stacked arena:
    (T, q) leaf nodes and (T, q, W) queries -> ((T, q) found, (T, q) rid).

    Every lane's full key is gathered (lanes past ``n_keys`` clamped to the
    last key), compared with the query and ANDed with ``valid``; the first
    matching lane's rid is the answer, ``NOT_FOUND_RID`` where none
    matches."""
    t = int(node.shape[0])
    keys = _leaf_keys_many(stacked, node)  # (T, q, lc, W)
    valid = _tenant_rows(stacked.leaf["valid"], t, node)
    eq = (keys == queries[:, :, None, :]).all(dim=-1) & valid
    found = eq.any(dim=2)
    e = torch.argmax(eq.to(torch.int8), dim=2)  # first maximum
    rid = torch.gather(_tenant_rows(stacked.leaf["rid"], t, node), 2, e[..., None])[..., 0]
    return found, torch.where(found, rid, torch.full_like(rid, NOT_FOUND_RID))


def _leaf_launch(kernel, stacked, node, queries):
    """The leaf-stage form on a stacked arena, counted as ``kernel``."""
    leaf, pk = stacked.leaf, stacked.config.pk_bits
    t, q, w, lc, n_leaves = _check_probe_args(queries, node, leaf["dpos"], leaf["pk"], pk)
    dev = queries.device
    cudalib.check_tensor("leaf valid", leaf["valid"], dev, torch.bool, 3)
    cudalib.check_tensor("leaf rid", leaf["rid"], dev, torch.int64, 3)
    cudalib.check_tensor("sorted_full", stacked.sorted_full, dev, torch.int64, 3)
    t_cap, n_keys, w_full = stacked.sorted_full.shape
    if leaf["valid"].shape != leaf["dpos"].shape or leaf["rid"].shape != leaf["dpos"].shape:
        raise ValueError("leaf arrays must agree")
    if w_full != w or t_cap != leaf["dpos"].shape[0] or n_keys != stacked.n_keys:
        raise ValueError("sorted_full must be (T_cap, n_keys, W) of the queries' width")
    found = torch.empty((t, q), dtype=torch.bool, device=dev)
    rid = torch.empty((t, q), dtype=torch.int64, device=dev)
    if t and q:
        cudalib.launch(kernel, "repro_probe_leaf", dev,
                       queries, node, leaf["dpos"], leaf["pk"], leaf["valid"], leaf["rid"],
                       stacked.sorted_full, found, rid, t, q, w, lc, n_leaves, n_keys, pk)
    return found, rid


def _leaf_stage(kernel, stacked, node, queries):
    if queries.device.type == "cpu":
        return leaf_stage_many_plain(stacked, node, queries)
    return _leaf_launch(kernel, stacked, node, queries)


def leaf_stage_many(stacked, node: torch.Tensor, queries: torch.Tensor):
    """``lookup_many_planned(leaf_stage_fn=...)``: the leaf stage of every
    tenant in one launch — ((T, q) found, (T, q) rid), equal to
    :func:`leaf_stage_many_plain` on every arena of built trees.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel's leaf-stage form (or raises).  ``node`` must hold valid leaf
    indices, as the descent produces them.
    """
    return _leaf_stage("probe_many", stacked, node, queries)


def leaf_stage(stacked, node: torch.Tensor, queries: torch.Tensor):
    """``lookup_batch_planned(leaf_stage_fn=...)``: :func:`leaf_stage_many`
    on the one-member arena of a single tree (``_as_stack(tree)``, (1, q)
    nodes and (1, q, W) queries), counted as ``"probe"``."""
    return _leaf_stage("probe", stacked, node, queries)
