"""Partial-key leaf probe of the point lookup — the CUDA kernel's wrapper,
its plain-PyTorch version, and the ``leaf_match_fn`` that plugs it into
``core.btree.lookup_batch_planned``.

The kernel (``csrc/probe.cu``) replaces the TPU kernel
``repro/kernels/lookup/kernel.py::_probe_kernel`` / ``probe_planes``.  For
each (query, leaf entry) pair it compares the query's ``pk``-bit window at
the entry's ``dpos + 1`` with the entry's stored partial key.  It takes
the query index and the leaf node instead of the reference's materialized
``repeat(queries, lc)`` pair arrays; the (q, lc) mask it returns is the
same.  It is bound by bytes (small gathers per pair, one mask byte out).

The tenant-major twin (``_probe_many_kernel``, multi-tenant ``lookup_many``)
is not ported yet (ROADMAP Queue 2 item 7).
"""

from __future__ import annotations

import torch

from repro_torch.core.btree import _slice_bits
from repro_torch.kernels import cudalib

__all__ = ["probe", "probe_plain", "leaf_match_fn"]


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
