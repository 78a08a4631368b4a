"""Execution-backend interface + registry for the reconstruction pipeline.

A backend supplies the data-parallel stages of the paper's pipeline —
compressed-key **extract** (§5.1), parallel **sort** (§5.2), bulk
**build** (§5.3), DS-metadata **refresh** (§4.3) — and batched point
**lookup** (§4.3) behind one interface, so
``repro_torch.core.pipeline`` runs the same scan → extract → sort → build
→ refresh flow on the plain-PyTorch oracle (``"torch"``) or on the
hand-written CUDA kernels (``"cuda"``) without call-site branching.

Determinism contract: ``sort`` orders rows by the lexicographic pair
``(key, row)`` — ties between equal keys break on the ascending row id.
Every backend honours it, which is what makes the sorted compressed keys
and rid permutations *byte-identical* across backends and with the
reference package (what the parity tests assert).  The row id is carried
as an extra least-significant sort-key word (the paper's sort key is
literally the (compressed key, rid) pair).  Rows are the pipeline's row
*positions* — distinct values in ``[0, n)``.

The build and lookup ops share the contract: trees and ``(found, rid)``
answers (miss lanes set to ``repro_torch.core.btree.NOT_FOUND_RID``) must
be bit-for-bit equal across backends.  ``lookup_many`` lifts it over the
tenant axis of a stacked arena: each tenant's row equals ``lookup`` on
that tenant's tree alone.

Every backend runs on one ``device``: CUDA unless the caller passes
another (``device="cpu"`` runs the plain versions on the host).  With no
GPU and no explicit device, construction raises.

``merge_sorted`` (the chunked sort's ladder and ``run_incremental``)
shares the contract: the merge of two ascending (key, row) runs is
byte-identical to ``sort`` over their concatenation.

Ops of a later slice of the port — ``fused_extract_sort`` and
``batched_extract_sort`` (``run_many``) — raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import abc
from typing import Callable, Type

import numpy as np
import torch

from repro_torch.core.u32 import resolve_device

__all__ = [
    "ExecutionBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "not_ported",
]

_REGISTRY: dict[str, Type["ExecutionBackend"]] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: register an ExecutionBackend under ``name``."""

    def deco(cls: type) -> type:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str, device=None) -> "ExecutionBackend":
    """Instantiate a registered backend on ``device`` (CUDA unless named)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](device=device)


def available_backends() -> list[str]:
    """Sorted names of every registered execution backend."""
    return sorted(_REGISTRY)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an op of a later slice raises."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})"
    )


class ExecutionBackend(abc.ABC):
    """One execution substrate for the pipeline's stages.

    ``last_info`` holds backend-specific facts about the most recent run;
    the pipeline folds it into ``ReconstructionResult.stats``.
    """

    name: str = "?"

    #: the adjacent-D-bit pass of ``refresh_meta`` (None: the plain pass)
    dbit_fn: Callable | None = None

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.last_info: dict = {}

    # ------------------------------------------------------------ extract
    @abc.abstractmethod
    def extract(self, words: torch.Tensor, plan) -> torch.Tensor:
        """(n, W) full keys -> (n, Wc) compressed keys (int64 carriers)."""

    # --------------------------------------------------------------- sort
    @abc.abstractmethod
    def sort(
        self, keys: torch.Tensor, rows: torch.Tensor, *,
        n_valid: int | None = None, keep_padded: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sort (n, W) keys with (n,) distinct row positions in [0, n).

        Returns (keys_sorted, rows_sorted) in ascending (key, row) order.
        ``n_valid`` marks the inputs as bucket-shaped with ``n_valid`` real
        rows (pad lanes may hold anything; they are normalized to sort
        last).  ``keep_padded`` returns the bucket-shaped outputs so the
        pipeline chains into the build without slicing.
        """

    # -------------------------------------------------------------- merge
    def merge_sorted(
        self, keys_a: torch.Tensor, rows_a: torch.Tensor,
        keys_b: torch.Tensor, rows_b: torch.Tensor, *,
        n_valid_a: int | None = None, n_valid_b: int | None = None,
        keep_padded: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Merge two ascending (key, row) runs into one.

        Byte-identical to ``sort`` over the concatenated inputs; rows must
        be distinct across both runs.  The default is the plain rank pass
        and complement scatter, bucketed (``plancache.merge_padded``).
        ``n_valid_a``/``n_valid_b`` mark the runs as bucket-shaped with
        that many valid rows; ``keep_padded`` returns the full
        ``(ba + bb,)`` outputs with pads at the tail (ladder chaining).
        """
        from repro_torch.core.plancache import merge_padded

        return merge_padded(keys_a, rows_a, keys_b, rows_b, n_valid_a=n_valid_a,
                            n_valid_b=n_valid_b, keep_padded=keep_padded)

    # -------------------------------------------------------------- build
    def build(self, comp_sorted, row_sorted, meta, words, lengths, config,
              rids=None, n_valid: int | None = None):
        """Stage 3 (§5.3): bottom-up bulk build of the partial-key B+tree
        with the plain pk-window gather; backends may substitute their own
        (trees must be byte-identical across backends)."""
        from repro_torch.core.btree import build_btree

        return build_btree(comp_sorted, row_sorted, meta, words, lengths, config,
                           rids=rids, n_valid=n_valid)

    # ------------------------------------------------------------- lookup
    def lookup(self, tree, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched point lookup: (q, W) queries -> ((q,) found, (q,) rid),
        miss lanes ``NOT_FOUND_RID``; byte-identical across backends.  The
        default compares full keys at the leaf."""
        from repro_torch.core.btree import lookup_batch_planned

        return lookup_batch_planned(tree, queries)

    def lookup_many(self, stacked, queries: torch.Tensor, n_valid=None):
        """Fused point lookup over T stacked same-geometry trees.

        ``stacked`` is a ``repro_torch.core.btree.stack_trees`` arena;
        ``queries`` is (T_q, q, W) with ``T_q`` at most the arena
        capacity, tenant ``t``'s block answered against member tree
        ``t``; ``n_valid`` (optional (T_q,) host counts) gives per-tenant
        live lane counts, dead lanes answering as all-ones queries.
        Returns ``((T_q, q) found, (T_q, q) rid)``, each tenant's row
        byte-identical to :meth:`lookup` on that tenant's tree alone.  The
        default compares full keys at the leaf (the oracle).
        """
        from repro_torch.core.btree import lookup_many_planned

        return lookup_many_planned(stacked, queries, n_valid)

    # ------------------------------------------------------- refresh meta
    def refresh_meta(self, comp_sorted: torch.Tensor, meta, ref_key,
                     n_valid: int | None = None):
        """Stage 4 (§4.3): recompute DS-metadata at the opportune time.

        The adjacent D-bit positions of the sorted run are computed on the
        device (by ``dbit_fn``); only that (n-1,) vector crosses to the
        host, where one vectorized scatter-OR sets the bitmap words
        (``meta_on_rebuild``).
        """
        from repro_torch.core.metadata import meta_on_rebuild
        from repro_torch.core.plancache import adjacent_dpos_padded

        dpos = adjacent_dpos_padded(comp_sorted, n_valid=n_valid, impl=self.dbit_fn)
        comp_unused = np.zeros((0, int(comp_sorted.shape[1])), np.uint32)
        return meta_on_rebuild(comp_unused, meta, np.asarray(ref_key), dpos_comp=dpos)

    # ------------------------------------------------ later slices (raise)
    def fused_extract_sort(self, *args, **kwargs):
        """extract+sort as one program — not ported yet."""
        raise not_ported("fused_extract_sort", "Queue 1 item 9")

    def batched_extract_sort(self, *args, **kwargs):
        """Stacked extract+sort of run_many — not ported yet."""
        raise not_ported("batched_extract_sort", "Queue 1 item 9")
