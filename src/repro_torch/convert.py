"""State to and from numpy: the bridge between the port and any other
holder of the same index state (the reference package, files, tests).

Everything crosses as numpy in the reference's dtypes — ``uint32`` for key
words, rids and partial keys, ``int32`` for child/hi/dpos/klen, ``bool``
for leaf validity — so a tree built by one package can be searched by the
other and every array compared byte for byte.  Nothing here imports the
reference; objects from it are read by attribute.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.btree import BTree, BTreeConfig
from repro_torch.core.keyformat import KeySet
from repro_torch.core.metadata import DSMeta
from repro_torch.core.u32 import resolve_device, to_carrier, to_u32

__all__ = [
    "keyset_from_numpy",
    "meta_from_numpy",
    "tree_from_numpy",
    "tree_to_numpy",
    "result_to_numpy",
]

#: tree fields held as u32 (int64 carriers in the port); the others are i32
_U32_FIELDS = ("rid", "pk")


def keyset_from_numpy(words, lengths, rids) -> KeySet:
    """A port ``KeySet`` from (n, W) uint32 words, (n,) lengths and rids."""
    return KeySet(
        words=np.asarray(words, np.uint32),
        lengths=np.asarray(lengths, np.int32),
        rids=np.asarray(rids, np.uint32),
    )


def meta_from_numpy(dbitmap, varbitmap, refkey, n_words: int) -> DSMeta:
    """A port ``DSMeta`` from its bitmaps and reference key."""
    return DSMeta(
        dbitmap=np.asarray(dbitmap, np.uint32),
        varbitmap=np.asarray(varbitmap, np.uint32),
        refkey=np.asarray(refkey, np.uint32),
        n_words=int(n_words),
    )


def _field_to_tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.tensor(a, device=device)
    if name in _U32_FIELDS:
        return to_carrier(a.astype(np.uint32), device)
    return torch.as_tensor(a.astype(np.int64), device=device)


def _field_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bool:
        return t.cpu().numpy()
    if name in _U32_FIELDS:
        return to_u32(t)
    return t.cpu().numpy().astype(np.int32)


def tree_from_numpy(levels, leaf, sorted_full, sorted_rids, n_keys: int, config,
                    device=None) -> BTree:
    """A port ``BTree`` on ``device`` from numpy arrays of a tree.

    ``levels`` is the root-first sequence of level dicts, ``leaf`` the leaf
    dict (arrays as the reference's ``BTree`` holds them); ``config`` is
    any object with ``pk_bits`` and ``fill_factor``.
    """
    dev = resolve_device(device)
    return BTree(
        levels=tuple(
            {k: _field_to_tensor(k, v, dev) for k, v in level.items()} for level in levels
        ),
        leaf={k: _field_to_tensor(k, v, dev) for k, v in leaf.items()},
        sorted_full=to_carrier(np.asarray(sorted_full, np.uint32), dev),
        sorted_rids=to_carrier(np.asarray(sorted_rids, np.uint32), dev),
        n_keys=int(n_keys),
        config=BTreeConfig(pk_bits=int(config.pk_bits),
                           fill_factor=float(config.fill_factor)),
    )


def tree_to_numpy(tree: BTree) -> dict:
    """Every array of a port ``BTree`` as numpy in the reference's dtypes:
    ``{"levels": [dict, ...], "leaf": dict, "sorted_full", "sorted_rids",
    "n_keys"}``."""
    return {
        "levels": [
            {k: _field_to_numpy(k, v) for k, v in level.items()} for level in tree.levels
        ],
        "leaf": {k: _field_to_numpy(k, v) for k, v in tree.leaf.items()},
        "sorted_full": to_u32(tree.sorted_full),
        "sorted_rids": to_u32(tree.sorted_rids),
        "n_keys": tree.n_keys,
    }


def result_to_numpy(res) -> dict:
    """A ``ReconstructionResult`` as numpy: sorted keys, rid and row
    permutations, the tree (``tree_to_numpy``) and the refreshed meta."""
    return {
        "comp_sorted": to_u32(res.comp_sorted),
        "rid_sorted": to_u32(res.rid_sorted),
        "row_sorted": to_u32(res.row_sorted),
        "tree": tree_to_numpy(res.tree),
        "meta": {
            "dbitmap": np.asarray(res.meta.dbitmap, np.uint32),
            "varbitmap": np.asarray(res.meta.varbitmap, np.uint32),
            "refkey": np.asarray(res.meta.refkey, np.uint32),
            "n_words": int(res.meta.n_words),
        },
    }
