"""State to and from numpy: the bridge between the port and any other
holder of the same index state (the reference package, files, tests),
and of the same LM parameters and caches.

Everything crosses as numpy in the reference's dtypes — ``uint32`` for key
words, rids and partial keys, ``int32`` for child/hi/dpos/klen, ``bool``
for leaf validity — so a tree built by one package can be searched by the
other and every array compared byte for byte.  Nothing here imports the
reference; objects from it are read by attribute.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.btree import BTree, BTreeConfig, stack_trees
from repro_torch.core.keyformat import KeySet
from repro_torch.core.metadata import DSMeta
from repro_torch.core.u32 import resolve_device, to_carrier, to_u32

__all__ = [
    "keyset_from_numpy",
    "meta_from_numpy",
    "tree_from_numpy",
    "tree_to_numpy",
    "stacked_tree_from_numpy",
    "stacked_tree_to_numpy",
    "result_to_numpy",
    "lm_params_from_numpy",
    "lm_master_from_numpy",
    "lm_params_to_numpy",
    "adamw_state_from_numpy",
    "adamw_state_to_numpy",
    "lm_cache_from_numpy",
    "lm_cache_to_numpy",
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


def stacked_tree_to_numpy(stacked: BTree) -> list[dict]:
    """A ``stack_trees`` arena as one :func:`tree_to_numpy` dict per slot
    (pad slots included), in the reference's dtypes."""
    whole = tree_to_numpy(stacked)
    return [
        {
            "levels": [{k: v[t] for k, v in level.items()} for level in whole["levels"]],
            "leaf": {k: v[t] for k, v in whole["leaf"].items()},
            "sorted_full": whole["sorted_full"][t],
            "sorted_rids": whole["sorted_rids"][t],
            "n_keys": whole["n_keys"],
        }
        for t in range(int(stacked.sorted_full.shape[0]))
    ]


def stacked_tree_from_numpy(members, config, device=None) -> BTree:
    """A port arena on ``device`` from one numpy tree per slot (the
    :func:`stacked_tree_to_numpy` layout; ``config`` as for
    :func:`tree_from_numpy`).  Its capacity is ``len(members)``."""
    trees = [
        tree_from_numpy(m["levels"], m["leaf"], m["sorted_full"], m["sorted_rids"],
                        m["n_keys"], config, device=device)
        for m in members
    ]
    return stack_trees(trees, capacity=len(trees))


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


# ---------------------------------------------------------------------------
# LM parameters and caches
# ---------------------------------------------------------------------------


def _float_tensor(a) -> torch.Tensor:
    """A float array (f32, or bf16 as the reference holds it) as a tensor
    of the same dtype; bf16 crosses through f32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, np.float32))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, model) -> dict:
    """The reference's LM parameter tree as numpy (``embed``, ``blocks``
    stacked over superblocks, ``final_norm``, ``lm_head``) -> the port's
    parameters for ``model`` (an ``repro_torch.models.lm.LM``), cast once
    as ``LM.prepare`` casts."""
    return model.prepare(_map_tree(_float_tensor, tree))


def lm_master_from_numpy(tree: dict, model) -> dict:
    """The reference's (f32) LM parameter tree as numpy -> the port's
    master parameters for ``model``: every leaf f32 on its device, values
    unchanged."""
    return _map_tree(lambda a: _float_tensor(a).to(model.device, torch.float32), tree)


def lm_params_to_numpy(params: dict) -> dict:
    """LM parameters (either form) as numpy f32 arrays, copied."""
    return _map_tree(lambda t: np.array(t.detach().to(torch.float32).cpu().numpy()), params)


def adamw_state_from_numpy(opt: dict, device=None) -> dict:
    """The reference's AdamW state as numpy (``m`` and ``v`` trees of f32,
    an int32 ``step``) -> the port's on ``device``, in the same dtypes."""
    dev = resolve_device(device)
    return {"m": _map_tree(lambda a: _float_tensor(a).to(dev, torch.float32), opt["m"]),
            "v": _map_tree(lambda a: _float_tensor(a).to(dev, torch.float32), opt["v"]),
            "step": torch.as_tensor(np.asarray(opt["step"]), dtype=torch.int32, device=dev)}


def adamw_state_to_numpy(opt: dict) -> dict:
    """The port's AdamW state as numpy in the reference's dtypes."""
    return {"m": lm_params_to_numpy(opt["m"]), "v": lm_params_to_numpy(opt["v"]),
            "step": np.asarray(int(opt["step"]), np.int32)}


def lm_cache_from_numpy(tree: dict, device=None) -> dict:
    """An LM cache tree as numpy (stacked over superblocks) -> tensors on
    ``device`` in the same dtypes (bf16 leaves stay bf16)."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _float_tensor(a).to(dev), tree)


def lm_cache_to_numpy(cache: dict) -> dict:
    """An LM cache as numpy f32 arrays (bf16 leaves up-cast exactly), copied:
    the port's steps write their cache in place."""
    return _map_tree(lambda t: np.array(t.detach().to(torch.float32).cpu().numpy()), cache)
