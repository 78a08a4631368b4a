"""Concrete shardings for the train, prefill and decode step signatures.

Centralizes divisibility-guarded placement of params, optimizer state,
batches, and caches onto a mesh (rules in
``repro_torch.distributed.sharding``; guards here because e.g. long_500k
has global_batch=1, which no axis may shard).  :func:`place` turns a tree
of tensors into DTensors under a tree of shardings, as the reference
puts its arrays on the mesh.

A leaf of the trees these functions take is anything with ``.shape``: a
tensor, a meta tensor from ``models.lm.input_specs``, or a shape
stand-in; a mesh is a ``DeviceMesh`` or a stand-in that
``distributed.sharding.mesh_axes`` reads.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import (NamedSharding, P, map_with_path, mesh_axes,
                                              param_spec)

__all__ = [
    "guard_spec",
    "params_shardings",
    "opt_shardings",
    "batch_shardings",
    "cache_shardings",
    "replicated",
    "place",
]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    extent = mesh_axes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= extent[a]
        return n
    return extent[axis]


def _present(mesh, d):
    """A spec entry less the axes ``mesh`` lacks (a rule's "data" on a
    ("model",) mesh); None if none is left."""
    names = mesh_axes(mesh)
    if isinstance(d, (tuple, list)):
        kept = tuple(a for a in d if a in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return d if d in names else None


def guard_spec(mesh, spec: P, shape: tuple) -> P:
    """Drop sharded dims that don't divide evenly (even placement keeps
    every rank's block the same shape and the roofline accounting
    clean), and the axes the mesh lacks (replicated there)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, s in zip(dims, shape):
        d = _present(mesh, d)
        if d is not None and s % _axis_size(mesh, d) != 0:
            d = None
        out.append(d)
    return P(*out)


def _data_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    return axes if len(axes) > 1 else axes[0]


def params_shardings(mesh, params_tree, serve_tp_only: bool = False):
    """Rule-engine specs, divisibility-guarded, as NamedShardings.

    serve_tp_only: drop the FSDP ("data"/"pod") dims — for serving, params
    must be resident per TP group, or every decode step all-gathers the
    full weight set."""

    def one(path, leaf):
        spec = param_spec(path, leaf)
        if serve_tp_only:
            spec = P(*[None if d in ("data", "pod") else d for d in spec])
        return NamedSharding(mesh, guard_spec(mesh, spec, tuple(leaf.shape)))

    return map_with_path(one, params_tree)


def opt_shardings(mesh, opt_tree, params_shardings_tree):
    """m/v mirror the param shardings; step is replicated."""
    return {"m": params_shardings_tree, "v": params_shardings_tree,
            "step": NamedSharding(mesh, P())}


def batch_shardings(mesh, batch_tree):
    dp = _data_axes(mesh)

    def one(_path, leaf):
        if len(leaf.shape) == 0:
            spec = P()
        else:
            spec = P(*([dp] + [None] * (len(leaf.shape) - 1)))
        return NamedSharding(mesh, guard_spec(mesh, spec, tuple(leaf.shape)))

    return map_with_path(one, batch_tree)


def cache_shardings(mesh, cfg, cache_tree):
    """Cache layout: (nsb, B, ...) — batch over data axes, the widest inner
    feature dim over model."""
    dp = _data_axes(mesh)

    def one(path, leaf):
        name = str(path[-1])
        nd = len(leaf.shape)
        if name in ("k", "v"):  # (nsb, B, G, S, hd): S over model —
            # flash-decoding segments stay device-local
            spec = P(None, dp, None, "model", None)
        elif name in ("k_img", "v_img"):  # (nsb, B, G, n_img, hd)
            spec = P(None, dp, None, None, "model")
        elif name == "h" and nd == 4:  # mamba (nsb, B, di, N)
            spec = P(None, dp, "model", None)
        elif name == "conv":  # (nsb, B, cw-1, di)
            spec = P(None, dp, None, "model")
        elif name == "C":  # mlstm (nsb, B, H, dh, dh)
            spec = P(None, dp, None, "model", None)
        elif nd == 4:  # mlstm/slstm vectors (nsb, B, H, dh)
            spec = P(None, dp, None, "model")
        elif nd == 3:  # (nsb, B, H)
            spec = P(None, dp, None)
        else:
            spec = P()
        return NamedSharding(mesh, guard_spec(mesh, spec, tuple(leaf.shape)))

    return map_with_path(one, cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place(tree, shardings, src_data_rank: int | None = None):
    """Every tensor of ``tree`` as a DTensor under the sharding at the same
    path of ``shardings`` (a NamedSharding, or one for the whole tree).

    With ``src_data_rank=None`` (the default) every rank already holds the
    whole tensor and keeps its own block, with no communication: a
    restore, or a tree every rank made from one seed.  With a rank, that
    rank's values are scattered, as ``distribute_tensor`` does."""

    def one(path, t):
        s = shardings
        for k in path:
            if isinstance(s, NamedSharding):
                break
            s = s[k]
        t = torch.as_tensor(t)
        return distribute_tensor(t, s.mesh, s.placements(t.dim()), src_data_rank=src_data_rank)

    return map_with_path(one, tree)
