"""Mesh context: lets model code state sharding intent without importing
mesh machinery everywhere.

``use_mesh(mesh, data_axes, model_axis)`` installs the mesh; ``constrain``
then redistributes a DTensor to the placements of a spec written in
logical axis names, resolved to the installed mesh ("data" -> the
(possibly composite) batch axes, "model" -> the tensor-parallel axis).
Outside a mesh context, and on a plain tensor, every helper is a no-op,
so the same model code runs on one device and on a sharded mesh
unchanged.

Inside ``use_mesh`` the thread also runs under DTensor's
``implicit_replication``: a plain tensor that meets a DTensor in one op
(a position ``arange``, a causal mask, a zero accumulator) counts as
replicated over the mesh, as a constant does in a sharded program.
"""

from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .sharding import NamedSharding, P, mesh_axes, to_placements

__all__ = ["use_mesh", "current", "spec", "constrain", "named_sharding", "axis_size"]

_state = threading.local()


def current():
    """``(mesh, data_axes, model_axis)`` of the installed mesh, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh, data_axes=("data",), model_axis: str = "model"):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, tuple(data_axes), model_axis)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.ctx = prev


def _resolve(axis):
    ctx = current()
    if ctx is None:
        return None
    _, data_axes, model_axis = ctx
    if axis == "data":
        return data_axes if len(data_axes) > 1 else data_axes[0]
    if axis == "model":
        return model_axis
    return axis  # literal mesh axis name or None


def spec(*logical_axes) -> P:
    return P(*[_resolve(a) for a in logical_axes])


def constrain(x, *logical_axes):
    """Redistribute the DTensor ``x`` to the placements of the logical
    spec; a plain tensor, or any tensor outside a mesh, passes through."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, _, _ = ctx
    return x.redistribute(mesh, to_placements(mesh, spec(*logical_axes), x.ndim))


def named_sharding(*logical_axes) -> NamedSharding | None:
    ctx = current()
    if ctx is None:
        return None
    mesh, _, _ = ctx
    return NamedSharding(mesh, spec(*logical_axes))


def axis_size(logical: str) -> int:
    """Mesh extent of a logical axis (1 outside a mesh context)."""
    ctx = current()
    if ctx is None:
        return 1
    mesh, _, _ = ctx
    resolved = _resolve(logical)
    if resolved is None:
        return 1
    extent = mesh_axes(mesh)
    if isinstance(resolved, (tuple, list)):
        n = 1
        for a in resolved:
            n *= extent[a]
        return n
    return extent[resolved]
