"""Sharding-rule engine: param path -> partition spec -> DTensor placements.

Policy (the JAX package's, unchanged):
  * tensor-parallel dims (attention heads, FFN hidden, vocab, experts,
    SSM inner dim) -> "model" axis;
  * one remaining large dim -> "data" axis (FSDP / ZeRO-style; the
    optimizer state inherits the same specs, giving ZeRO-1 for free);
  * the "pod" axis (multi-pod mesh) carries ONLY the batch — parameter
    all-gathers stay inside a pod, and just the gradient reduction
    crosses pods (the slow axis);
  * stacked-layer leading dims (parameters stacked over superblocks) are
    never sharded.

Rules are keyed on parameter *leaf names* (wq/wk/wv/wo, w1/w2/w3, embed,
lm_head, router, A_log, in_proj/out_proj, ...), so the engine needs no
per-arch tables.

A spec (:class:`P`) names, for each tensor dim, a mesh axis, a tuple of
mesh axes (major to minor) or ``None`` (replicated).  A
:class:`NamedSharding` pairs a spec with a ``DeviceMesh``; its
:meth:`~NamedSharding.placements` are what ``distribute_tensor`` takes
(:func:`to_placements`).
"""

from __future__ import annotations

from dataclasses import dataclass

from torch.distributed.tensor import Replicate, Shard

__all__ = ["P", "NamedSharding", "param_spec", "param_specs", "batch_spec",
           "to_placements", "mesh_axes", "map_with_path"]


class P(tuple):
    """A partition spec: ``P("data", "model")``, ``P(("pod", "data"))``,
    ``P()`` (replicated).  Entry ``d`` names the mesh axes that tensor dim
    ``d`` is split over; dims past the end are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of a JAX ``NamedSharding``."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    spec: P

    def placements(self, ndim: int) -> tuple:
        return to_placements(self.mesh, self.spec, ndim)


def mesh_axes(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh``, or of any stand-in with
    a ``shape`` (a tuple, or a dict by name) and ``mesh_dim_names`` or
    ``axis_names``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, mesh.shape))


def to_placements(mesh, spec: P, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` for a tensor of
    ``ndim`` dims: a mesh dim that ``spec`` names on tensor dim ``d``
    gets ``Shard(d)``, every other mesh dim ``Replicate()``.  A tuple
    entry shards its tensor dim over each of its axes, the first the
    major one, so its axes must come in the mesh's order."""
    names = tuple(mesh.mesh_dim_names)
    owner: dict[str, int] = {}
    for d, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in {names}")
            if a in owner:
                raise ValueError(f"spec {spec}: mesh axis {a!r} named twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


# leaf name -> spec for the *unstacked* param; None entries = replicated dim.
# Convention: weights are (in_dim, out_dim); "model" goes on the TP dim,
# "data" on the other large dim (FSDP).
_RULES: list[tuple[tuple[str, ...], tuple | None]] = [
    # embedding: FEATURE-sharded (a gather over a vocab-sharded table
    # needs the whole table; feature sharding keeps the gather local).
    (("embed",), (None, "model")),
    (("lm_head",), ("data", "model")),  # (d, V): vocab-sharded -> chunked loss

    # attention projections
    (("wq", "wk", "wv"), ("data", "model")),  # (d, heads*hd)
    (("wo",), ("model", "data")),  # (heads*hd, d)
    # dense FFN
    (("w1", "w3"), ("data", "model")),  # (d, ff)
    (("w2",), ("model", "data")),  # (ff, d)
    # MoE: expert dim on model (EP), then FSDP on d
    (("moe_w1", "moe_w3"), ("model", "data", None)),  # (E, d, ff)
    (("moe_w2",), ("model", "data", None)),  # (E, ff, d)
    (("router",), (None, "model")),  # (d, E)
    # Mamba
    (("in_proj",), ("data", "model")),  # (d, 2*di)
    (("out_proj",), ("model", "data")),  # (di, d)
    (("x_proj",), ("model", None)),  # (di, dt_rank + 2N)
    (("dt_proj",), (None, "model")),  # (dt_rank, di)
    (("conv_w",), ("model", None)),  # (di, k)
    (("A_log",), ("model", None)),  # (di, N)
    (("D", "dt_bias", "conv_b"), ("model",)),  # (di,)
    # xLSTM
    (("w_up",), ("data", "model")),  # (d, 2*di)
    (("w_down",), ("model", "data")),  # (di, d)
    (("wq_l", "wk_l", "wv_l"), ("model", None)),  # (di, di) inner
    (("wi", "wf", "wog"), ("model", None)),  # (di, H)
    (("r_i", "r_f", "r_z", "r_o"), (None, "model", None)),  # (H, dh, dh)
    (("sw_i", "sw_f", "sw_z", "sw_o"), ("data", "model")),  # (d, d)
    # norms, gates, biases: replicated
    (("ln", "q_norm", "k_norm", "final_norm", "gate", "bias", "b_i", "b_f"), None),
]


def _rule_for(name: str):
    for names, spec in _RULES:
        if name in names:
            return spec
    return None  # default: replicate


def param_spec(path: tuple, leaf=None) -> P:
    """Spec for one param addressed by its key path (a tuple of dict keys,
    e.g. ``("blocks", "0", "wq")``); ``leaf`` (anything with ``.shape``)
    trims or pads the spec to its rank."""
    name = None
    stacked = False
    for k in path:
        ks = str(k)
        if ks == "blocks":
            stacked = True  # stacked over superblocks: leading dim, never sharded
        name = ks
    rule = _rule_for(name)
    if rule is None:
        return P()
    dims = list(rule)
    if stacked:
        dims = [None] + dims
    if leaf is not None:
        # guard: never shard a dim the rule names if the leaf is lower-rank
        dims = dims[: len(leaf.shape)] if len(dims) > len(leaf.shape) else dims
        while len(dims) < len(leaf.shape):
            dims.append(None)
    return P(*dims)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict's leaves, the same nesting out."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_tree) -> dict:
    """A tree of :class:`P` matching a params tree (nested dicts)."""
    return map_with_path(lambda path, leaf: param_spec(path, leaf), params_tree)


def batch_spec(mesh) -> P:
    """Batch dim over every data-parallel axis present ('pod' included)."""
    axes = [a for a in ("pod", "data") if a in mesh_axes(mesh)]
    return P(tuple(axes)) if len(axes) > 1 else P(axes[0])
