"""Mixture-of-Experts layer with compressed-key-sort dispatch.

Token -> expert dispatch is a sort problem: entries keyed by
``(expert_id, arrival order)`` must be grouped by expert in a stable
order.  The dispatch sort key packs ``expert_id || flat position`` into
``ceil(log2 E) + ceil(log2 N·k)`` bits, the paper's Theorem 2 applied to a
key domain known before the call: where the wide key needs two 32-bit
sort words, the compressed key fits one.  The key is held in an int64
carrier whose values stay below 2^32 (the port's rule for u32 words);
past 32 bits the dispatch falls back to a stable sort on the expert id.

Two dispatch modes give identical positions:
  * ``sort``   — compressed-key sort of (expert, position) entries, then
    capacity-bucket scatter;
  * ``einsum`` — GShard-style cumsum-over-one-hot positions (no sort).

The dispatch has static shapes, as the reference's fixed-shape scatter:
every entry gets a flat slot of the ``(E, cap)`` buffer, and an entry
that is dropped at capacity goes to one extra slot past the end, which
is cut off.  Nothing in the layer has a shape that depends on the data,
so a fake tensor traces it without a shape environment.

On a mesh (DTensor activations) the experts stay split as the rules place
them (``moe_w*`` split over "model" on the expert dim, the data axes'
split gathered before use, as every weight is): expert parallelism.

  * **Routing is global.**  The tokens are gathered whole on every rank
    (``n x d``), and every rank computes the same router logits, top-k,
    positions and capacity over all ``B*T`` tokens, as the reference's
    partitioned program does.
  * **Each rank computes its own share.**  A rank owns the experts of its
    "model" coordinate and, of their capacity slots, the contiguous
    range of its coordinate on the other axes; it fills an
    ``(E_local, cap_local, d)`` buffer from the tokens routed there and
    runs the three products on its own weight blocks.  No expert weight
    crosses "model".
  * **The combine is a partial sum.**  Each rank gathers its slots'
    gated outputs for the ``k x n`` entries (an entry of another rank's
    share reads a zero row) and adds the k choices in the compute dtype,
    as the single-device combine does; the ``(n, d)`` partials are
    reduced in the compute dtype over the mesh back to the tokens'
    placements (a reduce-scatter over the data axes, an all-reduce over
    "model").  That moves ``n x d`` a rank, where gathering the experts'
    ``(E, cap, d)`` outputs would move ``1.25 k`` times as much.
  * **Gradients.**  The routing's tensors are the same on every rank, so
    their gradients are too (``Replicate``); the tokens and gates that a
    rank's share reads get a partial gradient, summed over the mesh by
    DTensor's backward.  The aux terms (``lb_loss``, ``z_loss``,
    ``dropped_frac``) are the routing's and reach the router as before.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.u32 import MASK32

from .layers import silu

__all__ = ["dispatch_indices_sort", "dispatch_indices_cumsum", "moe_ffn", "top_k_lower"]


def _bits_for(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def dispatch_indices_sort(expert_id: torch.Tensor, n_experts: int):
    """Stable grouping by expert via the compressed key sort.

    expert_id: (M,) integer (M = N * top_k flat entries).  Returns
    ``(position_in_expert (M,), sort permutation (M,))``, both int32,
    where positions count 0.. within each expert in arrival order.
    """
    m = expert_id.shape[0]
    dev = expert_id.device
    be, bm = _bits_for(n_experts), _bits_for(m)
    arrival = torch.arange(m, dtype=torch.int64, device=dev)
    eid = expert_id.to(torch.int64)
    if be + bm <= 32:
        # one sort word: every key is distinct, so any sort is stable
        key = ((eid << bm) & MASK32) | arrival
        sorted_key = torch.sort(key).values
        perm = sorted_key & ((1 << bm) - 1)
        eid_sorted = sorted_key >> bm
    else:  # two words: a stable sort on the expert id, arrival as payload
        eid_sorted, perm = torch.sort(eid, stable=True)
    start = torch.searchsorted(eid_sorted, torch.arange(n_experts, dtype=torch.int64, device=dev))
    pos_sorted = arrival - start[eid_sorted]
    pos = torch.empty(m, dtype=torch.int64, device=dev)
    pos[perm] = pos_sorted
    return pos.to(torch.int32), perm.to(torch.int32)


def dispatch_indices_cumsum(expert_onehot: torch.Tensor) -> torch.Tensor:
    """GShard-style positions: cumulative sum of the one-hot matrix.

    expert_onehot: (M, E) {0,1}.  Returns position_in_expert (M,) int32.
    """
    pos = (torch.cumsum(expert_onehot, dim=0) - 1) * expert_onehot
    return pos.sum(dim=1).to(torch.int32)


def top_k_lower(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, ties broken toward the lower index (the
    order the reference's top-k gives): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xf, router, n_experts, top_k, capacity_factor, dispatch_mode):
    """The routing of all ``n`` tokens ``xf`` (n, d): the router's f32
    logits and probabilities, each flat (k-major) entry's expert, gate and
    token, the capacity, each entry's slot (``cap`` where it is dropped)."""
    n = xf.shape[0]
    logits = xf.float() @ router.float()  # (n, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k_lower(probs, top_k)  # (n, k)
    if top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)

    # flatten k-major so first choices win capacity contention
    e_flat = eidx.T.reshape(-1)  # (k*n,)
    g_flat = gate.T.reshape(-1)
    cap = max(8, math.ceil(n * top_k / n_experts * capacity_factor))

    if dispatch_mode == "sort":
        pos, _ = dispatch_indices_sort(e_flat, n_experts)
    elif dispatch_mode == "einsum":
        onehot = torch.nn.functional.one_hot(e_flat, n_experts).to(torch.int32)
        pos = dispatch_indices_cumsum(onehot)
    else:
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    keep = pos < cap
    slot = torch.where(keep, pos, cap).to(torch.int64)  # cap = dropped
    return logits, probs, eidx, e_flat, g_flat, cap, keep, slot


def _experts(xf, g_flat, e_flat, slot, w1, w3, w2, *, cap, e0, c0, cs, top_k):
    """The gated outputs of the experts ``[e0, e0 + E_local)`` over their
    slots ``[c0, c0 + cs)``: an (n, d) sum in ``xf``'s dtype.

    Each entry that lands in this share gets a flat slot of the
    ``(E_local * cs)`` buffer; every other entry (dropped at capacity, or
    another share's) goes to one slot past the end, which is cut off: the
    reference's fixed-shape scatter with its out-of-range slot.  The
    buffer holds each slot's entry, so only the share's rows of ``xf``
    are gathered; the combine gathers each entry's output back through
    the same flat slot."""
    n, d = xf.shape
    m = e_flat.shape[0]
    n_local = w1.shape[0]
    le, ls = e_flat - e0, slot - c0
    mine = (slot < cap) & (le >= 0) & (le < n_local) & (ls >= 0) & (ls < cs)
    trash = n_local * cs
    flat = torch.where(mine, le * cs + ls, trash)
    entry = torch.full((trash + 1,), m, dtype=torch.int64, device=xf.device)
    entry = entry.scatter(0, flat, torch.arange(m, dtype=torch.int64, device=xf.device))[:trash]
    valid = entry < m
    entry = entry.clamp(max=m - 1)
    tok = entry % n
    buf = torch.where(valid[:, None], xf[tok], 0).view(n_local, cs, d)

    h1 = torch.bmm(buf, w1)
    h3 = torch.bmm(buf, w3)
    y = torch.bmm(silu(h1) * h3, w2).view(n_local * cs, d)

    # combine: each slot's output weighted by its entry's gate in x's
    # dtype (the reference's per-entry product), a zero row past the end
    # for the entries outside this share, then each choice's n rows
    # gathered and added in x's dtype in a fixed order (choice 0 first).
    # Gathering a choice at a time keeps no (k*n, d) tensor, for the
    # backward or otherwise: on a mesh a rank's share is a small part of
    # the k*n entries
    gate = torch.where(valid, g_flat[entry], 0)
    vals = (y * gate[:, None].to(y.dtype)).to(xf.dtype)
    vals = torch.cat([vals, vals.new_zeros((1, d))])
    out = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(top_k):
        out = out + vals[flat[j * n:(j + 1) * n]]
    return out


def _aux(logits, probs, eidx, keep, n_experts):
    """Load balance (Switch), router z-loss and the dropped share."""
    me = torch.nn.functional.one_hot(eidx[:, 0], n_experts).float().mean(dim=0)
    ce = probs.mean(dim=0)
    return {
        "lb_loss": n_experts * (me * ce).sum(),
        "z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
    }


def _shared(p, x):
    return (silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def moe_ffn(
    p: dict,
    x: torch.Tensor,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    dispatch_mode: str = "einsum",
    shared_expert: bool = False,
) -> tuple[torch.Tensor, dict]:
    """x: (B, T, d) -> (B, T, d), plus aux metrics/losses."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(p, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor, dispatch_mode=dispatch_mode,
                            shared_expert=shared_expert)
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    logits, probs, eidx, e_flat, g_flat, cap, keep, slot = _route(
        xf, p["router"], n_experts, top_k, capacity_factor, dispatch_mode)
    out = _experts(xf, g_flat, e_flat, slot, p["moe_w1"], p["moe_w3"], p["moe_w2"],
                   cap=cap, e0=0, c0=0, cs=cap, top_k=top_k)
    if shared_expert:
        out = out + _shared(p, xf)
    return out.reshape(B, T, d), _aux(logits, probs, eidx, keep, n_experts)


def _moe_on_mesh(p, x, *, n_experts, top_k, capacity_factor, dispatch_mode, shared_expert):
    """:func:`moe_ffn` of DTensors: expert parallelism (module docstring).

    The experts split over a mesh dim where the weights are split on
    their expert dim (the rules put "model" there); the capacity slots of
    those experts split over every other mesh dim, contiguous ranges of
    ``ceil(cap / ways)`` in the order of the mesh's dims."""
    mesh = x.device_mesh
    ndim = mesh.ndim
    rep = [Replicate()] * ndim
    partial = [Partial()] * ndim
    B, T, d = x.shape
    n = B * T
    whole = x.redistribute(mesh, rep)
    # the routing: the same on every rank, and so its gradients
    xr = whole.to_local().reshape(n, d)
    router = p["router"].redistribute(mesh, rep).to_local()
    logits, probs, eidx, e_flat, g_flat, cap, keep, slot = _route(
        xr, router, n_experts, top_k, capacity_factor, dispatch_mode)
    # this rank's share reads the tokens and gates: partial gradients
    xp = whole.to_local(grad_placements=partial).reshape(n, d)
    gp = DTensor.from_local(g_flat, mesh, rep, run_check=False).to_local(grad_placements=partial)

    w = {k: p[k] for k in ("moe_w1", "moe_w3", "moe_w2")}
    coord = mesh.get_coordinate()
    e_dim = [i for i, pl in enumerate(w["moe_w1"].placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    split = [i for i in range(ndim) if i not in e_dim]
    n_local = n_experts
    e0 = 0
    for i in e_dim:  # at most one dim splits the experts as the rules stand
        n_local //= mesh.size(i)
        e0 = coord[i] * n_local
    ways, c_idx = 1, 0
    for i in split:
        c_idx = c_idx * mesh.size(i) + coord[i]
        ways *= mesh.size(i)
    cs = -(-cap // ways)
    # each weight: this rank's expert block, whole over every other dim;
    # its gradient is a partial sum over the dims that split the slots
    w_pl = [Shard(0) if i in e_dim else Replicate() for i in range(ndim)]
    g_pl = [Shard(0) if i in e_dim else Partial() for i in range(ndim)]
    wl = {k: v.redistribute(mesh, w_pl).to_local(grad_placements=g_pl) for k, v in w.items()}
    out = _experts(xp, gp, e_flat, slot, wl["moe_w1"], wl["moe_w3"], wl["moe_w2"],
                   cap=cap, e0=e0, c0=c_idx * cs, cs=cs, top_k=top_k)
    shape = (B, T, d)
    out = DTensor.from_local(out.view(shape), mesh, partial, run_check=False, shape=shape,
                             stride=(T * d, d, 1)).redistribute(mesh, x.placements)
    if shared_expert:
        out = out + _shared(p, x)
    # the aux terms go back on the mesh too, so that their gradients
    # reach the routing through DTensor's own backward
    aux = {k: DTensor.from_local(v, mesh, rep, run_check=False)
           for k, v in _aux(logits, probs, eidx, keep, n_experts).items()}
    return out, aux
