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

On a mesh (DTensor activations) the layer runs on whole tensors on every
rank: the dispatch is global over the ``B*T`` tokens (the capacity
counts them all) and its integer steps (sort, searchsorted, masked
scatter) have no DTensor sharding rules, so the tokens, the router and
the expert weights are gathered, replicated, and the output goes back to
the tokens' placements.  Expert parallelism is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

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
        mesh = x.device_mesh
        rep = [Replicate()] * mesh.ndim
        used = ("router", "moe_w1", "moe_w3", "moe_w2") + (("w1", "w3", "w2") if shared_expert else ())
        whole = {k: p[k].redistribute(mesh, rep).to_local() for k in used}
        out, aux = moe_ffn(whole, x.redistribute(mesh, rep).to_local(), n_experts=n_experts,
                           top_k=top_k, capacity_factor=capacity_factor,
                           dispatch_mode=dispatch_mode, shared_expert=shared_expert)
        # the aux terms go back on the mesh too, so that their gradients
        # reach the whole-tensor region through DTensor's own backward
        on_mesh = lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
        aux = {k: on_mesh(v) for k, v in aux.items()}
        return on_mesh(out).redistribute(mesh, x.placements), aux
    B, T, d = x.shape
    n = B * T
    xf = x.reshape(n, d)

    logits = xf.float() @ p["router"].float()  # (n, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k_lower(probs, top_k)  # (n, k)
    if top_k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)

    # flatten k-major so first choices win capacity contention
    e_flat = eidx.T.reshape(-1)  # (k*n,)
    g_flat = gate.T.reshape(-1)
    t_flat = torch.arange(n, device=x.device).repeat(top_k)
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

    # kept entries own unique (expert, slot) pairs: an indexed write
    buf = torch.zeros((n_experts, cap, d), dtype=x.dtype, device=x.device)
    buf[e_flat[keep], slot[keep]] = xf[t_flat[keep]]

    h1 = torch.bmm(buf, p["moe_w1"])
    h3 = torch.bmm(buf, p["moe_w3"])
    y = torch.bmm(silu(h1) * h3, p["moe_w2"])

    # combine: each kept entry's expert output, weighted by its gate, then
    # the k choices of each token summed in a fixed order (choice 0 first)
    out_e = y[e_flat, slot.clamp(max=cap - 1)]
    out_e = torch.where(keep[:, None], out_e, 0)
    contrib = (out_e * g_flat[:, None].to(out_e.dtype)).to(x.dtype).reshape(top_k, n, d)
    out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + contrib[j]

    if shared_expert:
        hs = silu(xf @ p["w1"]) * (xf @ p["w3"])
        out = out + hs @ p["w2"]

    # aux: load-balance (Switch) + router z-loss
    me = torch.nn.functional.one_hot(eidx[:, 0], n_experts).float().mean(dim=0)
    ce = probs.mean(dim=0)
    aux = {
        "lb_loss": n_experts * (me * ce).sum(),
        "z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return out.reshape(B, T, d), aux
