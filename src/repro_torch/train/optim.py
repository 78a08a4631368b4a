"""AdamW + LR schedules, from scratch, as the reference writes them.

Optimizer state mirrors the parameter tree (``m`` and ``v``, f32) plus an
int32 ``step``.  Every formula runs in f32 on tensors in the reference's
order of operations: the schedule's step and the bias corrections are f32
tensors, never Python floats, so the two packages round alike.  Trees are
nested dicts of tensors, walked in sorted key order (the reference's
pytree order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at", "global_norm",
           "tree_leaves", "tree_map", "tree_pick"]

_F32 = torch.float32


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``, in
    :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_pick(tree, i: int):
    """Item ``i`` of every tuple leaf of ``tree``."""
    return tree_map(lambda t: t[i], tree)


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine to ``min_lr_ratio`` of
    it over ``decay_steps``: a () f32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(_F32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def adamw_init(params) -> dict:
    """Zero moments on the parameters' devices (on a mesh, with the
    parameters' placements: each rank its block) and a zero ``step``
    (replicated on the mesh)."""
    first = tree_leaves(params)[0]
    zeros = lambda p: tree_map(lambda x: torch.zeros_like(x, dtype=_F32), p)
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(torch.zeros((), dtype=torch.int32, device=first.device),
                                  mesh, [Replicate()] * mesh.ndim, run_check=False)
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"m": zeros(params), "v": zeros(params), "step": step}


def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm over every leaf; over DTensor leaves, of the whole
    tensors (the sums of squares reduce over the mesh)."""
    s = 0
    for x in tree_leaves(tree):
        s = s + torch.sum(torch.square(x.to(_F32)))
    return torch.sqrt(s)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, opt):
    """One AdamW step: ``(params, opt, {lr, grad_norm})``.

    The global gradient norm clips every gradient; the decoupled weight
    decay applies to leaves of two or more dims *as stored*: a norm weight
    stacked over superblocks, ``(nsb, d)``, is decayed, as in the
    reference, and ``final_norm`` ``(d,)`` is not.

    The parameters and the moments are updated in place and returned
    (with a new ``step``), as the reference's launcher
    (``launch/train.py``) donates them to its jitted step: a full-width
    model then holds one copy of its state.  DTensor leaves (gradients on
    their parameters' placements) are updated block by block and keep
    their placements; call it under ``implicit_replication`` (the train
    step does), where the scalars meet them.
    """
    step = opt["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(_F32)
    bc2 = 1 - cfg.b2 ** step.to(_F32)

    def upd(p, g, m, v):
        # the reference's expressions, operation for operation
        g = g.to(_F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step_ = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        step_.add_(wd * p.to(_F32)).mul_(lr)
        p.copy_(p.to(_F32) - step_)

    tree_map(upd, params, grads, opt["m"], opt["v"])
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, {"lr": lr, "grad_norm": gnorm}
