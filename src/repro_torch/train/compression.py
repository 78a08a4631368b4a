"""Gradient compression for the slow (cross-node) all-reduce.

int8 quantization with per-leaf scale and **error feedback** (the residual
of each round is added back before the next quantization — 1-bit Adam /
EF-SGD style), run over a ``torch.distributed`` process group in place of
the reference's ``shard_map`` axis: each rank calls
``compressed_allreduce_grads`` with its own gradients and residuals.  As
in the reference, the sum carries each rank's dequantised f32 values
(``q * scale``), so the two packages' sums agree; the int8 payload and
its scale are what a wire format would ship.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .optim import tree_map, tree_pick

__all__ = ["ef_init", "compressed_psum", "compressed_allreduce_grads"]


def ef_init(grads) -> dict:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, ef: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce of one leaf over ``group`` (the
    default group unless named).

    Returns (mean-reduced f32 value, new error-feedback residual).
    """
    xf = x.to(torch.float32) + ef
    q, scale = _quantize(xf)
    deq = q.to(torch.float32) * scale
    new_ef = xf - deq
    summed = deq.clone()
    dist.all_reduce(summed, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32)
    return summed / n.to(summed.device), new_ef


def compressed_allreduce_grads(grads, ef, group=None):
    """Tree version: mean-reduce grads across ``group`` with int8+EF."""
    outs = tree_map(lambda g, e: compressed_psum(g, e, group), grads, ef)
    return tree_pick(outs, 0), tree_pick(outs, 1)
