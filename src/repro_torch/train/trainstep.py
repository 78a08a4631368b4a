"""The train step: microbatched grad accumulation + AdamW.

The returned step is a function ``(params, opt, batch) -> (params, opt,
metrics)`` over master parameters (``LM.init_master``): gradients come
from ``torch.autograd`` on ``LM.loss`` with respect to detached views of
the f32 leaves, and AdamW writes the new values into ``params`` and the
moments, as the reference's launcher donates both to its jitted step.
Gradient accumulation reshapes every batch leaf to ``(accum, B/accum,
...)`` and loops over the microbatches: f32 gradients are summed, then
divided by ``accum``; the loss and every metric are averaged, as the
reference's ``scan`` does.  Peak memory is the state (master parameters,
both moments, the accumulator and one microbatch's gradient tree) plus
one microbatch's activations.  With the model's ``remat`` (the default)
those are the superblocks' inputs and their ``mm`` outputs, the loss's
logits chunks, and, while one superblock's backward runs, that
superblock's recomputed intermediates; each microbatch's graph, and the
checkpoints in it, is freed when ``torch.autograd.grad`` returns.

The reference also pins the gradient accumulator's sharding to the
parameters' (``param_shardings``) so that GSPMD does not replicate it;
one device holds every tensor whole, so the port has nothing to pin.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LM

from .optim import OptConfig, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = ["make_train_step", "init_train_state"]


def init_train_state(model: LM, generator: torch.Generator):
    """Master parameters from ``generator`` and a zero AdamW state."""
    params = model.init_master(generator)
    return params, adamw_init(params)


def make_train_step(model: LM, opt_cfg: OptConfig, accum: int = 1):
    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(live, mb)
        got = iter(torch.autograd.grad(loss, tree_leaves(live), allow_unused=True))

        def grad_of(p):  # a leaf the loss does not read (musicgen's embedding): zeros
            g = next(got)
            return torch.zeros_like(p) if g is None else g

        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_map(grad_of, live)

    def train_step(params, opt, batch):
        batch = {k: model._input(v) for k, v in batch.items()}
        if accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            mbs = {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            # the accumulator is this step's own: summed and scaled in place,
            # so a full-width model holds one gradient tree beside it
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            ms = []
            for i in range(accum):
                l_i, m_i, g_i = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                for a, b in zip(tree_leaves(grads), tree_leaves(g_i)):
                    a.add_(b.to(torch.float32))
                del g_i
                loss = loss + l_i
                ms.append(m_i)
            for g in tree_leaves(grads):
                g.div_(accum)
            loss = loss / accum
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
        params, opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt)
        return params, opt, {**metrics, **opt_metrics, "loss": loss}

    return train_step
