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

On a mesh the parameters, the moments and the batch are DTensors
(``launch.shardings.place``) and the step runs under DTensor's
``implicit_replication`` (``distributed.ctx.use_mesh`` enters it too).
``param_shardings`` pins every gradient, and the f32 accumulator, to the
parameters' placements: autograd leaves a gradient partial or sharded as
the backward's last op left it, and the pin reduce-scatters it to the
parameter's own block, so no rank holds a whole f32 gradient tree.  The
accumulator is made with the parameters' placements (each rank its
block).  The loss is summed over the microbatches on the mesh, and the
loss and the metrics come back as plain tensors holding the whole value
(the same on every rank).
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.lm import LM

from .optim import OptConfig, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = ["make_train_step", "init_train_state"]


def init_train_state(model: LM, generator: torch.Generator):
    """Master parameters from ``generator`` and a zero AdamW state."""
    params = model.init_master(generator)
    return params, adamw_init(params)


def _replicated(x):
    """A DTensor scalar as a replicated one on its mesh; a tensor as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def _value(x):
    """A metric as a plain tensor: a DTensor's whole (replicated) value."""
    return _replicated(x).to_local() if isinstance(x, DTensor) else x


def _micro(v, i: int, accum: int):
    """Microbatch ``i`` of ``accum`` of a batch leaf: its rows
    ``[i*b, (i+1)*b)``, ``b = B/accum``, as the reference's reshape to
    ``(accum, b, ...)`` takes them; a DTensor's slice is put back on its
    placements."""
    b = v.shape[0] // accum
    if isinstance(v, DTensor):
        return v[i * b:(i + 1) * b].redistribute(v.device_mesh, v.placements)
    return v.reshape((accum, b) + tuple(v.shape[1:]))[i]


def make_train_step(model: LM, opt_cfg: OptConfig, accum: int = 1, param_shardings=None):
    def pin(grads, params):
        """Each gradient on its parameter's placements (a no-op off a mesh)."""
        if param_shardings is None:
            return grads
        return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                        if isinstance(g, DTensor) else g, grads, params)

    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(live, mb)
        got = iter(torch.autograd.grad(loss, tree_leaves(live), allow_unused=True))

        def grad_of(p):  # a leaf the loss does not read (musicgen's embedding): zeros
            g = next(got)
            return torch.zeros_like(p) if g is None else g

        grads = pin(tree_map(grad_of, live), params)
        return (_replicated(loss.detach()),
                {k: _replicated(v.detach()) for k, v in metrics.items()}, grads)

    def train_step(params, opt, batch):
        batch = {k: v if isinstance(v, DTensor) else model._input(v) for k, v in batch.items()}
        sharded = param_shardings is not None
        with implicit_replication() if sharded else contextlib.nullcontext():
            if accum == 1:
                loss, metrics, grads = grad_fn(params, batch)
            else:
                # the accumulator is this step's own, on the parameters'
                # placements: summed and scaled in place, so a full-width
                # model holds one gradient tree beside it
                grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
                loss = 0
                ms = []
                for i in range(accum):
                    l_i, m_i, g_i = grad_fn(params, {k: _micro(v, i, accum)
                                                     for k, v in batch.items()})
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
            metrics = {k: _value(v) for k, v in {**metrics, **opt_metrics, "loss": loss}.items()}
        return params, opt, metrics

    # one microbatch's forward and backward, pinned: the dry run traces it
    # alone (``launch/dryrun.py``)
    train_step.grad_fn = grad_fn
    return train_step
