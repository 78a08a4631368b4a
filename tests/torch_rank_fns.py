"""Rank functions for the 4-rank gloo groups of the port's tests.

The spawned ranks import this module to find the function they run, so it
imports neither JAX nor the reference package.
"""

import numpy as np
import torch


def compressed_rounds(rank, p, rounds):
    """``compressed_allreduce_grads`` over the default group, one call a
    round; ``rounds`` is a list of {leaf: (p, ...) f32} arrays, rank ``r``
    taking row ``r``.  Returns each round's (mean, residual) as numpy."""
    from repro_torch.train.compression import compressed_allreduce_grads, ef_init

    out, ef = [], None
    for g in rounds:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[rank])) for k, v in g.items()}
        ef = ef_init(mine) if ef is None else ef
        mean, ef = compressed_allreduce_grads(mine, ef)
        out.append(({k: v.numpy() for k, v in mean.items()},
                    {k: v.numpy() for k, v in ef.items()}))
    return out
