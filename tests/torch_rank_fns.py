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


def _flat(tree, prefix=""):
    """A nested dict's leaves by "/"-joined path, in sorted key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _gathered(tree) -> dict:
    """Every DTensor leaf gathered whole (a collective on every rank), as
    numpy, by path."""
    return {k: v.full_tensor().detach().numpy().copy() for k, v in _flat(tree).items()}


def mesh_rank(rank, p, inputs_path):
    """The mesh layer on a (2, 2) ("data", "model") mesh over the default
    group: the sharded train step of the reduced llama3-8b at accum 1 and
    2 (each from the same start), the elastic restore of a checkpoint the
    reference saved, and the reduced qwen3-moe sort-dispatch loss under
    ``use_mesh``.  ``inputs_path`` holds the parent's pickled numpy inputs.
    Rank 0 returns the gathered results; the others return None."""
    import pickle

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import ARCHS
    from repro_torch.convert import lm_master_from_numpy
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.launch.shardings import batch_shardings, params_shardings, place
    from repro_torch.models.lm import LM
    from repro_torch.train import optim
    from repro_torch.train.trainstep import make_train_step

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"step": {}}

    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    p_sh = params_shardings(mesh, inp["params"])
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    for accum in (1, 2):
        params = place(lm_master_from_numpy(inp["params"], model), p_sh)
        opt = optim.adamw_init(params)
        step = make_train_step(model, inp["opt_cfg"], accum=accum, param_shardings=p_sh)
        with use_mesh(mesh):
            params, opt, metrics = step(params, opt, place(batch, batch_shardings(mesh, batch)))
        out["step"][accum] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _gathered(params),
            "m": _gathered(opt["m"]),
            "placements": {k: (str(v.placements), str(_flat(opt["m"])[k].placements))
                           for k, v in _flat(params).items()},
        }

    # elastic restore: the reference's unsharded checkpoint onto the mesh
    like = inp["params"]
    got, stats = restore_checkpoint(inp["ckpt_dir"], 1, like, backend="torch",
                                    index_device="cpu", shardings=params_shardings(mesh, like))
    out["restore"] = {
        "leaves": {k: v.full_tensor().numpy().tobytes() for k, v in _flat(got).items()},
        "placements": {k: str(v.placements) for k, v in _flat(got).items()},
        "n_leaves": stats["n_leaves"],
    }

    # the MoE's compressed-key-sort dispatch on the mesh
    moe = LM(inp["moe_cfg"], compute_dtype=torch.float32, device="cpu")
    mp = lm_master_from_numpy(inp["moe_params"], moe)
    mb = {k: torch.from_numpy(v) for k, v in inp["moe_batch"].items()}
    with use_mesh(mesh), torch.no_grad():
        loss, _ = moe.loss(place(mp, params_shardings(mesh, mp)),
                           place(mb, batch_shardings(mesh, mb)))
    out["moe_loss"] = float(loss.full_tensor())
    return out if rank == 0 else None
