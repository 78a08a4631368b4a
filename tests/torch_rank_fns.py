"""Rank functions for the 4-rank gloo groups of the port's tests.

The spawned ranks import this module to find the function they run, so it
imports neither JAX nor the reference package.
"""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


class _GatherLog(TorchDispatchMode):
    """Records each all-gather's mesh group and result shape, as
    ``(group_name, shape)``, while entered (DTensor's redistributes issue
    their functional collectives through the dispatch modes)."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops._c10d_functional.all_gather_into_tensor.default:
            self.log.append((args[2], tuple(out.shape)))
        return out


def mesh_rank(rank, p, inputs_path):
    """The mesh layer on a (2, 2) ("data", "model") mesh over the default
    group: the sharded train step of the reduced llama3-8b at accum 1 and
    2 (each from the same start), the elastic restore of a checkpoint the
    reference saved, the reduced qwen3-moe sort-dispatch loss under
    ``use_mesh`` and its sharded train step (expert parallelism), and the
    reduced llama3-8b's prefill and decode steps on a cache split over
    "model" on its sequence dim, with ``decode_attention``'s collectives
    counted alone.  ``inputs_path`` holds the parent's pickled numpy
    inputs.  Rank 0 returns the gathered results; the others return None."""
    import pickle

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import ARCHS
    from repro_torch.convert import lm_master_from_numpy, lm_params_from_numpy
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.launch.opcount import OpCounter
    from repro_torch.launch.shardings import (batch_shardings, cache_shardings,
                                              params_shardings, place)
    from repro_torch.models.layers import decode_attention
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

    # expert parallelism: one sharded train step of the same MoE
    m_sh = params_shardings(mesh, mp)
    pm = place(lm_master_from_numpy(inp["moe_params"], moe), m_sh)
    om = optim.adamw_init(pm)
    step = make_train_step(moe, inp["opt_cfg"], accum=1, param_shardings=m_sh)
    with use_mesh(mesh), _GatherLog() as gathers:
        pm, om, metrics = step(pm, om, place(mb, batch_shardings(mesh, mb)))
    model_group = mesh.get_group("model").group_name
    out["moe_step"] = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params": _gathered(pm),
        "placements": {k: (str(v.placements), str(_flat(om["m"])[k].placements),
                           str(_flat(om["v"])[k].placements))
                       for k, v in _flat(pm).items()},
        "model_gathers": [shape for group, shape in gathers.log if group == model_group],
        "n_gathers": len(gathers.log),
    }

    # decode on the mesh: the cache split over "model" on its sequence dim;
    # the prefill's write of T tokens straddles the two ranks' slices
    srv = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    sp = lm_params_from_numpy(inp["params"], srv)
    spm = place(sp, params_shardings(mesh, sp))
    c0 = srv.init_cache(*inp["cache_shape"])
    cm = place(c0, cache_shardings(mesh, srv.cfg, c0))
    tokens, dec = torch.from_numpy(inp["batch"]["tokens"]), torch.from_numpy(inp["dec_tokens"])
    logits = []
    with use_mesh(mesh), torch.no_grad():
        b = {"tokens": tokens}
        cm, lg = srv.prefill(spm, place(b, batch_shardings(mesh, b)), cm)
        logits.append(lg.full_tensor().numpy())
        for i in range(dec.shape[1]):
            b = place({"token": dec[:, i]}, batch_shardings(mesh, {"token": dec[:, i]}))
            b["pos"] = tokens.shape[1] + i
            cm, lg = srv.decode_step(spm, cm, b)
            logits.append(lg.full_tensor().numpy())
    out["decode"] = {"logits": logits,
                     "cache": {k: v.full_tensor().numpy() for k, v in cm["0"].items()},
                     "placements": str(cm["0"]["k"].placements)}
    # decode_attention alone: the query whole in heads, the cache split on
    # its sequence dim; only the partials may cross
    a = inp["attn"]
    q = distribute_tensor(torch.from_numpy(a["q"]), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    kv = [distribute_tensor(torch.from_numpy(a[n]), mesh, [Shard(0), Shard(2)],
                            src_data_rank=None) for n in ("k", "v")]
    with use_mesh(mesh), torch.no_grad():
        with OpCounter() as ops:
            o = decode_attention(q, *kv, torch.from_numpy(a["length"]), kv_chunk=a["kv_chunk"])
        out["decode_attn"] = {"out": o.full_tensor().numpy(), "ops": ops.summary(),
                              "placements": str(o.placements)}
    return out if rank == 0 else None
