"""The mesh layer of the port (``repro_torch.distributed``,
``launch/{mesh,shardings,opcount,dryrun,roofline}.py``, ``input_specs``,
the sharded train step and the elastic restore) against the JAX package.

* ``param_spec`` over every leaf of every arch's reduced and full
  parameter tree (the reference's paths from ``LM.param_struct()``);
  ``guard_spec``, ``params_shardings`` and ``cache_shardings`` at (2, 2),
  (16, 16) and (2, 16, 16), the reference's functions given a stand-in
  mesh with ``.shape`` and ``.axis_names`` (its ``NamedSharding`` swapped
  for the bare spec, since it accepts only a real mesh); ``input_specs``
  (keys, shapes, dtypes); ``workload_model`` for every arch x shape at 4,
  256 and 512 chips — all equal.
* ONE 4-rank gloo group (``tests/torch_rank_fns.mesh_rank``, started once
  for the module) on a (2, 2) ("data", "model") mesh runs the reduced
  llama3-8b's sharded step at accum 1 and 2, restores a checkpoint the
  reference saved, and runs the reduced qwen3-moe sort-dispatch loss under
  ``use_mesh``.  Tolerances: the sharded step splits the sums of the
  tensor-parallel products (``wo``, ``w2``, the head) and of the
  gradients' reductions over the mesh, so it is not equal to the bit:
  the loss and the metrics within 1e-5 relative of the port's unsharded
  step, the first moments (f32 gradients times 0.1) within 1e-4 of their
  scale, the parameters within 2e-5 absolute (the bound the unsharded
  step is held to against the reference, two thirds of one AdamW step at
  this learning rate, 3e-5), and against the reference's
  ``make_train_step`` the same bounds as the unsharded step (loss 1e-3
  relative, parameters 2e-5).  The restore is equal to the bit.
* A fake dry run of the reduced llama3-8b on a (2, 2) mesh ends ``ok``;
  its per-device ``dot_flops`` times 4 lie between the unsharded step's
  (6·N·D less the embedding table, plus the attention blocks) and a
  quarter more, and within 10 % of the reference's ``analyze_hlo`` of the
  same cell (compiled in one subprocess with 4 host devices).
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ckpt.checkpoint import save_checkpoint as ref_save_checkpoint  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import shardings as ref_shardings  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.models.lm import input_specs as ref_input_specs  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.train.trainstep import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.convert import lm_master_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import roofline, shardings  # noqa: E402
from repro_torch.models.lm import LM, input_specs  # noqa: E402
from repro_torch.tools.rankgroup import run_group  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_rank_fns  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")), "pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
REF_OPT = ref_optim.OptConfig(warmup_steps=10, decay_steps=50)
OPT = optim.OptConfig(warmup_steps=10, decay_steps=50)
B, T = 4, 32
#: the decode cache's length: its halves (the (2, 2) mesh's "model" split)
#: hold 24 positions each, so the prefill's write of T = 32 straddles them
S_DEC, N_DEC = 48, 3


def _stand_in(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _key(k) -> str:
    return str(k.key) if hasattr(k, "key") else str(k)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _spec(s) -> tuple:
    return tuple(s)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_matches_reference_on_every_leaf(arch, reduced):
    rcfg = REF_ARCHS[arch].reduced() if reduced else REF_ARCHS[arch]
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    want = _ref_flat(RefLM(rcfg).param_struct())
    got = _flat(LM(cfg, device="cpu").param_struct())
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert _spec(sharding.param_spec(path, got[path])) == _spec(
            ref_sharding.param_spec(path, leaf)), path
        assert _spec(sharding.param_spec(path)) == _spec(ref_sharding.param_spec(path)), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_guard_params_and_cache_shardings_match_reference(mesh, monkeypatch):
    """Every arch's full parameter tree and its decode and long-context
    caches (the rule for each cache leaf, then the divisibility guard)."""
    monkeypatch.setattr(ref_shardings, "NamedSharding", lambda m, spec: spec)
    m = _stand_in(mesh)
    assert _spec(sharding.batch_spec(m)) == _spec(ref_sharding.batch_spec(m))
    for arch in sorted(ARCHS):
        rlm, lm = RefLM(REF_ARCHS[arch]), LM(ARCHS[arch], device="cpu")
        want = _ref_flat(ref_shardings.params_shardings(m, rlm.param_struct()))
        got = _flat(shardings.params_shardings(m, lm.param_struct()))
        assert {k: _spec(v.spec) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
        want = _ref_flat(ref_shardings.params_shardings(m, rlm.param_struct(), serve_tp_only=True))
        got = _flat(shardings.params_shardings(m, lm.param_struct(), serve_tp_only=True))
        assert {k: _spec(v.spec) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
        for batch, seq in ((128, 32768), (1, 524288), (3, 64)):
            want = _ref_flat(ref_shardings.cache_shardings(m, REF_ARCHS[arch],
                                                           rlm.cache_struct(batch, seq)))
            got = _flat(shardings.cache_shardings(m, ARCHS[arch], lm.cache_struct(batch, seq)))
            assert sorted(got) == sorted(want)
            assert {k: _spec(v.spec) for k, v in got.items()} == {
                k: _spec(v) for k, v in want.items()}, (arch, batch, seq)
    for spec, shape in (((("pod", "data"), "model"), (64, 32)), (("data", None, "model"), (3, 4, 16)),
                        (("model", "data"), (8, 2)), ((), (5,)), (("data",), (1, 7))):
        if "pod" in str(spec) and mesh != "pod2":
            continue
        assert _spec(shardings.guard_spec(m, P(*spec), shape)) == _spec(
            ref_shardings.guard_spec(m, ref_sharding.P(*spec), shape)), (spec, shape)


def test_to_placements_follows_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.to_placements(mesh, P(None, "data", "model"), 3) == (
        Replicate(), Shard(1), Shard(2))
    assert sharding.to_placements(mesh, P(("pod", "data"), None), 2) == (
        Shard(0), Shard(0), Replicate())
    assert sharding.to_placements(mesh, P("model", "data"), 2) == (Replicate(), Shard(1), Shard(0))
    assert sharding.to_placements(mesh, P(), 2) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sharding.to_placements(mesh, P(("data", "pod")), 1)


_DT = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def test_input_specs_match_reference():
    for arch in sorted(ARCHS):
        for name in SHAPES:
            want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[name])
            got = input_specs(ARCHS[arch], SHAPES[name])
            assert sorted(got) == sorted(want), (arch, name)
            for k, v in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(v.shape), (arch, name, k)
                assert got[k].dtype == _DT[str(v.dtype)], (arch, name, k)


def test_workload_model_matches_reference():
    for arch in sorted(ARCHS):
        for name in SHAPES:
            for chips in (4, 256, 512):
                assert roofline.workload_model(ARCHS[arch], SHAPES[name], chips) == \
                    ref_roofline.workload_model(REF_ARCHS[arch], REF_SHAPES[name], chips)


def test_roofline_reads_both_packages_records():
    """The port's ``analyze_cell`` reads its own ``op_summary`` and the
    reference's ``hlo_summary`` alike, at the H100's peaks."""
    base = {"arch": "llama3-8b", "shape": "train_4k", "mesh": "pod1", "status": "ok",
            "n_devices": 256}
    summary = {"dot_flops": 2.0e15, "collective_bytes": {"all-gather": 3.0e10, "all-reduce": 1.0e9}}
    a = roofline.analyze_cell({**base, "op_summary": summary})
    b = roofline.analyze_cell({**base, "hlo_summary": summary})
    assert a == b
    assert a["t_compute_s"] == 2.0e15 / 989e12
    assert a["t_collective_s"] == 3.1e10 / 450e9
    assert roofline.analyze_cell({**base, "status": "error"}) is None


# ---------------------------------------------------------------------------
# one 4-rank gloo group for the module
# ---------------------------------------------------------------------------


def _moe_cfgs():
    from dataclasses import replace

    return (replace(REF_ARCHS["qwen3-moe-235b-a22b"].reduced(), dispatch_mode="sort"),
            replace(ARCHS["qwen3-moe-235b-a22b"].reduced(), dispatch_mode="sort"))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    rcfg = REF_ARCHS["llama3-8b"].reduced()
    ref = RefLM(rcfg, compute_dtype=jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(0, rcfg.vocab_size, (B, T)).astype(np.int32)}
    ckpt = d / "ckpt"
    ref_save_checkpoint(str(ckpt), 1, raw)
    rmoe_cfg, moe_cfg = _moe_cfgs()
    rmoe = RefLM(rmoe_cfg, compute_dtype=jnp.float32, remat=False)
    moe_raw = jax.tree_util.tree_map(np.asarray, rmoe.init(jax.random.PRNGKey(1)))
    moe_batch = {"tokens": rng.integers(0, rmoe_cfg.vocab_size, (B, T)).astype(np.int32),
                 "labels": rng.integers(0, rmoe_cfg.vocab_size, (B, T)).astype(np.int32)}
    dec_tokens = rng.integers(0, rcfg.vocab_size, (B, N_DEC)).astype(np.int32)
    attn = {"q": rng.normal(size=(B, rcfg.n_heads, 1, rcfg.hd)).astype(np.float32),
            "k": rng.normal(size=(B, rcfg.n_kv_heads, S_DEC, rcfg.hd)).astype(np.float32),
            "v": rng.normal(size=(B, rcfg.n_kv_heads, S_DEC, rcfg.hd)).astype(np.float32),
            "length": np.array([S_DEC, 30, S_DEC // 2, 7], np.int64), "kv_chunk": 16}
    inputs = d / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"params": raw, "batch": batch, "opt_cfg": OPT, "ckpt_dir": str(ckpt),
                     "moe_cfg": moe_cfg, "moe_params": moe_raw, "moe_batch": moe_batch,
                     "dec_tokens": dec_tokens, "cache_shape": (B, S_DEC), "attn": attn}, f)
    # the reference's HLO count of the dry-run cell, compiled meanwhile
    hlo = subprocess.Popen([sys.executable, "-c", _REF_DRYRUN], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "PYTHONPATH": SRC,
                                "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    ranks = run_group(torch_rank_fns.mesh_rank, 4, str(inputs), timeout=120.0, deadline=600.0)
    out, err = hlo.communicate(timeout=600)
    assert hlo.returncode == 0, err[-3000:]
    return {"raw": raw, "batch": batch, "ref": ref, "moe": (rmoe, moe_cfg, moe_raw, moe_batch),
            "dec_tokens": dec_tokens, "attn": attn,
            "got": ranks[0], "ref_hlo": json.loads(out.strip().splitlines()[-1]),
            "tmp": d}


def _close_rel(got, want, tol, what):
    assert abs(float(got) - float(want)) <= tol * max(abs(float(want)), 1e-12), (what, got, want)


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_step_matches_unsharded_and_reference(group, accum):
    raw, batch, ref = group["raw"], group["batch"], group["ref"]
    got = group["got"]["step"][accum]
    # the port's unsharded step
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    params = lm_master_from_numpy(raw, model)
    up, uo, um = make_train_step(model, OPT, accum=accum)(params, optim.adamw_init(params), batch)
    for k, v in um.items():
        _close_rel(got["metrics"][k], v, 1e-5, k)
    for path, want in _flat(lm_params_to_numpy(up)).items():
        np.testing.assert_allclose(got["params"]["/".join(path)], want, atol=2e-5, err_msg=str(path))
    for path, want in _flat(lm_params_to_numpy(uo["m"])).items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got["m"]["/".join(path)], want, atol=1e-4 * scale,
                                   err_msg=str(path))
    # the reference's step
    wp, _, wm = jax.jit(ref_make_train_step(ref, REF_OPT, accum=accum))(
        raw, ref_optim.adamw_init(raw), jax.tree_util.tree_map(jnp.asarray, batch))
    _close_rel(got["metrics"]["loss"], wm["loss"], 1e-3, "loss")
    for path, want in _ref_flat(wp).items():
        np.testing.assert_allclose(got["params"]["/".join(path)], np.asarray(want), atol=2e-5,
                                   err_msg=str(path))
    # parameters and moments keep the rules' placements
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    for name, (p_pl, m_pl) in got["placements"].items():
        path = tuple(name.split("/"))
        leaf = _flat(raw)[path]
        want_pl = str(sharding.to_placements(
            mesh, shardings.guard_spec(mesh, sharding.param_spec(path, leaf), leaf.shape),
            leaf.ndim))
        assert p_pl == want_pl == m_pl, name


def test_elastic_restore_of_a_reference_checkpoint_onto_the_mesh(group):
    """The twin of the reference's elastic-restore test: every leaf equal
    to the bit, each on the placements the rules give."""
    got = group["got"]["restore"]
    flat = _flat(group["raw"])
    assert got["n_leaves"] == len(flat)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    sharded = 0
    for path, leaf in flat.items():
        name = "/".join(path)
        assert got["leaves"][name] == np.ascontiguousarray(leaf).tobytes(), name
        spec = shardings.guard_spec(mesh, sharding.param_spec(path, leaf), leaf.shape)
        assert got["placements"][name] == str(sharding.to_placements(mesh, spec, leaf.ndim))
        sharded += "Shard" in got["placements"][name]
    assert sharded >= 8  # wq/wk/wv/wo/w1/w2/w3, embed, lm_head


def test_moe_sort_dispatch_under_mesh(group):
    """The twin of the reference's MoE-under-mesh test: the sharded loss
    equals the unsharded one within 1e-5 and the reference's within 1e-4
    (the f32 bound of ``tests/test_torch_train.py``)."""
    rmoe, moe_cfg, moe_raw, moe_batch = group["moe"]
    got = group["got"]["moe_loss"]
    assert np.isfinite(got)
    moe = LM(moe_cfg, compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        unsharded, _ = moe.loss(lm_master_from_numpy(moe_raw, moe), moe_batch)
    _close_rel(got, unsharded, 1e-5, "unsharded")
    want, _ = jax.jit(rmoe.loss)(moe_raw, jax.tree_util.tree_map(jnp.asarray, moe_batch))
    _close_rel(got, want, 1e-4, "reference")


_REF_DRYRUN = textwrap.dedent("""
    import dataclasses
    import json
    import jax
    import jax.numpy as jnp
    from repro.compat import make_mesh, set_mesh
    from repro.configs import ARCHS
    from repro.configs.base import ShapeConfig
    from repro.launch.hloanalysis import analyze_hlo
    from repro.launch.shardings import (batch_shardings, cache_shardings, opt_shardings,
                                        params_shardings, replicated)
    from repro.models.lm import LM, input_specs
    from repro.train.optim import OptConfig, adamw_init
    from repro.train.trainstep import make_train_step
    mesh = make_mesh((2, 2), ("data", "model"))

    def train(cfg, shape):
        model = LM(cfg)
        ps = model.param_struct()
        p_sh = params_shardings(mesh, ps)
        bs = input_specs(cfg, shape)
        os_ = jax.eval_shape(adamw_init, ps)
        step = make_train_step(model, OptConfig(), accum=1, param_shardings=p_sh)
        o_sh = opt_shardings(mesh, os_, p_sh)
        fn = jax.jit(step, in_shardings=(p_sh, o_sh, batch_shardings(mesh, bs)),
                     out_shardings=(p_sh, o_sh, replicated(mesh)), donate_argnums=(0, 1))
        with set_mesh(mesh):
            return fn.lower(ps, os_, bs).compile()

    def decode(cfg, shape):  # the reference dry run's serving cell
        model = LM(cfg)
        ps = model.param_struct()
        sp = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if (s.dtype == jnp.float32 and len(s.shape) >= 2)
            else s.dtype), ps)
        cs = model.cache_struct(shape.global_batch, shape.seq_len)
        bs = input_specs(cfg, shape)
        fn = jax.jit(model.decode_step, in_shardings=(
            params_shardings(mesh, ps), cache_shardings(mesh, cfg, cs), batch_shardings(mesh, bs)),
            out_shardings=(cache_shardings(mesh, cfg, cs), replicated(mesh)), donate_argnums=(1,))
        with set_mesh(mesh):
            return fn.lower(sp, cs, bs).compile()

    moe = dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"].reduced(), dispatch_mode="sort")
    cells = {"train": (train, ARCHS["llama3-8b"].reduced(), ShapeConfig("small", "train", 32, 4)),
             "decode": (decode, ARCHS["llama3-8b"].reduced(),
                        ShapeConfig("small", "decode", 64, 4)),
             "moe_train": (train, moe, ShapeConfig("small", "train", 32, 4))}
    print(json.dumps({name: analyze_hlo(fn(cfg, shape).as_text()).as_dict()
                      for name, (fn, cfg, shape) in cells.items()}))
""")



def test_fake_dry_run_of_the_small_cell(group, tmp_path):
    """The reduced llama3-8b's train cell (4 x 32 tokens, accum 1) on a
    fake (2, 2) mesh: ``ok``, its peak split, and its matmul FLOPs against
    6·N·D and the reference's count."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
                        "--reduced", "--shape", "train_4k", "--mesh", "2x2", "--batch", str(B),
                        "--seq", str(T), "--accum", "1", "--out-root", str(tmp_path)],
                       capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC},
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert not (ROOT / "experiments" / "dryrun" / "2x2").exists()
    rec = json.loads((tmp_path / "2x2" / "llama3-8b__train_4k.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["param_bytes"] + mem["opt_bytes"] > 0
    cfg = ARCHS["llama3-8b"].reduced()
    flops = rec["op_summary"]["dot_flops"] * rec["n_devices"]
    # 6·N·D counts the embedding table, which a gather reads without a
    # matmul; the unsharded step's products are the rest of 6·N·D plus the
    # attention blocks' (QK and PV, 2·B·H·qc·kc·dh each, in the three
    # causal blocks of the 2 x 2 chunk grid: forward, recompute, and two in
    # the backward).  The four ranks skip none of it, and replicate at most
    # a quarter more (DTensor picks some backward products whole over the
    # model axis, where the residual stream is whole)
    six_nd = 6 * (cfg.total_params() - cfg.vocab_size * cfg.d_model) * B * T
    blocks = 2 * (2 * B * cfg.n_heads * cfg.q_chunk * cfg.kv_chunk * cfg.hd) * 3
    ideal = six_nd + 4 * blocks
    assert ideal <= flops <= 1.25 * ideal, (flops, ideal)
    # the reference's partitioned program, counted from its text, within 10 %
    want = group["ref_hlo"]["train"]["dot_flops"] * 4
    assert abs(flops - want) <= 0.10 * want, (flops, want)
    assert rec["op_summary"]["collective_bytes"]["all-gather"] > 0


# ---------------------------------------------------------------------------
# decode on the mesh: flash-decoding over the sequence-split cache
# ---------------------------------------------------------------------------


def _rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_decode_on_the_mesh_matches_one_rank_and_reference(group):
    """The reduced llama3-8b (f32) on (2, 2): the cache split by batch over
    "data" and on its sequence over "model" (24 positions a half), a
    4 x 32 prefill whose write straddles the halves, then three decode
    steps.  Every step's logits and the cache within 1e-5 relative of one
    rank's, and within the decode bound of ``tests/test_torch_models.py``
    (1e-4 of the scale) of the reference's ``prefill``/``decode_step``."""
    from repro_torch.convert import lm_params_from_numpy

    got = group["got"]["decode"]
    # (nsb, B, G, S, hd): B over "data", S over "model"; T crosses S / 2
    assert got["placements"] == "(Shard(dim=1), Shard(dim=3))"
    assert S_DEC // 2 < T < S_DEC
    raw, tokens, dec = group["raw"], group["batch"]["tokens"], group["dec_tokens"]
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    params = lm_params_from_numpy(raw, model)
    with torch.no_grad():
        cache, lg = model.prefill(params, {"tokens": tokens}, model.init_cache(B, S_DEC))
        want = [lg.numpy()]
        for i in range(N_DEC):
            cache, lg = model.decode_step(params, cache, {"token": dec[:, i], "pos": T + i})
            want.append(lg.numpy())
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        assert _rel_gap(g, w) <= 1e-5, (i, _rel_gap(g, w))
    for name in ("k", "v"):
        assert _rel_gap(got["cache"][name], cache["0"][name].numpy()) <= 1e-5, name
    # the reference, step for step
    ref = group["ref"]
    rcache, rl = jax.jit(ref.prefill)(raw, {"tokens": jnp.asarray(tokens)},
                                      ref.init_cache(B, S_DEC))
    ref_logits = [np.asarray(rl)]
    step = jax.jit(ref.decode_step)
    for i in range(N_DEC):
        rcache, rl = step(raw, rcache, {"token": jnp.asarray(dec[:, i]),
                                        "pos": jnp.asarray(T + i, jnp.int32)})
        ref_logits.append(np.asarray(rl))
    for i, (g, w) in enumerate(zip(got["logits"], ref_logits)):
        assert _rel_gap(g, w) <= 1e-4, (i, _rel_gap(g, w))
    for name in ("k", "v"):
        assert _rel_gap(got["cache"][name], np.asarray(rcache["0"][name], np.float32)) <= 1e-4


def test_decode_attention_on_the_mesh_moves_only_the_partials(group):
    """``decode_attention`` alone, the query whole in heads and the cache
    split by batch and sequence, with a length in each of the four
    (batch row, half) cases (whole, past the first half, the first half
    only, a few): equal to the plain function, and its collectives are the
    partials' all-reduces alone, at most ``(B_local, Hq, dh + 2)`` f32,
    with no slice of the cache gathered."""
    from repro_torch.models.layers import decode_attention

    a, got = group["attn"], group["got"]["decode_attn"]
    want = decode_attention(torch.from_numpy(a["q"]), torch.from_numpy(a["k"]),
                            torch.from_numpy(a["v"]), torch.from_numpy(a["length"]),
                            kv_chunk=a["kv_chunk"]).numpy()
    assert _rel_gap(got["out"], want) <= 1e-5
    assert got["placements"] == "(Shard(dim=0), Replicate())"
    ops = got["ops"]
    b_local, hq, _, dh = a["q"].shape
    b_local //= 2
    moved = ops["collective_bytes"]
    assert {k: v for k, v in moved.items() if k != "all-reduce"} == {
        "all-gather": 0, "reduce-scatter": 0, "all-to-all": 0, "broadcast": 0}
    assert 0 < moved["all-reduce"] <= b_local * hq * (dh + 2) * 4, moved
    assert ops["collective_counts"]["all-reduce"] == 2


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def test_expert_parallel_step_matches_unsharded_and_reference(group):
    """One sharded train step of the reduced qwen3-moe (8 experts, sort
    dispatch), the experts split over "model": the loss within 1e-5
    relative of the port's unsharded step, every parameter within 2e-5 of
    it and of the reference's ``make_train_step``."""
    rmoe, moe_cfg, moe_raw, moe_batch = group["moe"]
    got = group["got"]["moe_step"]
    moe = LM(moe_cfg, compute_dtype=torch.float32, device="cpu")
    params = lm_master_from_numpy(moe_raw, moe)
    up, _, um = make_train_step(moe, OPT, accum=1)(params, optim.adamw_init(params), moe_batch)
    for k, v in um.items():
        _close_rel(got["metrics"][k], v, 1e-5, k)
    for path, want in _flat(lm_params_to_numpy(up)).items():
        np.testing.assert_allclose(got["params"]["/".join(path)], want, atol=2e-5, err_msg=str(path))
    wp, _, wm = jax.jit(ref_make_train_step(rmoe, REF_OPT, accum=1))(
        moe_raw, ref_optim.adamw_init(moe_raw), jax.tree_util.tree_map(jnp.asarray, moe_batch))
    _close_rel(got["metrics"]["loss"], wm["loss"], 1e-5, "reference loss")
    for path, want in _ref_flat(wp).items():
        np.testing.assert_allclose(got["params"]["/".join(path)], np.asarray(want), atol=2e-5,
                                   err_msg=str(path))


def test_expert_weights_and_moments_stay_split_over_model(group):
    """After the step every parameter and both AdamW moments keep the
    rules' placements (the expert weights ``Shard`` on "model" over their
    expert dim), and no all-gather over "model" carries an expert weight:
    the data axes' gathers (FSDP) are the only ones of the experts."""
    _, moe_cfg, moe_raw, _ = group["moe"]
    got = group["got"]["moe_step"]
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    n_expert_leaves = 0
    for name, (p_pl, m_pl, v_pl) in got["placements"].items():
        path = tuple(name.split("/"))
        leaf = _flat(moe_raw)[path]
        want = str(sharding.to_placements(
            mesh, shardings.guard_spec(mesh, sharding.param_spec(path, leaf), leaf.shape),
            leaf.ndim))
        assert p_pl == m_pl == v_pl == want, name
        if path[-1].startswith("moe_w"):
            assert want == "(Shard(dim=2), Shard(dim=1))", name  # d over data, E over model
            n_expert_leaves += 1
    assert n_expert_leaves == 3
    e, d, f = moe_cfg.n_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    block = (e // 2) * (d // 2) * f  # a rank's block of one expert weight
    for shape in got["model_gathers"]:
        carries_expert = (len(shape) >= 3 and tuple(shape[-2:]) in {(d // 2, f), (d, f), (f, d)}
                          and int(np.prod(shape)) >= block)
        assert not carries_expert, shape
    assert got["n_gathers"] > len(got["model_gathers"])  # the experts' FSDP gathers


#: name -> (top_k, capacity_factor): one case that keeps every entry, one
#: that drops some at capacity
_SHARE_CASES = {"keeps": (2, 8.0), "drops": (2, 0.25)}
_SHARE_REF: dict = {}


@pytest.mark.parametrize("ways", [(1, 1), (2, 1), (2, 2), (4, 3)], ids=str)
@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("case", sorted(_SHARE_CASES))
def test_static_dispatch_shares_add_up_to_the_reference(case, mode, ways):
    """Off the mesh, the static dispatch: the shares of a mesh's ranks
    (``ways`` = experts split e ways, their slots c ways) summed equal the
    whole layer, and the whole layer equals the reference's ``moe_ffn``
    within the f32 bound of ``tests/test_torch_models.py``; the dropping
    case drops entries."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    top_k, cf = _SHARE_CASES[case]
    rng = np.random.default_rng(6)
    n_exp, d, f = 8, 64, 32
    p = {"router": rng.normal(size=(d, n_exp)).astype(np.float32) * d ** -0.5,
         "moe_w1": rng.normal(size=(n_exp, d, f)).astype(np.float32) * d ** -0.5,
         "moe_w3": rng.normal(size=(n_exp, d, f)).astype(np.float32) * d ** -0.5,
         "moe_w2": rng.normal(size=(n_exp, f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(2, 24, d)).astype(np.float32)
    opts = dict(n_experts=n_exp, top_k=top_k, capacity_factor=cf, dispatch_mode=mode)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    whole, aux = moe.moe_ffn(tp, torch.from_numpy(x), **opts)
    if (case, mode) not in _SHARE_REF:  # the reference compiled once per case and mode
        _SHARE_REF[case, mode] = jax.jit(lambda pp, xx: ref_moe.moe_ffn(pp, xx, **opts))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    want, raux = _SHARE_REF[case, mode]
    assert _rel_gap(whole.numpy(), np.asarray(want)) <= 1e-4
    assert float(aux["dropped_frac"]) == pytest.approx(float(raux["dropped_frac"]), abs=1e-6)
    assert (float(aux["dropped_frac"]) > 0) == (case == "drops")
    # the ranks' shares, as _moe_on_mesh cuts them
    xf = torch.from_numpy(x).reshape(-1, d)
    _, _, _, e_flat, g_flat, cap, _, slot = moe._route(
        xf, tp["router"], n_exp, top_k, cf, mode)
    n_e, n_c = ways
    cs = -(-cap // n_c)
    total = torch.zeros_like(xf)
    for i in range(n_e):
        w = {k: tp[k][i * n_exp // n_e:(i + 1) * n_exp // n_e] for k in ("moe_w1", "moe_w3", "moe_w2")}
        for j in range(n_c):
            total = total + moe._experts(xf, g_flat, e_flat, slot, w["moe_w1"], w["moe_w3"],
                                         w["moe_w2"], cap=cap, e0=i * n_exp // n_e, c0=j * cs,
                                         cs=cs, top_k=top_k)
    assert _rel_gap(total.numpy(), whole.reshape(-1, d).numpy()) <= 1e-6


#: name -> (top_k, capacity_factor): four choices, so that adding them in
#: the compute dtype and adding them wider then rounding once differ
_BIT_CASES = {"keeps": (4, 8.0), "drops": (4, 0.25)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("case", sorted(_BIT_CASES))
def test_static_dispatch_equals_the_indexed_write_bit_for_bit(case, mode, dtype):
    """Off the mesh, the static dispatch equals the reference's dataflow
    written out in torch, bit for bit, at bf16 too: the indexed write of
    the kept entries into the (E, cap, d) buffer, the three products, the
    gather of each entry's output, its gate rounded to the compute dtype,
    and the k choices added in the compute dtype, choice 0 first."""
    from repro_torch.models import moe

    top_k, cf = _BIT_CASES[case]
    dt = _DT[dtype]
    rng = np.random.default_rng(7)
    n_exp, d, f = 8, 64, 32
    p = {"router": rng.normal(size=(d, n_exp)) * d ** -0.5,
         "moe_w1": rng.normal(size=(n_exp, d, f)) * d ** -0.5,
         "moe_w3": rng.normal(size=(n_exp, d, f)) * d ** -0.5,
         "moe_w2": rng.normal(size=(n_exp, f, d)) * f ** -0.5}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(dt) for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(2, 24, d)).astype(np.float32)).to(dt)
    got, _ = moe.moe_ffn(tp, x, n_experts=n_exp, top_k=top_k, capacity_factor=cf,
                         dispatch_mode=mode)

    xf = x.reshape(-1, d)
    n = xf.shape[0]
    _, _, _, e_flat, g_flat, cap, keep, slot = moe._route(xf, tp["router"], n_exp, top_k, cf, mode)
    t_flat = torch.arange(n).repeat(top_k)
    buf = torch.zeros((n_exp, cap, d), dtype=dt)
    buf[e_flat[keep], slot[keep]] = xf[t_flat[keep]]
    y = torch.bmm(moe.silu(torch.bmm(buf, tp["moe_w1"])) * torch.bmm(buf, tp["moe_w3"]),
                  tp["moe_w2"])
    out_e = torch.where(keep[:, None], y[e_flat, slot.clamp(max=cap - 1)], 0)
    contrib = (out_e * g_flat[:, None].to(dt)).to(dt).reshape(top_k, n, d)
    want = torch.zeros((n, d), dtype=dt)
    for j in range(top_k):
        want = want + contrib[j]
    assert got.dtype == dt
    assert torch.equal(got.reshape(n, d), want)


# ---------------------------------------------------------------------------
# the dry run of the decode and MoE cells
# ---------------------------------------------------------------------------


#: name -> (the port's dry-run flags, the reference cell in _REF_DRYRUN)
_DRY_CELLS = {
    "llama3-8b__decode_32k": (["--arch", "llama3-8b", "--shape", "decode_32k", "--batch", "4",
                               "--seq", "64"], "decode"),
    "qwen3-moe-235b-a22b__train_4k": (["--arch", "qwen3-moe-235b-a22b", "--shape", "train_4k",
                                       "--batch", str(B), "--seq", str(T), "--accum", "1",
                                       "--override", "dispatch_mode=sort"], "moe_train"),
}


@pytest.mark.parametrize("cell", sorted(_DRY_CELLS))
def test_fake_dry_run_of_the_decode_and_moe_cells(group, tmp_path, cell):
    """The reduced decode cell (4 x 64 cache, split on its sequence) and the
    reduced qwen3-moe train cell (4 x 32, accum 1, sort dispatch) on a fake
    (2, 2) mesh: ``ok``, and their matmul FLOPs within 10 % of the
    reference's ``analyze_hlo`` of the same cell."""
    flags, ref_cell = _DRY_CELLS[cell]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
                        "--mesh", "2x2", "--out-root", str(tmp_path)] + flags,
                       capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC},
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    rec = json.loads((tmp_path / "2x2" / f"{cell}.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["peak_bytes"] > 0
    flops = rec["op_summary"]["dot_flops"]
    want = group["ref_hlo"][ref_cell]["dot_flops"]
    assert abs(flops - want) <= 0.10 * want, (flops, want)
