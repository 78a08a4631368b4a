"""The port's training path against the JAX reference's, on the CPU.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``; parameters cross as numpy (``convert.lm_master_from_numpy``:
f32 master leaves, as the reference trains them).  Sizes are the reduced
configs of ``tests/test_torch_models.py``: B = 2, T = 32.

Tolerances:

* ``chunked_softmax_xent`` at f32: the value within 1e-5 relative, each
  gradient within 1e-4 of its largest magnitude;
* ``LM.loss`` at f32, every reduced arch: loss and each metric within
  1e-4 (relative, or absolute below 1); gradients of every parameter leaf
  within 1e-3 of the leaf's largest magnitude for llama3-8b, qwen3-moe in
  both dispatch modes, jamba and xlstm; both packages rematerialise, as
  they do by default;
* remat against no remat in the port, for the same five cases: the loss
  and every gradient equal bit for bit, under
  ``torch.use_deterministic_algorithms`` (without it the CPU's threaded
  index accumulation in the MoE backward reorders its f32 sums from run
  to run, with or without remat);
* bf16 (llama3-8b): loss and gradients within 5e-2 of the scale;
* ``lr_at`` and ``global_norm`` within 1e-6 relative; one ``adamw_update``
  (in place): parameters, ``m`` and ``v`` within 1e-6 of each leaf's scale;
* ``make_train_step`` at f32 with remat, accum 1 and 2 and three steps in
  a row: the loss within 1e-3 relative, parameters within 2e-5 (the
  reference's own accumulation test's bounds);
* ``compressed_allreduce_grads`` in a 4-rank gloo group against the
  reference under a 4-device ``shard_map``: residuals within 1e-6 of the
  gradient scale, the mean within the reference test's bound (1/50 of the
  scale) and within 1e-6 of the reference's mean;
* checkpoints across the packages: leaves byte for byte.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.train.trainstep import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.ckpt import checkpoint as pckpt  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adamw_state_from_numpy,
    adamw_state_to_numpy,
    lm_master_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import lm as lm_module  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainstep import init_train_state, make_train_step  # noqa: E402
from repro_torch.tools.rankgroup import run_group  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
B, T = 2, 32
F32_TOL = 1e-4
GRAD_TOL = 1e-3
BF16_TOL = 5e-2
#: archs whose gradients are held leaf by leaf (a dispatch mode for MoE)
GRAD_CASES = {"llama3-8b": None, "qwen3-moe-235b-a22b/sort": "sort",
              "qwen3-moe-235b-a22b/einsum": "einsum", "jamba-v0.1-52b": None,
              "xlstm-1.3b": None}


def _leaves(tree) -> list:
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _close_rel(got, want, tol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1.0), f"{what}: {got} vs {want}"


# ---------------------------------------------------------------------------
# chunked_softmax_xent
# ---------------------------------------------------------------------------


XENT_CASES = {"plain": (None, 0.0), "mask": ("mask", 0.0), "z_loss": (None, 1e-3),
              "mask_z_loss": ("mask", 1e-2)}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_chunked_softmax_xent_value_and_grads(case):
    use_mask, z = XENT_CASES[case]
    rng = np.random.default_rng(11)
    d, V, chunk = 24, 97, 8
    h = rng.normal(size=(B, T, d)).astype(np.float32)
    head = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32) if use_mask else None

    def ref(hh, ww):
        return ref_layers.chunked_softmax_xent(
            hh, ww, jnp.asarray(labels), mask=None if mask is None else jnp.asarray(mask),
            chunk=chunk, z_loss=z)

    want, (gh_want, gw_want) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    got = layers.chunked_softmax_xent(
        th, tw, torch.from_numpy(labels), mask=None if mask is None else torch.from_numpy(mask),
        chunk=chunk, z_loss=z)
    gh, gw = torch.autograd.grad(got, (th, tw))
    got = got.detach()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert _scaled_err(gh.numpy(), gh_want) <= 1e-4
    assert _scaled_err(gw.numpy(), gw_want) <= 1e-4
    with pytest.raises(AssertionError):  # T must be a multiple of the chunk
        layers.chunked_softmax_xent(th[:, :30], tw, torch.from_numpy(labels[:, :30]), chunk=chunk)


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------


_RUNS: dict = {}


def _batch(cfg, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.embed_input:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    else:
        batch["frames"] = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _configs(name: str, mode):
    rcfg = REF_ARCHS[name].reduced()
    if mode is not None:
        rcfg = dataclasses.replace(rcfg, dispatch_mode=mode)
    return rcfg, dataclasses.replace(ARCHS[name].reduced(), dispatch_mode=rcfg.dispatch_mode)


def _loss_run(name: str, mode=None, dt: str = "f32", grads: bool = False) -> dict:
    """Both packages' loss (and, with ``grads``, every parameter leaf's
    gradient) on the same f32 parameters and batch; the reference's under
    ``jax.jit``, computed once per arch, mode and dtype."""
    key = (name, mode, dt, grads)
    if key in _RUNS:
        return _RUNS[key]
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rcfg, cfg = _configs(name, mode)
    ref = RefLM(rcfg, compute_dtype=jd)
    raw = ref.init(jax.random.PRNGKey(7))
    batch = _batch(cfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    out = {}
    if grads:
        (loss, metrics), g = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(raw, jb)
        out["ref_grads"] = _leaves(g)
    else:
        loss, metrics = jax.jit(ref.loss)(raw, jb)
    out["ref"] = (float(loss), {k: float(v) for k, v in metrics.items()})
    model = LM(cfg, compute_dtype=td, device="cpu")
    params = lm_master_from_numpy(jax.tree_util.tree_map(np.asarray, raw), model)
    flat = [p.requires_grad_(grads) for p in optim.tree_leaves(params)]
    loss, metrics = model.loss(params, batch)
    out["port"] = (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()})
    if grads:
        out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, flat)]
    _RUNS[key] = out
    return out


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_lm_loss_and_metrics_f32(name):
    mode = None
    for case, m in GRAD_CASES.items():
        if case.split("/")[0] == name:
            mode = m
            break
    grads = any(case.split("/")[0] == name for case in GRAD_CASES)
    run = _loss_run(name, mode, grads=grads)
    (got, got_m), (want, want_m) = run["port"], run["ref"]
    assert sorted(got_m) == sorted(want_m) == ["dropped_frac", "lb_loss", "xent", "z_loss"]
    _close_rel(got, want, F32_TOL, f"{name} loss")
    for k in want_m:
        _close_rel(got_m[k], want_m[k], F32_TOL, f"{name} {k}")
    if not REF_ARCHS[name].n_experts:
        assert got == got_m["xent"] and got_m["lb_loss"] == got_m["z_loss"] == 0.0


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_lm_loss_gradients_f32(case):
    run = _loss_run(case.split("/")[0], GRAD_CASES[case], grads=True)
    assert len(run["grads"]) == len(run["ref_grads"])
    for i, (got, want) in enumerate(zip(run["grads"], run["ref_grads"])):
        assert np.isfinite(got).all(), (case, i)
        assert _scaled_err(got, want) <= GRAD_TOL, (case, i, _scaled_err(got, want))
    _close_rel(run["port"][0], run["ref"][0], F32_TOL, f"{case} loss")


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels for the test, restored after it."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _port_grads(cfg, remat: bool, batch: dict):
    model = LM(cfg, compute_dtype=torch.float32, device="cpu", remat=remat)
    params = model.init_master(torch.Generator().manual_seed(5))
    flat = [p.requires_grad_(True) for p in optim.tree_leaves(params)]
    loss, metrics = model.loss(params, batch)
    return loss.detach(), metrics, torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_remat_loss_and_gradients_equal_no_remat_bit_for_bit(case, deterministic):
    """Rematerialising each superblock recomputes the same ops on the same
    inputs, so the loss, the metrics and every leaf's gradient are those
    of ``remat=False`` to the bit."""
    _, cfg = _configs(case.split("/")[0], GRAD_CASES[case])
    batch = _batch(cfg)
    (l_on, m_on, g_on), (l_off, m_off, g_off) = (_port_grads(cfg, r, batch)
                                                 for r in (True, False))
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    assert len(g_on) == len(g_off)
    for i, (a, b) in enumerate(zip(g_on, g_off)):
        assert torch.equal(a, b), (case, i)


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-235b-a22b"])
def test_remat_keeps_only_the_products_without_batch_dims(name, monkeypatch):
    """Under remat, autograd holds only what the superblocks' outside saves
    and, inside, the outputs of ``mm`` (the ops the policy marks
    ``MUST_SAVE``: wq, wk, wv, wo and the dense FFN's three, or the
    router's); attention's and the experts' ``bmm`` are recomputed."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), dispatch_mode="sort")
    batch = _batch(cfg)
    decided, policy_fn = [], lm_module.remat_policy

    def spy(ctx, op, *args, **kwargs):
        policy = policy_fn(ctx, op, *args, **kwargs)
        decided.append((op, policy, args))
        return policy

    monkeypatch.setattr(lm_module, "remat_policy", spy)
    held = {}
    for remat in (False, True):
        model = LM(cfg, device="cpu", remat=remat)
        params = model.init_master(torch.Generator().manual_seed(0))
        flat = [p.requires_grad_(True) for p in optim.tree_leaves(params)]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel() * t.element_size()) or t, lambda t: t):
            loss, _ = model.loss(params, batch)
        held[remat] = saved
        assert all(g is not None for g in torch.autograd.grad(loss, flat))
    mm = torch.ops.aten.mm.default
    kept = [(op, args) for op, policy, args in decided
            if policy == CheckpointPolicy.MUST_SAVE]
    assert {op for op, _ in kept} == {mm}
    assert all(policy == CheckpointPolicy.PREFER_RECOMPUTE
               for op, policy, _ in decided if op != mm)
    assert torch.ops.aten.bmm.default in {op for op, _, _ in decided}
    ffn = cfg.pattern[0][1]
    per_sb = 4 + (3 if ffn == "dense" else 1 + 3 * cfg.shared_expert)
    assert cfg.pattern == (("attn", ffn),)
    assert len(kept) == per_sb * cfg.n_superblocks
    # what remat holds: the saves outside the superblocks and the products
    kept_bytes = sum(a.shape[0] * b.shape[1] * a.element_size() for _, (a, b) in kept)
    assert len(held[True]) < len(held[False])
    assert sum(held[True]) + kept_bytes < sum(held[False])


def test_lm_loss_and_gradients_bf16():
    run = _loss_run("llama3-8b", dt="bf16", grads=True)
    _close_rel(run["port"][0], run["ref"][0], BF16_TOL, "bf16 loss")
    for i, (got, want) in enumerate(zip(run["grads"], run["ref_grads"])):
        assert _scaled_err(got, want) <= BF16_TOL, (i, _scaled_err(got, want))


@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_moe_ffn_gradients_through_dispatch_and_combine(mode):
    """Gradients flow through the indexed dispatch write and the combine,
    with entries dropped at capacity: every input's and weight's gradient
    of a weighted sum of the output plus the aux losses, against the
    reference's, within 1e-4 of each gradient's scale."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    rng = np.random.default_rng(13)
    d, E, f = 32, 8, 16
    p = {"router": rng.normal(size=(d, E)) * d ** -0.5,
         "moe_w1": rng.normal(size=(E, d, f)) * d ** -0.5,
         "moe_w3": rng.normal(size=(E, d, f)) * d ** -0.5,
         "moe_w2": rng.normal(size=(E, f, d)) * f ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    r = rng.normal(size=(2, 16, d)).astype(np.float32)
    opts = dict(n_experts=E, top_k=2, capacity_factor=0.5, dispatch_mode=mode)

    def ref(pp, xx):
        out, aux = ref_moe.moe_ffn(pp, xx, **opts)
        return jnp.sum(out * r) + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"], aux

    grad_fn = jax.jit(jax.value_and_grad(ref, argnums=(0, 1), has_aux=True))
    (_, raux), (gp_want, gx_want) = grad_fn({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tp, tx, **opts)
    loss = (out * torch.from_numpy(r)).sum() + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    assert float(aux["dropped_frac"]) == float(raux["dropped_frac"]) > 0
    wants = [gx_want] + [gp_want[k] for k in sorted(tp)]
    for name, got, want in zip(["x"] + sorted(tp), grads, wants):
        assert _scaled_err(got.numpy(), want) <= 1e-4, name


def test_master_form_keeps_f32_leaves_and_serving_cast_is_unchanged():
    """Master parameters are f32 throughout and take gradients in f32;
    serving parameters keep their one cast, so the forward's cast finds
    nothing to do on them."""
    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    model = LM(cfg, device="cpu")
    master = model.init_master(torch.Generator().manual_seed(0))
    assert {p.dtype for p in optim.tree_leaves(master)} == {torch.float32}
    assert not any(p.requires_grad for p in optim.tree_leaves(master))
    serving = model.init(torch.Generator().manual_seed(0))
    for name, t in serving["blocks"]["0"].items():
        view = t[0]
        assert model._cast(view) is view, name
    _, opt = init_train_state(model, torch.Generator().manual_seed(0))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


OPT = ref_optim.OptConfig(warmup_steps=10, decay_steps=50)


@pytest.mark.parametrize("step", [0, 1, 10, 30, 80])
def test_lr_at_matches_reference(step):
    cfg = optim.OptConfig(warmup_steps=10, decay_steps=50)
    got = optim.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
    want = ref_optim.lr_at(OPT, jnp.int32(step))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def _opt_tree(rng):
    """A tree with a stacked norm (nsb, d), a vector (d,) and a matrix."""
    return {"blocks": {"0": {"ln": rng.normal(size=(3, 8)).astype(np.float32) + 1,
                             "w": rng.normal(size=(3, 8, 5)).astype(np.float32)}},
            "final_norm": rng.normal(size=(8,)).astype(np.float32) + 1,
            "head": rng.normal(size=(8, 6)).astype(np.float32)}


def test_global_norm_and_adamw_update_match_reference():
    rng = np.random.default_rng(5)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    m, v = _opt_tree(rng), jax.tree_util.tree_map(np.abs, _opt_tree(rng))
    ref_opt = {"m": m, "v": v, "step": np.int32(4)}
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    t = lambda tree: lm_master_from_numpy(tree, LM(ARCHS["llama3-8b"].reduced(),  # noqa: E731
                                                   device="cpu"))
    assert abs(float(optim.global_norm(t(grads))) - float(ref_optim.global_norm(j(grads)))) \
        <= 1e-6 * float(ref_optim.global_norm(j(grads)))
    cfg = optim.OptConfig(warmup_steps=10, decay_steps=50)
    for scale in (1.0, 0.01):  # with and without clipping
        g = jax.tree_util.tree_map(lambda x: x * scale, grads)
        wp, wo, wm = ref_optim.adamw_update(OPT, j(params), j(g), j(ref_opt))
        gp, go, gm = optim.adamw_update(cfg, t(params), t(g),
                                        adamw_state_from_numpy(ref_opt, device="cpu"))
        for got, want in zip(_leaves(lm_params_to_numpy(gp)), _leaves(wp)):
            assert _scaled_err(got, want) <= 1e-6
        got_o = adamw_state_to_numpy(go)
        for part in ("m", "v"):
            for got, want in zip(_leaves(got_o[part]), _leaves(wo[part])):
                assert _scaled_err(got, want) <= 1e-6
        assert int(got_o["step"]) == int(wo["step"]) == 5
        for k in ("lr", "grad_norm"):
            assert abs(float(gm[k]) - float(wm[k])) <= 1e-6 * float(wm[k])
    # the decay rule follows the stored ndim: the stacked norm decays,
    # final_norm does not (zero gradients isolate the decay term)
    zero = jax.tree_util.tree_map(np.zeros_like, grads)
    gp, _, _ = optim.adamw_update(cfg, t(params), t(zero), adamw_state_from_numpy(
        {"m": zero, "v": zero, "step": np.int32(0)}, device="cpu"))
    assert not torch.equal(gp["blocks"]["0"]["ln"], t(params)["blocks"]["0"]["ln"])
    assert torch.equal(gp["final_norm"], t(params)["final_norm"])


# ---------------------------------------------------------------------------
# the train step: accum 1 and 2, three steps in a row
# ---------------------------------------------------------------------------


def _step_setup():
    rcfg = REF_ARCHS["llama3-8b"].reduced()
    ref = RefLM(rcfg, compute_dtype=jnp.float32)
    raw = ref.init(jax.random.PRNGKey(0))
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(9)
    batches = [{"tokens": rng.integers(0, rcfg.vocab_size, (4, T)).astype(np.int32),
                "labels": rng.integers(0, rcfg.vocab_size, (4, T)).astype(np.int32)}
               for _ in range(3)]
    return ref, raw, model, batches


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    ref, raw, model, batches = _step_setup()
    wp, wo, wm = jax.jit(ref_make_train_step(ref, OPT, accum=accum))(
        raw, ref_optim.adamw_init(raw), jax.tree_util.tree_map(jnp.asarray, batches[0]))
    params = lm_master_from_numpy(jax.tree_util.tree_map(np.asarray, raw), model)
    cfg = optim.OptConfig(warmup_steps=10, decay_steps=50)
    opt = optim.adamw_init(params)
    gp, go, gm = make_train_step(model, cfg, accum=accum)(params, opt, batches[0])
    assert sorted(gm) == sorted(wm)
    _close_rel(gm["loss"], wm["loss"], 1e-3, "loss")
    for k in ("xent", "grad_norm", "lr"):
        _close_rel(gm[k], wm[k], 1e-3, k)
    for got, want in zip(_leaves(lm_params_to_numpy(gp)), _leaves(wp)):
        np.testing.assert_allclose(got, want, atol=2e-5)
    assert int(go["step"]) == 1
    # the step writes into the trees it is given (the reference's launcher
    # donates them to its jitted step)
    assert gp is params
    assert all(a is b for a, b in zip(optim.tree_leaves(go["m"]), optim.tree_leaves(opt["m"])))


def test_three_train_steps_match_reference():
    ref, raw, model, batches = _step_setup()
    step = jax.jit(ref_make_train_step(ref, OPT, accum=1))
    wp, wo = raw, ref_optim.adamw_init(raw)
    gp = lm_master_from_numpy(jax.tree_util.tree_map(np.asarray, raw), model)
    go = optim.adamw_init(gp)
    port_step = make_train_step(model, optim.OptConfig(warmup_steps=10, decay_steps=50))
    for i, batch in enumerate(batches):
        wp, wo, wm = step(wp, wo, jax.tree_util.tree_map(jnp.asarray, batch))
        gp, go, gm = port_step(gp, go, batch)
        _close_rel(gm["loss"], wm["loss"], 1e-3, f"step {i} loss")
        for got, want in zip(_leaves(lm_params_to_numpy(gp)), _leaves(wp)):
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=f"step {i}")
    got_o = adamw_state_to_numpy(go)
    assert int(got_o["step"]) == int(wo["step"]) == 3
    for got, want in zip(_leaves(got_o["v"]), _leaves(wo["v"])):
        assert _scaled_err(got, want) <= 1e-3


# ---------------------------------------------------------------------------
# gradient compression: 4 gloo ranks against a 4-device shard_map
# ---------------------------------------------------------------------------

_REF_COMPRESS = """
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.train.compression import compressed_allreduce_grads, ef_init
d = np.load(sys.argv[1])
mesh = make_mesh((4,), ("pod",))
fn = shard_map(partial(compressed_allreduce_grads, axis_name="pod"), mesh=mesh,
               in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod")))
out, ef = {}, None
for r in range(2):
    g = {k: jnp.asarray(d[f"{r}_{k}"]) for k in ("w", "b")}
    ef = ef_init(g) if ef is None else ef
    mean, ef = fn(g, ef)
    for k in ("w", "b"):
        out[f"{r}_mean_{k}"] = np.asarray(mean[k])
        out[f"{r}_ef_{k}"] = np.asarray(ef[k])
np.savez(sys.argv[2], **out)
"""


def test_compressed_allreduce_grads_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    # per-rank leaves stacked on axis 0: the reference's P("pod") blocks
    rounds = [{"w": rng.normal(size=(4, 1, 32)).astype(np.float32) * s,
               "b": rng.normal(size=(4, 1, 8)).astype(np.float32)} for s in (1.0, 0.3)]
    np.savez(tmp_path / "in.npz", **{f"{r}_{k}": v.reshape(4, -1) if k == "b" else
                                     v.reshape(4, 32) for r, g in enumerate(rounds)
                                     for k, v in g.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_COMPRESS),
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    want = dict(np.load(tmp_path / "out.npz"))
    from torch_rank_fns import compressed_rounds

    ranks = run_group(compressed_rounds, 4, [{k: v[:, 0] for k, v in g.items()}
                                             for g in rounds], timeout=60.0, deadline=300.0)
    for rnd, g in enumerate(rounds):
        for k in ("w", "b"):
            scale = float(np.abs(g[k]).max())
            exact = g[k][:, 0].mean(axis=0)
            for rank, out in enumerate(ranks):
                mean, ef = out[rnd][0][k], out[rnd][1][k]
                np.testing.assert_allclose(mean, want[f"{rnd}_mean_{k}"][0], atol=1e-6 * scale)
                np.testing.assert_allclose(ef, want[f"{rnd}_ef_{k}"][rank], atol=1e-6 * scale)
                assert np.abs(mean - exact).max() < max(np.abs(exact).max(), 1e-3) / 50
        assert all(np.array_equal(ranks[0][rnd][0][k], o[rnd][0][k])
                   for o in ranks for k in ("w", "b"))


# ---------------------------------------------------------------------------
# checkpoints of the train state across the packages
# ---------------------------------------------------------------------------


def _train_state():
    """A small train state as the port holds it: CPU tensors, f32 master
    leaves, an int32 step and one bf16 leaf."""
    rng = np.random.default_rng(4)
    params = {"embed": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
              "blocks": {"0": {"ln": torch.ones((2, 8)),
                               "w": torch.from_numpy(rng.normal(size=(2, 8, 8)).astype(
                                   np.float32)).to(torch.bfloat16)}}}
    return params, optim.adamw_init(params)


def _as_bytes(a) -> tuple:
    a = np.ascontiguousarray(np.asarray(a))
    return a.shape, a.dtype.itemsize, a.tobytes()


def test_tensor_leaves_save_and_restore_in_both_packages(tmp_path):
    """Tensor leaves (bf16 included) save as the reference saves arrays of
    their dtype: the reference restores them to equal bytes, and the port
    restores them as tensors of their dtype."""
    from repro.ckpt.checkpoint import restore_checkpoint as ref_restore

    state = _train_state()
    pckpt.save_checkpoint(tmp_path, 3, state, extra_meta={"step": 3}, device="cpu")
    like = jax.tree_util.tree_map(lambda t: np.zeros(1), (
        {"embed": 0, "blocks": {"0": {"ln": 0, "w": 0}}},
        {"m": {"embed": 0, "blocks": {"0": {"ln": 0, "w": 0}}},
         "v": {"embed": 0, "blocks": {"0": {"ln": 0, "w": 0}}}, "step": 0}))
    got, stats = ref_restore(tmp_path, 3, like)
    assert stats["meta"]["step"] == 3
    saved = [_as_bytes(pckpt._leaf_array(t)) for t in optim.tree_leaves(state[0])]
    assert [_as_bytes(a) for a in jax.tree_util.tree_leaves(got[0])] == saved
    w = jax.tree_util.tree_leaves(got[0])[1]
    assert w.dtype == np.dtype("V2")  # what the reference's own bf16 save gives
    back, _ = pckpt.restore_checkpoint(tmp_path, 3, state, device="cpu", backend="torch",
                                       index_device="cpu")
    assert back[0]["blocks"]["0"]["w"].dtype == torch.bfloat16
    assert torch.equal(back[0]["blocks"]["0"]["w"], state[0]["blocks"]["0"]["w"])
    assert back[1]["step"].dtype == torch.int32
    for a, b in zip(optim.tree_leaves(back[1]["m"]), optim.tree_leaves(state[1]["m"])):
        assert torch.equal(a, b)


def test_reference_train_state_restores_under_the_port(tmp_path):
    from repro.ckpt.checkpoint import save_checkpoint as ref_save

    rcfg = REF_ARCHS["llama3-8b"].reduced()
    raw = RefLM(rcfg, remat=False).init(jax.random.PRNGKey(1))
    opt = ref_optim.adamw_init(raw)
    opt = {**opt, "m": jax.tree_util.tree_map(lambda x: x + 0.5, opt["m"]),
           "step": jnp.int32(7)}
    ref_save(tmp_path, 7, (raw, opt), extra_meta={"step": 7})
    model = LM(ARCHS["llama3-8b"].reduced(), device="cpu")
    like = init_train_state(model, torch.Generator().manual_seed(0))
    (params, popt), stats = pckpt.restore_checkpoint(tmp_path, 7, like, device="cpu",
                                                     backend="torch", index_device="cpu")
    assert stats["meta"]["step"] == 7 and int(popt["step"]) == 7
    for got, want in zip(optim.tree_leaves(params), jax.tree_util.tree_leaves(raw)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(optim.tree_leaves(popt["m"]), jax.tree_util.tree_leaves(opt["m"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_launch_train_runs_and_resumes(tmp_path):
    from repro_torch.ckpt import latest_step
    from repro_torch.launch.train import main as train_main

    common = ["--device", "cpu", "--arch", "repro-100m", "--reduced", "--batch", "4",
              "--seq", "32", "--ckpt-dir", str(tmp_path), "--log-every", "10"]
    first = train_main(common + ["--steps", "30", "--ckpt-every", "15"])
    assert latest_step(tmp_path) == 30 and first["restored"] is None
    assert [s["step"] for s in first["saves"]] == [15, 30]
    assert all(np.isfinite(v) for v in first["losses"].values())
    second = train_main(common + ["--steps", "40", "--ckpt-every", "10"])
    assert latest_step(tmp_path) == 40
    assert second["restored"]["meta"]["step"] == 30
    assert sorted(second["losses"]) == list(range(31, 41))
    # the restored state is the saved one, byte for byte
    (params, opt), _ = pckpt.restore_checkpoint(tmp_path, 30, (first["params"], first["opt"]),
                                                device="cpu", index_device="cpu")
    for a, b in zip(optim.tree_leaves({"p": params, "o": opt}),
                    optim.tree_leaves({"p": first["params"], "o": first["opt"]})):
        assert a.dtype == b.dtype and torch.equal(a, b)
