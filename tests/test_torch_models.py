"""The port's LM stack against the JAX reference's, on the CPU.

The same inputs, made from a seed with numpy, go through a function of
``repro.models`` and its counterpart in ``repro_torch.models``; LM
parameters cross as numpy through ``repro_torch.convert``.  Sizes are the
reference tests': ``reduced()`` configs, B = 2, S = 32.

Tolerances, as a fraction of the reference output's scale (max |x|):

* f32 (``compute_dtype=float32``): ``F32_TOL`` = 1e-4 for every layer,
  mixer and the six reduced LMs' logits and caches; greedy tokens equal.
* bf16: ``BF16_TOL`` = 5e-2 for the layers, the mixers (one layer) and
  the logits of llama3-8b, qwen3-moe, llama-3.2-vision and musicgen.
  The reduced jamba and xlstm models are held at f32 only: at bf16 the
  reference itself lands 0.35 and 0.32 of the scale away from its own f32
  logits (their recurrent states amplify bf16 rounding through eight
  layers), so no port can be held to 5e-2 there; their mixers are held at
  bf16 one layer at a time.
* Integers exactly: the MoE dispatch positions and permutation in both
  branches of the compressed key, the count of dropped entries, parameter
  counts.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, shape_applies  # noqa: E402
from repro_torch.configs import paper_index  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_cache_from_numpy,
    lm_cache_to_numpy,
    lm_master_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.models import layers, moe, ssm, xlstm  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2

DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

#: one reduced arch per mixer family
LM_ARCHS = ("llama3-8b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b", "xlstm-1.3b",
            "llama-3.2-vision-90b", "musicgen-large")
#: held at bf16 as whole models (see the module docstring)
BF16_ARCHS = ("llama3-8b", "qwen3-moe-235b-a22b", "llama-3.2-vision-90b", "musicgen-large")
B, T, S = 2, 32, 40


def _t(a, dtype=None) -> torch.Tensor:
    """numpy (or a reference array, bf16 included) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), what
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_configs_equal_reference(name):
    """Every field, ``reduced()`` and the parameter counts of the ten
    architectures equal the reference's."""
    got, want = get_arch(name), REF_ARCHS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.total_params() == want.total_params()
    assert got.active_params() == want.active_params()
    for cfg in (got, got.reduced()):
        assert cfg.hd == (cfg.head_dim or cfg.d_model // cfg.n_heads)
        assert cfg.n_superblocks * len(cfg.pattern) == cfg.n_layers
        assert cfg.dt_rank == (cfg.ssm_dt_rank or max(1, cfg.d_model // 16))


def test_shapes_and_registry_equal_reference():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import shape_applies as ref_applies

    assert sorted(ARCHS) == sorted(REF_ARCHS) and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            assert shape_applies(arch, shape) == ref_applies(REF_ARCHS[arch.name], shape)
    assert get_shape("decode_32k").seq_len == 32768
    with pytest.raises(KeyError):
        get_arch("gpt-5")
    assert paper_index.ZipfConfig(1.5, 64, 0, 10).n_keys == 10  # still importable


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_init_layout_and_dtypes_follow_reference(name):
    """The port's random init has the reference's tree, shapes and
    parameter count, with matrices in the compute dtype, vectors in f32 and
    the head in f32."""
    cfg = ARCHS[name].reduced()
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    struct = RefLM(REF_ARCHS[name].reduced(), remat=False).param_struct()
    flat = jax.tree_util.tree_flatten_with_path(struct)[0]
    n, n_ref = 0, 0
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        stacked_matrix = path[0].key == "blocks" and len(leaf.shape) >= 3
        want = torch.bfloat16 if stacked_matrix or path[0].key == "embed" else torch.float32
        assert t.dtype == want, path
        n += t.numel()
        n_ref += int(np.prod(leaf.shape))
    assert n == n_ref >= cfg.total_params()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_and_rope(dt):
    jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 4, T, 16), _rand(rng, 16)
    _close(layers.rms_norm(_t(x, td), _t(w)),
           ref_layers.rms_norm(jnp.asarray(x, jd), jnp.asarray(w)), tol, "rms_norm")
    pos1 = np.arange(3, 3 + T)
    pos2 = rng.integers(0, 1000, (2, T))
    for pos in (pos1, pos2):
        _close(layers.apply_rope(_t(x, td), _t(pos), 10000.0),
               ref_layers.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 10000.0), tol,
               f"rope {pos.shape}")
    _close(layers.silu(_t(x)), ref_layers.silu(jnp.asarray(x)), F32_TOL, "silu")


#: name -> (Tq, Tk, causal, q_chunk, kv_chunk)
FLASH_CASES = {
    "causal": (32, 32, True, 8, 16),
    "non_causal": (32, 32, False, 8, 8),
    "rectangular": (8, 32, True, 4, 8),  # queries at the end of the context
    "ragged": (12, 20, True, 8, 8),  # neither chunk divides: one block
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention(case, dt):
    jd, td, tol = DTYPES[dt]
    tq, tk, causal, qc, kc = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 4, tq, 16), _rand(rng, 2, 2, tk, 16), _rand(rng, 2, 2, tk, 16)
    got = layers.flash_attention(_t(q, td), _t(k, td), _t(v, td), causal=causal,
                                 q_chunk=qc, kv_chunk=kc)
    want = ref_layers.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                      jnp.asarray(v, jd), causal=causal, q_chunk=qc,
                                      kv_chunk=kc)
    assert got.dtype == td
    _close(got, want, tol, case)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("length", ["scalar", "per_row", "empty_row"])
def test_decode_attention_ragged_tail(length, dt):
    """S = 40 in segments of 16: the tail is padded and masked."""
    jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 4, 1, 16), _rand(rng, 2, 2, 40, 16), _rand(rng, 2, 2, 40, 16)
    lens = {"scalar": np.int32(37), "per_row": np.asarray([40, 17], np.int32),
            "empty_row": np.asarray([0, 33], np.int32)}[length]
    got = layers.decode_attention(_t(q, td), _t(k, td), _t(v, td), _t(lens), kv_chunk=16)
    want = ref_layers.decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                       jnp.asarray(v, jd), jnp.asarray(lens), kv_chunk=16)
    _close(got, want, tol, length)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


#: name -> (n_experts, entries, expert draw): the one-word key below 32
#: bits (21 bits at qwen3's full-width prefill), and the two-word branch
DISPATCH_CASES = {
    "small": (8, 64, "uniform"),
    "one_word_21_bits": (128, 16384, "uniform"),
    "one_word_skewed": (128, 4096, "skewed"),
    "one_word_one_expert": (16, 1000, "one"),
    "two_word": (2**20, 8192, "uniform"),
    "two_word_skewed": (2**20, 8192, "skewed"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_positions_and_permutation_byte_identical(case):
    n_experts, m, draw = DISPATCH_CASES[case]
    rng = np.random.default_rng(3)
    if draw == "uniform":
        eid = rng.integers(0, n_experts, m)
    elif draw == "skewed":
        eid = np.minimum(rng.zipf(1.3, m) - 1, n_experts - 1)
    else:
        eid = np.full(m, n_experts - 1)
    eid = eid.astype(np.int32)
    be, bm = moe._bits_for(n_experts), moe._bits_for(m)
    assert (be + bm <= 32) == case.startswith(("small", "one_word"))
    pos, perm = moe.dispatch_indices_sort(_t(eid), n_experts)
    rpos, rperm = jax.jit(ref_moe.dispatch_indices_sort, static_argnums=1)(
        jnp.asarray(eid), n_experts)
    assert pos.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    if n_experts <= 128:
        onehot = np.eye(n_experts, dtype=np.int32)[eid]
        cum = moe.dispatch_indices_cumsum(_t(onehot))
        np.testing.assert_array_equal(cum.numpy(), np.asarray(
            jax.jit(ref_moe.dispatch_indices_cumsum)(jnp.asarray(onehot))))
        np.testing.assert_array_equal(cum.numpy(), pos.numpy())


def _moe_params(rng, d=64, n_experts=8, f=32, dff=48, tie_router=False):
    p = {"router": _rand(rng, d, n_experts) * d ** -0.5,
         "moe_w1": _rand(rng, n_experts, d, f) * d ** -0.5,
         "moe_w3": _rand(rng, n_experts, d, f) * d ** -0.5,
         "moe_w2": _rand(rng, n_experts, f, d) * f ** -0.5,
         "w1": _rand(rng, d, dff) * d ** -0.5, "w3": _rand(rng, d, dff) * d ** -0.5,
         "w2": _rand(rng, dff, d) * dff ** -0.5}
    if tie_router:  # experts 2k and 2k+1 score alike: every top-k pair ties
        p["router"][:, 1::2] = p["router"][:, 0::2]
    return p


#: name -> (top_k, capacity_factor, shared_expert, tie_router)
MOE_CASES = {
    "top2": (2, 1.25, False, False),
    "top1_shared": (1, 1.25, True, False),
    "drops": (2, 0.25, False, False),
    "ties": (3, 1.25, False, True),
    "ties_drops": (4, 0.5, False, True),
}


@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case, mode):
    top_k, cf, shared, tie = MOE_CASES[case]
    rng = np.random.default_rng(4)
    p = _moe_params(rng, tie_router=tie)
    x = _rand(rng, 2, 24, 64)
    opts = dict(n_experts=8, top_k=top_k, capacity_factor=cf, dispatch_mode=mode,
                shared_expert=shared)
    got, aux = moe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), **opts)
    want, raux = jax.jit(lambda pp, xx: ref_moe.moe_ffn(pp, xx, **opts))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close(got, want, F32_TOL, case)
    # the same entries dropped (the fraction's last bit is the mean's own)
    m = 2 * 24 * top_k
    assert round(float(aux["dropped_frac"]) * m) == round(float(raux["dropped_frac"]) * m)
    assert abs(float(aux["dropped_frac"]) - float(raux["dropped_frac"])) <= 1e-6
    if case.endswith("drops"):
        assert float(aux["dropped_frac"]) > 0
    for key in ("lb_loss", "z_loss"):
        _close(aux[key], raux[key], F32_TOL, key)


def test_top_k_breaks_ties_toward_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = moe.top_k_lower(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[0, 1, 2], [1, 2, 0]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_moe_ffn_bf16_and_modes_agree():
    rng = np.random.default_rng(5)
    p = _moe_params(rng)
    x = _rand(rng, 2, 16, 64)
    outs = {}
    for mode in ("sort", "einsum"):
        opts = dict(n_experts=8, top_k=2, capacity_factor=0.5, dispatch_mode=mode)
        outs[mode], _ = moe.moe_ffn({k: _t(v, torch.bfloat16) for k, v in p.items()},
                                    _t(x, torch.bfloat16), **opts)
        want, _ = jax.jit(lambda pp, xx: ref_moe.moe_ffn(pp, xx, **opts))(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}, jnp.asarray(x, jnp.bfloat16))
        _close(outs[mode], want, BF16_TOL, mode)
    assert torch.equal(outs["sort"], outs["einsum"])


# ---------------------------------------------------------------------------
# mixers: prefill, then one decode step from the prefill's state
# ---------------------------------------------------------------------------


_INITS: dict = {}


def _ref_init(name: str) -> dict:
    """The reference's random parameters of a reduced arch, made once."""
    if name not in _INITS:
        cfg = REF_ARCHS[name].reduced()
        _INITS[name] = RefLM(cfg, remat=False).init(jax.random.PRNGKey(7))
    return _INITS[name]


def _block_params(name, mixer_index):
    """One superblock's params of a reduced arch's sublayer, as numpy f32."""
    blocks = _ref_init(name)["blocks"][str(mixer_index)]
    return REF_ARCHS[name].reduced(), {k: np.asarray(v[0]) for k, v in blocks.items()}


def _cast(p: dict, td) -> tuple[dict, dict]:
    """The reference's per-superblock cast: matrices to the compute dtype."""
    port = {k: _t(v, td) if v.ndim >= 2 else _t(v) for k, v in p.items()}
    jd = jnp.float32 if td == torch.float32 else jnp.bfloat16
    ref = {k: jnp.asarray(v, jd) if v.ndim >= 2 else jnp.asarray(v) for k, v in p.items()}
    return port, ref


MIXERS = {
    "mamba": ("jamba-v0.1-52b", 0, ssm.mamba_mix, ref_ssm.mamba_mix, {"chunk": 8}),
    "mlstm": ("xlstm-1.3b", 0, xlstm.mlstm_mix, ref_xlstm.mlstm_mix,
              {"n_heads": 4}),
    "slstm": ("xlstm-1.3b", 7, xlstm.slstm_mix, ref_xlstm.slstm_mix, {"n_heads": 4}),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_prefill_and_decode(mixer, dt):
    name, idx, fn, ref_fn, opts = MIXERS[mixer]
    jd, td, tol = DTYPES[dt]
    cfg, p = _block_params(name, idx)
    port_p, ref_p = _cast(p, td)
    rng = np.random.default_rng(6)
    # 16 steps: two Mamba chunks of 8, the carry between them included
    x, x1 = _rand(rng, B, 16, cfg.d_model), _rand(rng, B, 1, cfg.d_model)
    y, st = fn(port_p, _t(x, td), None, **opts)
    ry, rst = jax.jit(lambda pp, xx: ref_fn(pp, xx, None, **opts))(ref_p, jnp.asarray(x, jd))
    _close(y, ry, tol, f"{mixer} prefill")
    for k in rst:
        _close(st[k], rst[k], tol, f"{mixer} state {k}")
    y1, st1 = fn(port_p, _t(x1, td), st, **opts)
    ry1, rst1 = jax.jit(lambda pp, xx, s: ref_fn(pp, xx, s, **opts))(
        ref_p, jnp.asarray(x1, jd), rst)
    _close(y1, ry1, tol, f"{mixer} decode")
    for k in rst1:
        _close(st1[k], rst1[k], tol, f"{mixer} decode state {k}")


# ---------------------------------------------------------------------------
# the LM: prefill and decode logits and caches, six reduced archs
# ---------------------------------------------------------------------------


_RUNS: dict = {}


def _batches(cfg, rng):
    pre, dec = {}, {"pos": T}
    if cfg.embed_input:
        pre["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    else:
        pre["frames"] = _rand(rng, B, T, cfg.d_model)
        dec["frame"] = _rand(rng, B, cfg.d_model)
    if cfg.n_img_tokens:
        pre["img_embeds"] = dec["img_embeds"] = _rand(rng, B, cfg.n_img_tokens, cfg.d_model)
    return pre, dec


def _lm_runs(name: str, dt: str) -> dict:
    """Both packages' prefill and one greedy decode step on the same
    parameters and inputs (the reference's computed once per arch and
    dtype, under ``jax.jit`` as its engine runs it)."""
    if (name, dt) in _RUNS:
        return _RUNS[name, dt]
    jd, td, _ = DTYPES[dt]
    rcfg = REF_ARCHS[name].reduced()
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, dispatch_mode="sort")
    cfg = dataclasses.replace(ARCHS[name].reduced(), dispatch_mode=rcfg.dispatch_mode)
    ref = RefLM(rcfg, compute_dtype=jd, remat=False)
    raw = _ref_init(name)
    model = LM(cfg, compute_dtype=td, device="cpu")
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, raw), model)
    rng = np.random.default_rng(8)
    pre, dec = _batches(cfg, rng)
    rcache, rlogits = jax.jit(ref.prefill)(raw, jax.tree_util.tree_map(jnp.asarray, pre),
                                           ref.init_cache(B, S))
    cache, logits = model.prefill(params, pre, model.init_cache(B, S))
    out = {"ref_prefill": (np.asarray(rlogits), lm_cache_to_numpy_ref(rcache)),
           "prefill": (logits.numpy(), lm_cache_to_numpy(cache))}
    if cfg.embed_input:
        dec["token"] = np.asarray(rlogits).argmax(-1).astype(np.int32)
    rcache, rlogits = jax.jit(ref.decode_step)(raw, rcache,
                                               jax.tree_util.tree_map(jnp.asarray, dec))
    cache, logits = model.decode_step(params, cache, dec)
    out["ref_decode"] = (np.asarray(rlogits), lm_cache_to_numpy_ref(rcache))
    out["decode"] = (logits.numpy(), lm_cache_to_numpy(cache))
    out["model"], out["params"], out["dec"] = model, params, dec
    _RUNS[name, dt] = out
    return out


def lm_cache_to_numpy_ref(cache) -> dict:
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), cache)


def _caches_close(got: dict, want: dict, tol, what):
    assert got.keys() == want.keys()
    for i in want:
        assert got[i].keys() == want[i].keys()
        for k in want[i]:
            _close(got[i][k], want[i][k], tol, f"{what} cache {i}.{k}")


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_logits_and_caches_f32(name, step):
    runs = _lm_runs(name, "f32")
    (got, got_cache), (want, want_cache) = runs[step], runs["ref_" + step]
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want, F32_TOL, f"{name} {step} logits")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _caches_close(got_cache, want_cache, F32_TOL, f"{name} {step}")


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("name", BF16_ARCHS)
def test_lm_logits_bf16(name, step):
    runs = _lm_runs(name, "bf16")
    (got, _), (want, _) = runs[step], runs["ref_" + step]
    assert got.dtype == np.float32  # logits stay f32 at bf16 compute
    _close(got, want, BF16_TOL, f"{name} {step} logits")


def test_decode_from_the_reference_cache():
    """The port's decode step fed the reference's own prefill cache (via
    ``lm_cache_from_numpy``) lands on the reference's decode logits."""
    runs = _lm_runs("jamba-v0.1-52b", "f32")
    model, params, dec = runs["model"], runs["params"], runs["dec"]
    cache = lm_cache_from_numpy(runs["ref_prefill"][1], device="cpu")
    _, logits = model.decode_step(params, cache, dec)
    _close(logits, runs["ref_decode"][0], F32_TOL, "decode from the reference's cache")


def test_cache_round_trip_and_dtypes():
    model = LM(ARCHS["jamba-v0.1-52b"].reduced(), device="cpu")
    cache = model.init_cache(2, 8)
    assert cache["4"]["k"].dtype == torch.bfloat16 and cache["0"]["h"].dtype == torch.float32
    back = lm_cache_from_numpy(lm_cache_to_numpy(cache), device="cpu")
    assert back["4"]["k"].dtype == torch.float32  # numpy f32 crosses as f32
    ref = RefLM(REF_ARCHS["xlstm-1.3b"].reduced(), remat=False).init_cache(2, 8)
    got = LM(ARCHS["xlstm-1.3b"].reduced(), device="cpu").init_cache(2, 8)
    _caches_close(lm_cache_to_numpy(got), lm_cache_to_numpy_ref(ref), 0.0, "init")
    bf = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, RefLM(
        REF_ARCHS["llama3-8b"].reduced(), remat=False).init_cache(2, 8)), device="cpu")
    assert bf["0"]["k"].dtype == torch.bfloat16


def test_forward_train_mode_matches_reference():
    """``_forward(mode="train")`` on master (f32) parameters, no cache:
    the hidden states and the (zero, dense) aux metrics of reduced
    llama3-8b at f32 against the reference's train-mode forward; a mode
    outside train, prefill and decode raises."""
    rcfg = REF_ARCHS["llama3-8b"].reduced()
    ref = RefLM(rcfg, compute_dtype=jnp.float32, remat=False)
    raw = _ref_init("llama3-8b")
    model = LM(ARCHS["llama3-8b"].reduced(), compute_dtype=torch.float32, device="cpu")
    params = lm_master_from_numpy(jax.tree_util.tree_map(np.asarray, raw), model)
    h = _rand(np.random.default_rng(12), B, T, rcfg.d_model)
    want, caches, want_aux = jax.jit(lambda p, x: ref._forward(
        p, x, mode="train", pos=jnp.int32(0), cache=None, img_embeds=None))(raw, jnp.asarray(h))
    got, aux = model._forward(params, _t(h), mode="train", pos=0, cache=None, img_embeds=None)
    _close(got, want, F32_TOL, "train-mode hidden states")
    assert caches == {} and sorted(aux) == sorted(want_aux)
    assert all(float(aux[k]) == float(want_aux[k]) == 0.0 for k in aux)
    with pytest.raises(ValueError, match="train, prefill, decode"):
        model._forward(params, _t(h), mode="score", pos=0, cache=None, img_embeds=None)
