"""The LM model zoo on PyTorch: one model class covering all ten
architectures, for training and serving.

A model is a stack of *superblocks*, the config's ``pattern`` of (mixer,
ffn) sublayers.  Every parameter is stacked over superblocks, as the JAX
package stacks it for its scan, and the forward pass is a Python loop
over the superblock index that reads views of the stacked tensors.  Three
modes share the forward code:

  train    — causal forward over (B, S), chunked-vocab loss, no cache;
  prefill  — causal forward over (B, S) that also fills the caches;
  decode   — single-token step against the caches (B, 1).

Parameters come in two forms.  *Serving* parameters are cast once, when
they are made or loaded (``init``, ``prepare``): every matrix (two or
more dims per superblock) and the embedding table to ``compute_dtype``,
every vector and scalar kept in f32, and the output head held in f32
with values rounded through ``compute_dtype``, so logits are f32
products of ``compute_dtype`` inputs, as the reference computes them.
*Master* parameters (``init_master``; ``convert.lm_master_from_numpy``)
are f32 throughout, as the reference trains them: the forward casts each
superblock's f32 matrices, the gathered embedding rows and the loss's
head to ``compute_dtype`` inside autograd's view, so gradients reach the
f32 leaves.  On serving parameters those casts find nothing to do.

Caches are stacked over superblocks too (``init_cache``); ``prefill`` and
``decode_step`` write them in place and return the same dict, so a caller
that still needs the old cache passes a copy.  Training reads no cache
and writes none.

Training rematerialises each superblock, as the reference does by
default (``remat=True``): in ``train`` mode with gradients enabled, a
superblock runs under a non-reentrant ``torch.utils.checkpoint`` whose
selective policy saves only the outputs of ``aten.mm`` and ``aten.addmm``
(the products with no batch dimension, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest in the
backward pass: the norms, rope, the casts of the f32 master slices,
attention's batched products and softmax, the MoE dispatch.  No op of
the forward draws random numbers, so the checkpoint keeps no RNG state.
Training takes no cache, so a recomputed superblock writes into no
buffer it did not allocate.  Remat changes memory and time, not values:
with deterministic kernels the loss and every gradient equal those of
``remat=False`` bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.u32 import resolve_device
from repro_torch.distributed.ctx import axis_size, constrain, current

from .layers import (
    _contiguous_stride,
    apply_rope,
    chunked_softmax_xent,
    decode_attention,
    flash_attention,
    rms_norm,
    silu,
    write_cache,
)
from .moe import moe_ffn
from .ssm import mamba_mix
from .xlstm import mlstm_mix, slstm_mix

__all__ = ["LM", "input_specs"]

_F32 = torch.float32
#: the MoE aux metrics, summed over the MoE sublayers and averaged over
#: the superblocks
_AUX = ("lb_loss", "z_loss", "dropped_frac")
#: the ops whose outputs a rematerialised superblock keeps: a (B, T, d) @
#: (d, f) product reaches ATen as ``mm``; attention's products and the
#: MoE experts' reach it as ``bmm``, which has a batch dimension
_REMAT_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective checkpoint's policy: keep the products without a
    batch dimension, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _REMAT_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts():
    return create_selective_checkpoint_contexts(remat_policy)


def _gather_data_axes(w: torch.Tensor) -> torch.Tensor:
    """On a mesh, a (compute-dtype) weight made whole over the data axes
    and left split over the model axis: FSDP's gather before use.  Left
    to itself, DTensor's per-op choice keeps the weight's data split and
    splits the contraction of the batch's tokens over it instead, so
    every rank computes partial sums over all the microbatch's tokens and
    keeps them; the gathered weight is not kept (remat recomputes it in
    the backward, where its gradient reduce-scatters back).  A no-op off
    a mesh."""
    ctx = current()
    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, data, _ = ctx
    pl = [Replicate() if name in data else p for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w.redistribute(mesh, pl)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A (B, T, heads*hd) projection on a mesh: the batch over the data
    axes and the heads over the model axis where it divides them, else
    whole, so that splitting off the head dim is an even view; a no-op
    off a mesh."""
    ms = axis_size("model")
    return constrain(x, "data", None, "model" if ms > 1 and n_heads % ms == 0 else None)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``.  On DTensors each rank gathers from its own block of
    the table with its own indices: the table's rows are made whole (a
    vocab-split table is gathered first) and the indices whole wherever the
    table is split; the rows come out split as the indices and the
    table's columns are, and the table's gradient is a partial sum over the
    mesh dims that split the indices."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    rep = Replicate()
    tpl = [pl if isinstance(pl, Shard) and pl.dim > 0 else rep for pl in table.placements]
    table = table.redistribute(mesh, tpl)
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [rep] * mesh.ndim, run_check=False)
    ipl = [rep if isinstance(tp, Shard) or not isinstance(ip, Shard) else ip
           for tp, ip in zip(tpl, idx.placements)]
    idx = idx.redistribute(mesh, ipl)
    out_pl = [Shard(idx.ndim + tp.dim - 1) if isinstance(tp, Shard) else ip
              for tp, ip in zip(tpl, ipl)]
    grad_pl = [Partial() if isinstance(ip, Shard) else tp for tp, ip in zip(tpl, ipl)]
    out = table.to_local(grad_placements=grad_pl)[idx.to_local()]
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    return DTensor.from_local(out, mesh, out_pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class _Init:
    """Makes each stacked parameter on the device in its final dtype, so a
    full-width model never holds an f32 copy of a matrix in whole."""

    def __init__(self, nsb: int, gen: torch.Generator, device, dtype):
        self.nsb, self.gen, self.device, self.dtype = nsb, gen, device, dtype

    def lin(self, fan_in: int, shape: tuple) -> torch.Tensor:
        t = torch.randn((self.nsb, *shape), generator=self.gen, device=self.device,
                        dtype=self.dtype)
        return t.mul_(fan_in ** -0.5)

    def full(self, shape: tuple, value: float) -> torch.Tensor:
        return torch.full((self.nsb, *shape), value, dtype=_F32, device=self.device)


def _init_sublayer(cfg: ArchConfig, mixer: str, ffn: str, mk: _Init) -> dict:
    d, hd, H, G = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p: dict = {"ln": mk.full((d,), 1.0)}
    if mixer in ("attn", "xattn"):
        p.update(
            wq=mk.lin(d, (d, H * hd)),
            wk=mk.lin(d, (d, G * hd)),
            wv=mk.lin(d, (d, G * hd)),
            wo=mk.lin(H * hd, (H * hd, d)),
        )
        if cfg.qk_norm:
            p.update(q_norm=mk.full((hd,), 1.0), k_norm=mk.full((hd,), 1.0))
        if mixer == "xattn":
            p.update(gate=mk.full((), 0.0), ln_kv=mk.full((d,), 1.0))
    elif mixer == "mamba":
        di, N, r_ = cfg.ssm_expand * d, cfg.ssm_state, cfg.dt_rank
        u = torch.rand((mk.nsb, di), generator=mk.gen, device=mk.device, dtype=_F32)
        a_log = torch.log(torch.arange(1, N + 1, dtype=_F32, device=mk.device))
        p.update(
            in_proj=mk.lin(d, (d, 2 * di)),
            conv_w=mk.lin(cfg.ssm_conv, (di, cfg.ssm_conv)),
            conv_b=mk.full((di,), 0.0),
            x_proj=mk.lin(di, (di, r_ + 2 * N)),
            dt_proj=mk.lin(r_, (r_, di)),
            dt_bias=torch.log(torch.expm1(1e-3 + u * (0.1 - 1e-3))),
            A_log=a_log.expand(mk.nsb, di, N).to(mk.dtype).contiguous(),
            D=mk.full((di,), 1.0),
            out_proj=mk.lin(di, (di, d)),
        )
    elif mixer == "mlstm":
        di = cfg.xlstm_expand * d
        p.update(
            w_up=mk.lin(d, (d, 2 * di)),
            wq_l=mk.lin(di, (di, di)),
            wk_l=mk.lin(di, (di, di)),
            wv_l=mk.lin(di, (di, di)),
            wi=mk.lin(di, (di, cfg.xlstm_heads)),
            wf=mk.lin(di, (di, cfg.xlstm_heads)),
            w_down=mk.lin(di, (di, d)),
        )
    elif mixer == "slstm":
        Hx = cfg.xlstm_heads
        dh = d // Hx
        p.update({f"sw_{g}": mk.lin(d, (d, d)) for g in "ifzo"})
        p.update({f"r_{g}": mk.lin(dh, (Hx, dh, dh)) for g in "ifzo"})
        p.update(b_i=mk.full((d,), 0.0), b_f=mk.full((d,), 1.0))  # forget bias > 0
    else:
        raise ValueError(mixer)

    if ffn == "dense":
        p.update(
            ln2=mk.full((d,), 1.0),
            w1=mk.lin(d, (d, cfg.d_ff)),
            w3=mk.lin(d, (d, cfg.d_ff)),
            w2=mk.lin(cfg.d_ff, (cfg.d_ff, d)),
        )
    elif ffn == "moe":
        E, f = cfg.n_experts, cfg.moe_d_ff
        p.update(
            ln2=mk.full((d,), 1.0),
            router=mk.lin(d, (d, E)),
            moe_w1=mk.lin(d, (E, d, f)),
            moe_w3=mk.lin(d, (E, d, f)),
            moe_w2=mk.lin(f, (E, f, d)),
        )
        if cfg.shared_expert:
            p.update(
                w1=mk.lin(d, (d, cfg.d_ff)),
                w3=mk.lin(d, (d, cfg.d_ff)),
                w2=mk.lin(cfg.d_ff, (cfg.d_ff, d)),
            )
    elif ffn != "none":
        raise ValueError(ffn)
    return p


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclass
class LM:
    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16
    #: where parameters, caches and the forward pass live: CUDA unless the
    #: caller names another device
    device: object = None
    #: recompute each superblock in the backward pass of ``train`` mode
    remat: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ----------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> dict:
        """Random serving parameters from ``generator`` (a generator on
        ``self.device``), made in their final dtypes: N(0, 1/fan_in)
        matrices, ones for the norms, Mamba's S4D-real ``A_log``."""
        return self._make(generator, self.compute_dtype)

    def init_master(self, generator: torch.Generator) -> dict:
        """Random master parameters for training: :meth:`init`'s layout,
        every leaf f32.  The leaves do not require grad; a train step
        takes gradients with respect to detached views of them."""
        return self._make(generator, _F32)

    def _make(self, generator: torch.Generator, dtype: torch.dtype) -> dict:
        cfg = self.cfg
        one = _Init(1, generator, self.device, dtype)
        mk = _Init(cfg.n_superblocks, generator, self.device, dtype)
        params: dict = {"embed": one.lin(cfg.d_model, (cfg.vocab_size, cfg.d_model))[0]}
        params["blocks"] = {
            str(i): _init_sublayer(cfg, mixer, ffn, mk)
            for i, (mixer, ffn) in enumerate(cfg.pattern)
        }
        params["final_norm"] = torch.ones(cfg.d_model, dtype=_F32, device=self.device)
        if not cfg.tie_embeddings:  # f32, with values in the compute dtype
            params["lm_head"] = one.lin(cfg.d_model, (cfg.d_model, cfg.vocab_size))[0].float()
        return params

    def param_struct(self, dtype: torch.dtype = _F32) -> dict:
        """The parameter tree as ``meta`` tensors (shapes and dtypes, no
        storage): f32 master leaves by default."""
        return LM(self.cfg, self.compute_dtype, device="meta")._make(torch.Generator(), dtype)

    def cache_struct(self, batch_size: int, max_seq: int) -> dict:
        """:meth:`init_cache`'s tree as ``meta`` tensors."""
        return LM(self.cfg, self.compute_dtype, device="meta").init_cache(batch_size, max_seq)

    def prepare(self, raw: dict) -> dict:
        """The one cast at load: a parameter tree in the reference's layout
        (tensors of any dtype, matrices stacked over superblocks) -> the
        port's parameters on ``self.device``."""
        cd, dev = self.compute_dtype, self.device

        def block_leaf(t: torch.Tensor) -> torch.Tensor:
            t = t.to(dev)
            # per superblock: f32 matrices to the compute dtype, the rest f32
            return t.to(cd) if t.is_floating_point() and t.dim() >= 3 else t.to(_F32)

        params = {
            "embed": raw["embed"].to(dev).to(cd),
            "blocks": {i: {name: block_leaf(t) for name, t in sub.items()}
                       for i, sub in raw["blocks"].items()},
            "final_norm": raw["final_norm"].to(dev).to(_F32),
        }
        if not self.cfg.tie_embeddings:
            params["lm_head"] = raw["lm_head"].to(dev).to(cd).to(_F32)
        return params

    # ---------------------------------------------------------------- pieces
    def _head(self, params) -> torch.Tensor:
        """The (d, V) f32 head with values in the compute dtype."""
        if self.cfg.tie_embeddings:
            return params["embed"].T.to(_F32)
        return params["lm_head"]

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """(B, V) f32 logits of the (B, d) states ``h``.  On a mesh, as in
        :meth:`loss`: the states split by batch and whole in d, the head
        whole in d and split over the vocab, so no rank multiplies the
        whole batch by a slice of d."""
        h = constrain(h.to(_F32), "data", None)
        return h @ constrain(self._head(params), None, "model")

    def _input(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, DTensor):  # already on the mesh's devices
            return x if dtype is None else x.to(dtype)
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        """The reference's per-superblock cast: an f32 leaf of two or more
        dims to the compute dtype (a no-op on serving parameters)."""
        return t.to(self.compute_dtype) if t.dtype == _F32 and t.dim() >= 2 else t

    def _embed(self, params, batch) -> torch.Tensor:
        if self.cfg.embed_input:
            # gather, then cast: the rows the reference gathers from its
            # cast table; a repeated token's row gradients add up in f32
            tokens = self._input(batch["tokens"], torch.int64)
            return gather_rows(params["embed"], tokens).to(self.compute_dtype)
        return self._input(batch["frames"]).to(self.compute_dtype)  # audio stub frontend

    def _attn(self, p, h, mode, pos, kv_cache):
        cfg = self.cfg
        B, T, _ = h.shape
        H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        x = rms_norm(h, p["ln"], cfg.norm_eps)
        q = _split_heads(x @ p["wq"], H).reshape(B, T, H, hd).transpose(1, 2)
        k = _split_heads(x @ p["wk"], G).reshape(B, T, G, hd).transpose(1, 2)
        v = _split_heads(x @ p["wv"], G).reshape(B, T, G, hd).transpose(1, 2)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cfg.rope_theta > 0:
            positions = pos + torch.arange(T, device=h.device)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if mode in ("train", "prefill"):
            if mode == "prefill":
                write_cache(kv_cache["k"], k, 0)
                write_cache(kv_cache["v"], v, 0)
            if cfg.attn_repeat_kv and G < H:
                k, v = k.repeat_interleave(H // G, dim=1), v.repeat_interleave(H // G, dim=1)
            o = flash_attention(q, k, v, causal=True,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        else:  # decode: the new KV goes in at pos, in place
            write_cache(kv_cache["k"], k, pos)
            write_cache(kv_cache["v"], v, pos)
            # the query whole in heads on every rank (small): each rank
            # attends with all of them over its slice of the cache
            o = decode_attention(constrain(q, "data", None, None, None), kv_cache["k"],
                                 kv_cache["v"], pos + 1, kv_chunk=cfg.kv_chunk)
        # split as the projections are, so that the backward's view back to
        # heads is an even one too
        o = _split_heads(o.transpose(1, 2).reshape(B, T, H * hd), H)
        return h + (o @ p["wo"]).to(h.dtype)

    def _xattn(self, p, h, mode, img_embeds, cache):
        cfg = self.cfg
        B, T, _ = h.shape
        H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        x = rms_norm(h, p["ln"], cfg.norm_eps)
        q = _split_heads(x @ p["wq"], H).reshape(B, T, H, hd).transpose(1, 2)
        if mode == "decode" and cache is not None:
            k, v = cache["k_img"], cache["v_img"]
        else:
            y = rms_norm(self._input(img_embeds).to(h.dtype), p["ln_kv"], cfg.norm_eps)
            n_img = y.shape[1]
            k = _split_heads(y @ p["wk"], G).reshape(B, n_img, G, hd).transpose(1, 2)
            v = _split_heads(y @ p["wv"], G).reshape(B, n_img, G, hd).transpose(1, 2)
            if cache is not None:
                cache["k_img"].copy_(k)
                cache["v_img"].copy_(v)
        o = flash_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        o = _split_heads(o.transpose(1, 2).reshape(B, T, H * hd), H)
        return h + torch.tanh(p["gate"]).to(h.dtype) * (o @ p["wo"]).to(h.dtype)

    def _dense_ffn(self, p, h):
        x = rms_norm(h, p["ln2"], self.cfg.norm_eps)
        y = (silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
        return h + y.to(h.dtype)

    def _moe_ffn(self, p, h):
        cfg = self.cfg
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        y, aux = moe_ffn(
            p,
            x,
            n_experts=cfg.n_experts,
            top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            dispatch_mode=cfg.dispatch_mode,
            shared_expert=cfg.shared_expert,
        )
        return h + y.to(h.dtype), aux

    # --------------------------------------------------------------- forward
    def _forward(self, params, h, *, mode, pos, cache, img_embeds):
        """The superblock loop.  Writes the new cache entries into
        ``cache`` in place (``train`` takes no cache) and returns the
        hidden states and the MoE aux metrics: each summed over the MoE
        sublayers, over the superblocks, then divided by their number.
        With ``remat``, a ``train`` superblock runs under the selective
        checkpoint (module docstring)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {mode!r}: not one of train, prefill, decode")
        cfg = self.cfg
        cache = cache or {}
        remat = self.remat and mode == "train" and torch.is_grad_enabled()
        aux = [torch.zeros((), dtype=_F32, device=h.device) for _ in _AUX]
        for sb in range(cfg.n_superblocks):
            # the f32 slices go in, so the casts inside are recomputed, not held
            p_sb = {i: {name: t[sb] for name, t in sub.items()}
                    for i, sub in params["blocks"].items()}
            c_sb = {i: {name: t[sb] for name, t in sub.items()} for i, sub in cache.items()}
            if remat:
                h, a = checkpoint(self._superblock, h, p_sb, c_sb, mode, pos, img_embeds,
                                  use_reentrant=False, context_fn=_remat_contexts,
                                  preserve_rng_state=False)
            else:
                h, a = self._superblock(h, p_sb, c_sb, mode, pos, img_embeds)
            aux = [x + y for x, y in zip(aux, a)]
        return h, {k: v / cfg.n_superblocks for k, v in zip(_AUX, aux)}

    def _superblock(self, h, p_sb, c_sb, mode, pos, img_embeds):
        """One superblock: every sublayer of ``cfg.pattern`` over ``h``.
        ``p_sb`` holds this superblock's parameter slices, ``c_sb`` its
        cache slices (written in place); returns the hidden states and the
        MoE aux terms summed over the sublayers, in ``_AUX``'s order."""
        cfg = self.cfg
        mixers = {"mamba": (mamba_mix, {"chunk": cfg.ssm_chunk}),
                  "mlstm": (mlstm_mix, {"n_heads": cfg.xlstm_heads}),
                  "slstm": (slstm_mix, {"n_heads": cfg.xlstm_heads})}
        aux = [torch.zeros((), dtype=_F32, device=h.device) for _ in _AUX]
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            pm = {name: _gather_data_axes(self._cast(t)) for name, t in p_sb[str(i)].items()}
            csl = c_sb.get(str(i))
            # on a mesh the residual stream is split by batch and whole in d
            # before each sublayer (Megatron's layout): every projection
            # then has a placement that moves nothing
            h = constrain(h, "data", None, None)
            if mixer == "attn":
                h = self._attn(pm, h, mode, pos, csl)
            elif mixer == "xattn":
                h = self._xattn(pm, h, mode, img_embeds, csl)
            else:
                fn, opts = mixers[mixer]
                x = rms_norm(h, pm["ln"], cfg.norm_eps)
                y, state = fn(pm, x, csl if mode == "decode" else None, **opts)
                h = h + y.to(h.dtype)
                if csl is not None:  # no cache in train: the state is dropped
                    for name, t in state.items():
                        csl[name].copy_(t)
            h = constrain(h, "data", None, None)
            if ffn == "dense":
                h = self._dense_ffn(pm, h)
            elif ffn == "moe":
                h, a = self._moe_ffn(pm, h)
                aux = [x + a[k] for x, k in zip(aux, _AUX)]
        return h, tuple(aux)

    # ------------------------------------------------------------------ API
    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """The training loss of ``batch`` (``tokens`` or ``frames``,
        ``labels``, optional ``mask`` and ``img_embeds``): the chunked
        cross entropy, plus ``0.01 lb_loss + 1e-3 z_loss`` with experts;
        ``(loss, {xent, lb_loss, z_loss, dropped_frac})``, () f32 tensors."""
        cfg = self.cfg
        h = self._embed(params, batch)
        img = batch.get("img_embeds")
        h, aux = self._forward(params, h, mode="train", pos=0, cache=None, img_embeds=img)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        raw = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        mask = batch.get("mask")
        # on a mesh: the batch over the data axes and the head whole in d,
        # split over the vocab, so every chunk's logits are split by batch
        # and vocab (one gather of the head a step, not one a chunk)
        h = constrain(h, "data", None, None)
        head = constrain(raw.to(self.compute_dtype), None, "model")
        xent = chunked_softmax_xent(
            h, head, self._input(batch["labels"], torch.int64),
            mask=None if mask is None else self._input(mask), chunk=cfg.loss_chunk)
        loss = xent
        if cfg.n_experts:
            loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        return loss, {"xent": xent, **aux}

    def prefill(self, params, batch, cache) -> tuple[dict, torch.Tensor]:
        """Causal forward over ``batch["tokens"]`` (B, T) (or ``frames``),
        filling ``cache``; returns ``(cache, last-token logits (B, V) f32)``."""
        h = self._embed(params, batch)
        h, _ = self._forward(params, h, mode="prefill", pos=0, cache=cache,
                             img_embeds=batch.get("img_embeds"))
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return cache, self._logits(params, h[:, -1])

    def decode_step(self, params, cache, batch) -> tuple[dict, torch.Tensor]:
        """batch: {token: (B,) | frame: (B, d), pos: int} -> (cache, logits)."""
        pos = int(batch["pos"])
        if self.cfg.embed_input:
            h = gather_rows(params["embed"], self._input(batch["token"], torch.int64))[:, None]
        else:
            h = self._input(batch["frame"])[:, None].to(self.compute_dtype)
        h, _ = self._forward(params, h, mode="decode", pos=pos, cache=cache,
                             img_embeds=batch.get("img_embeds"))
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return cache, self._logits(params, h[:, 0])

    # ---------------------------------------------------------------- caches
    def init_cache(self, batch_size: int, max_seq: int) -> dict:
        """Zero caches, stacked over superblocks."""
        cfg = self.cfg
        B, S = batch_size, max_seq
        G, hd, d = cfg.n_kv_heads, cfg.hd, cfg.d_model
        nsb, cd, dev = cfg.n_superblocks, self.compute_dtype, self.device

        def zeros(*shape, dtype=cd):
            return torch.zeros((nsb, B, *shape), dtype=dtype, device=dev)

        out: dict = {}
        for i, (mixer, _ffn) in enumerate(cfg.pattern):
            if mixer == "attn":
                out[str(i)] = {"k": zeros(G, S, hd), "v": zeros(G, S, hd)}
            elif mixer == "xattn":
                n_img = cfg.n_img_tokens
                out[str(i)] = {"k_img": zeros(G, n_img, hd), "v_img": zeros(G, n_img, hd)}
            elif mixer == "mamba":
                di, N, cw = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_conv
                out[str(i)] = {"h": zeros(di, N, dtype=_F32), "conv": zeros(cw - 1, di)}
            elif mixer == "mlstm":
                di, Hx = cfg.xlstm_expand * d, cfg.xlstm_heads
                dh = di // Hx
                out[str(i)] = {
                    "C": zeros(Hx, dh, dh, dtype=_F32),
                    "n": zeros(Hx, dh, dtype=_F32),
                    "m": zeros(Hx, dtype=_F32).fill_(-math.inf),
                }
            elif mixer == "slstm":
                Hx = cfg.xlstm_heads
                dh = d // Hx
                out[str(i)] = {
                    "h": zeros(Hx, dh, dtype=_F32),
                    "c": zeros(Hx, dh, dtype=_F32),
                    "n": zeros(Hx, dh, dtype=_F32).fill_(1.0),
                    "m": zeros(Hx, dh, dtype=_F32),
                }
        return out


# ---------------------------------------------------------------------------
# dry-run input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of a shape cell: ``meta`` tensors,
    with the keys, shapes and dtypes of the real batch and no storage
    (the modality frontends of [audio]/[vlm] archs are stubs: precomputed
    frame/patch embeddings appear here as inputs)."""
    B, S = shape.global_batch, shape.seq_len
    bf16, i32 = torch.bfloat16, torch.int32
    d = cfg.d_model

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        batch: dict = {}
        if cfg.embed_input:
            batch["tokens"] = sds((B, S), i32)
        else:
            batch["frames"] = sds((B, S, d), bf16)
        batch["labels"] = sds((B, S), i32)
        if cfg.n_img_tokens:
            batch["img_embeds"] = sds((B, cfg.n_img_tokens, d), bf16)
        return batch
    if shape.kind == "prefill":
        batch = {}
        if cfg.embed_input:
            batch["tokens"] = sds((B, S), i32)
        else:
            batch["frames"] = sds((B, S, d), bf16)
        if cfg.n_img_tokens:
            batch["img_embeds"] = sds((B, cfg.n_img_tokens, d), bf16)
        return batch
    # decode
    batch = {"pos": sds((), i32)}
    if cfg.embed_input:
        batch["token"] = sds((B,), i32)
    else:
        batch["frame"] = sds((B, d), bf16)
    if cfg.n_img_tokens:
        batch["img_embeds"] = sds((B, cfg.n_img_tokens, d), bf16)
    return batch
