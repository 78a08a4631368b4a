"""Shared model layers in plain PyTorch.

Attention keeps the JAX package's blockwise online softmax as it is: the
same ``q_chunk``/``kv_chunk`` segments, the same ``-inf`` guards for fully
masked rows, the causal offset for queries at the end of a longer context
and the zero pad of a ragged decode tail.  The tests hold these functions
tightly against the reference, so nothing here calls
``F.scaled_dot_product_attention``, whose blocking and reduction order
are its own.

The loss is the reference's chunked-vocab cross entropy: (B, T, V)
logits never exist at once, one (B, chunk, V) f32 block at a time.

Where the reference asks for f32 products of bf16 inputs, the port
up-casts the inputs and multiplies in f32: the reference does the same on
the CPU, and a bf16 product is exact in f32, so only the summation order
differs on the card.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.ctx import axis_size, constrain, current

__all__ = [
    "rms_norm",
    "silu",
    "rope_freqs",
    "apply_rope",
    "flash_attention",
    "decode_attention",
    "write_cache",
    "chunked_softmax_xent",
]


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * w.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, T, dh); positions: (T,) or (B, T)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].float() * inv  # (..., T, dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.dim() == 1:
        cos, sin = cos[None, None], sin[None, None]
    else:  # (B, T, dh/2) -> (B, 1, T, dh/2)
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _einsum_f32(sub: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of two (bf16) operands in f32, from up-cast inputs."""
    return torch.einsum(sub, a.float(), b.float())


def _block_attn_update(q_i, k_j, v_j, m, l, acc, mask=None, scale=1.0):
    """One online-softmax block update.

    q_i: (B, G, r, qc, dh); k_j/v_j: (B, G, kc, dh);
    m, l: (B, G, r, qc); acc: (B, G, r, qc, dh) f32.
    """
    s = _einsum_f32("bgrqd,bgkd->bgrqk", q_i, k_j) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new == -inf)
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m, -math.inf))
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + _einsum_f32(
        "bgrqk,bgkd->bgrqd", p.to(v_j.dtype), v_j)
    return m_new, l_new, acc_new


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Blockwise GQA attention.  q: (B, Hq, Tq, dh); k, v: (B, G, Tk, dh).

    One segment per q chunk, each carrying a chunk-local (B, G, r, qc, dh)
    online-softmax state through exactly the kv chunks it can see (all of
    them without ``causal``).  A length that the chunk does not divide
    (small tests, a prefix of odd length) is one block.
    """
    if isinstance(q, DTensor):
        return _mesh_flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    B, Hq, Tq, dh = q.shape
    G, Tk = k.shape[1], k.shape[2]
    r = Hq // G
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)
    if Tq % q_chunk:  # ragged: single q block
        q_chunk = Tq
    if Tk % kv_chunk:
        kv_chunk = Tk
    nq, nk = Tq // q_chunk, Tk // kv_chunk
    qg = q.reshape(B, G, r, Tq, dh)
    scale = 1.0 / math.sqrt(dh)

    # causal offset: queries are the *last* Tq positions of the Tk context
    off = Tk - Tq
    k_pos = torch.arange(kv_chunk, device=q.device)

    outs = []
    for i in range(nq):
        q_i = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
        if causal:
            last_q = off + (i + 1) * q_chunk - 1
            n_vis = min(last_q // kv_chunk + 1, nk)
        else:
            n_vis = nk
        m = torch.full((B, G, r, q_chunk), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, G, r, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, G, r, q_chunk, dh), dtype=torch.float32, device=q.device)
        gq = off + i * q_chunk + torch.arange(q_chunk, device=q.device)
        for j in range(n_vis):
            k_j = k[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            v_j = v[:, :, j * kv_chunk:(j + 1) * kv_chunk]
            mask = None
            if causal:
                gk = j * kv_chunk + k_pos
                mask = (gq[:, None] >= gk[None, :])[None, None, None]
            m, l, acc = _block_attn_update(q_i, k_j, v_j, m, l, acc, mask, scale)
        outs.append(acc / l[..., None].clamp_min(1e-30))

    out = torch.cat(outs, dim=3)
    return out.reshape(B, Hq, Tq, dh).to(q.dtype)


def _mesh_flash_attention(q, k, v, **kw):
    """:func:`flash_attention` of DTensors inside ``use_mesh``: each rank
    runs the blocks on its own batch rows and heads, as plain tensors.

    The batch goes over the data axes.  Over the model axis the query
    heads are split in contiguous chunks of ``c = Hq / ms`` when a chunk
    holds whole groups or lies inside one (``c % r == 0`` or
    ``r % c == 0``): the KV heads go with them when ``G`` divides the
    axis, else they are replicated and each rank reads its chunk's groups
    (the JAX package's three cases: shard G; shard the repeat dim r and
    replicate the small KV; shard G unevenly — here the uneven case is
    evened out, ``c`` heads a rank).  Otherwise the heads are replicated
    over the model axis, and so is the attention math.  The blocks run on
    local tensors, so no op inside them has to follow DTensor's view rules
    (which cannot flatten a sharded head dim into a batch dim)."""
    ctx = current()
    if ctx is None:
        raise RuntimeError("attention over DTensors runs inside distributed.ctx.use_mesh")
    mesh, _, model_axis = ctx
    B, Hq, Tq, dh = q.shape
    G = k.shape[1]
    r = Hq // G
    ms = axis_size("model")
    c = Hq // ms if Hq % ms == 0 else 0
    heads = ms > 1 and c > 0 and (r % c == 0 or c % r == 0)
    kv_split = heads and G % ms == 0
    q = constrain(q, "data", "model" if heads else None, None, None)
    k = constrain(k, "data", "model" if kv_split else None, None, None)
    v = constrain(v, "data", "model" if kv_split else None, None, None)
    if heads and not kv_split:
        # a rank reads its chunk's groups: their KV gradient is a partial sum
        grad_pl = [Partial() if name == model_axis else pl
                   for name, pl in zip(mesh.mesh_dim_names, k.placements)]
        j = mesh.get_local_rank(model_axis)
        g0, g1 = (j * c) // r, ((j + 1) * c - 1) // r + 1
        kl = k.to_local(grad_placements=grad_pl)[:, g0:g1]
        vl = v.to_local(grad_placements=grad_pl)[:, g0:g1]
    else:
        kl, vl = k.to_local(), v.to_local()
    out = flash_attention(q.to_local(), kl, vl, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length,
    kv_chunk: int = 2048,
) -> torch.Tensor:
    """Single-token attention against a KV cache, flash-decoding style.

    q: (B, Hq, 1, dh); caches: (B, G, S, dh); length: an int, a () or a
    (B,) tensor of valid kv counts.  The sequence axis is split into
    segments whose online-softmax partials are merged by a max/logsumexp
    combine.  On a mesh (a DTensor cache) see
    :func:`_mesh_decode_attention`.
    """
    if isinstance(k_cache, DTensor):
        return _mesh_decode_attention(q, k_cache, v_cache, length, kv_chunk)
    B, Hq, _, dh = q.shape
    m, l, acc = _decode_partials(q, k_cache, v_cache, length, kv_chunk, offset=0)
    out = acc / l[..., None].clamp_min(1e-30)
    return out.reshape(B, Hq, 1, dh).to(q.dtype)


def _decode_partials(q, k_cache, v_cache, length, kv_chunk, offset):
    """The merged online-softmax partials of one cache slice: ``(m, l,
    acc)``, (B, G, r) maxima, (B, G, r) weights and (B, G, r, dh)
    unnormalized outputs, f32.  The slice holds the global positions
    ``offset ..``; a position counts where it lies below ``length`` and
    inside the slice (not in the zero pad of a ragged tail)."""
    B, Hq, _, dh = q.shape
    G, S = k_cache.shape[1], k_cache.shape[2]
    r = Hq // G
    kv_chunk = min(kv_chunk, S)
    n_real = S
    if S % kv_chunk:  # ragged tail (small tests): pad; masked out below
        pad = kv_chunk - S % kv_chunk
        zeros = torch.zeros((B, G, pad, dh), dtype=k_cache.dtype, device=k_cache.device)
        k_cache = torch.cat([k_cache, zeros], dim=2)
        v_cache = torch.cat([v_cache, zeros], dim=2)
        S += pad
    ns, sc = S // kv_chunk, kv_chunk
    qg = q.reshape(B, G, r, dh)
    k5 = k_cache.reshape(B, G, ns, sc, dh)
    v5 = v_cache.reshape(B, G, ns, sc, dh)
    scale = 1.0 / math.sqrt(dh)
    length = torch.as_tensor(length, device=q.device)
    lb = length.expand(B) if length.dim() == 0 else length  # (B,)

    s = _einsum_f32("bgrd,bgscd->bgrsc", qg, k5) * scale
    pos = (torch.arange(ns, device=q.device) * sc)[:, None] + torch.arange(sc, device=q.device)
    mask = (pos[None] + offset < lb[:, None, None]) & (pos[None] < n_real)
    mask = mask[:, None, None]  # (B, 1, 1, ns, sc)
    s = s.masked_fill(~mask, -math.inf)
    m_s = s.amax(dim=-1)  # (B, G, r, ns)
    safe = torch.where(torch.isfinite(m_s), m_s, 0.0)
    p = torch.exp(s - safe[..., None]).masked_fill(~mask, 0.0)
    l_s = p.sum(dim=-1)  # (B, G, r, ns)
    acc_s = _einsum_f32("bgrsc,bgscd->bgrsd", p.to(v5.dtype), v5)
    # merge the segments
    m = m_s.amax(dim=-1, keepdim=True)  # (B, G, r, 1)
    w = torch.where(torch.isfinite(m_s),
                    torch.exp(m_s - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    l = (w * l_s).sum(dim=-1)  # (B, G, r)
    acc = (w[..., None] * acc_s).sum(dim=3)  # (B, G, r, dh)
    return m[..., 0], l, acc


def _split_offset(cache: DTensor, dim: int) -> tuple[list, int]:
    """The mesh dims that split dim ``dim`` of a (B, G, S, dh) cache
    DTensor, and this rank's first global index along it.  The cache may
    be split only on its batch (data axes) and sequence (model axis)
    dims, as ``launch.shardings.cache_shardings`` places it."""
    mesh = cache.device_mesh
    dims = []
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard):
            if pl.dim not in (0, 2):
                raise ValueError(f"a KV cache split on dim {pl.dim}: only its batch and "
                                 "sequence dims may be split")
            if pl.dim == dim:
                dims.append(i)
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:  # DTensor splits a dim over its mesh dims in order
        idx = idx * mesh.size(i) + coord[i]
    return dims, idx * cache.to_local().shape[dim]


def _batch_like(x: torch.Tensor, cache: DTensor) -> torch.Tensor:
    """``x`` (a DTensor) as a local tensor split on its batch dim as the
    cache is, whole on every other dim."""
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in cache.placements]
    return x.redistribute(cache.device_mesh, pl).to_local()


def _mesh_decode_attention(q, k_cache, v_cache, length, kv_chunk):
    """:func:`decode_attention` of DTensors inside ``use_mesh``: the JAX
    package's flash-decoding over a cache whose sequence dim is split over
    the model axis.

    Each rank runs the segments of its own cache slice as plain tensors,
    masking by global position (its offset along the split plus the local
    one), against the query whole in heads (``(B_local, Hq, dh)``, small).
    The slices' partials are merged across the split with explicit
    collectives: the max of ``m``, then the sums of ``w·l`` and ``w·acc``
    (``w = exp(m - max)``) in one all-reduce, ``(B_local, Hq, dh + 2)`` f32
    in all.  The cache never moves.  Where the split leaves the sequence
    whole (``guard_spec``), every rank attends over all of it and there is
    nothing to merge.  The output goes back with the query's placements."""
    if current() is None:
        raise RuntimeError("attention over DTensors runs inside distributed.ctx.use_mesh")
    from torch.distributed import _functional_collectives as funcol

    mesh = k_cache.device_mesh
    B, Hq, _, dh = q.shape
    dims, offset = _split_offset(k_cache, 2)
    ql = _batch_like(q, k_cache)
    length = torch.as_tensor(length, device=ql.device)
    if length.dim():  # (B,) counts: this rank's batch rows
        b0 = _split_offset(k_cache, 0)[1]
        length = length[b0:b0 + ql.shape[0]]
    m, l, acc = _decode_partials(ql, k_cache.to_local(), v_cache.to_local(), length,
                                 kv_chunk, offset)
    for i in dims:
        top = funcol.all_reduce(m, "max", (mesh, i))
        w = torch.where(torch.isfinite(m),
                        torch.exp(m - torch.where(torch.isfinite(top), top, 0.0)), 0.0)
        part = torch.cat([(w * l)[..., None], w[..., None] * acc], dim=-1)
        part = funcol.all_reduce(part, "sum", (mesh, i))
        m, l, acc = top, part[..., 0], part[..., 1:]
    out = (acc / l[..., None].clamp_min(1e-30)).reshape(ql.shape[0], Hq, 1, dh).to(q.dtype)
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in k_cache.placements]
    shape = (B, Hq, 1, dh)
    out = DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                             stride=_contiguous_stride(shape))
    return out.redistribute(mesh, q.placements) if isinstance(q, DTensor) else out


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, :, start:start + T] = new`` in place: a (B, G, S, dh)
    cache, ``new`` (B, G, T, dh).  On a DTensor cache each rank writes
    the part of the range that falls inside its own sequence slice, in
    place in its local tensor (the JAX package's ``dynamic_update_slice``);
    a range may straddle two ranks' slices, and no rank gathers the
    cache."""
    if not isinstance(cache, DTensor):
        cache[:, :, start:start + new.shape[2]] = new
        return
    _, offset = _split_offset(cache, 2)
    local = cache.to_local()
    nl = _batch_like(new, cache)
    lo, hi = max(start, offset), min(start + nl.shape[2], offset + local.shape[2])
    if lo < hi:
        local[:, :, lo - offset:hi - offset] = nl[:, :, lo - start:hi - start]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``, the gold logit of each position.  A
    DTensor's vocab-sharded gather leaves a masked partial result that its
    reduction cannot take (beside a (B, T) operand); on a DTensor the gold
    logit is the sum over the vocab of the logits where the label hits,
    the same value, since every other term is zero."""
    if isinstance(logits, DTensor):
        hit = labels[..., None] == torch.arange(logits.shape[-1], device=labels.device)
        return torch.where(hit, logits, 0.0).sum(dim=-1)
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def chunked_softmax_xent(
    h: torch.Tensor,
    lm_head: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    chunk: int = 512,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Cross entropy without materializing (B, T, V) logits.

    h: (B, T, d); lm_head: (d, V); labels: (B, T) integers.  Loops over T
    in chunks computing per-chunk logits in f32 from the compute-dtype
    inputs (the reference's scan, one chunk a step); ``mask`` (B, T)
    weights each position, ``z_loss`` adds ``z_loss * lse^2``.  The
    mean over the mask's weight, as a () f32 tensor.
    """
    B, T, d = h.shape
    chunk = min(chunk, T)
    assert T % chunk == 0
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=h.device)
    mask = mask.to(torch.float32)
    labels = labels.to(torch.int64)
    head = lm_head.float()  # up-cast once: every chunk's product shares it
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(T // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = h[:, sl].float() @ head  # (B, chunk, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, labels[:, sl])
        m_c = mask[:, sl]
        nll = (lse - gold) * m_c
        if z_loss:
            nll = nll + z_loss * (lse * lse) * m_c
        tot = tot + nll.sum()
        cnt = cnt + m_c.sum()
    return tot / torch.clamp(cnt, min=1.0)
