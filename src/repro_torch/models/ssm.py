"""Selective SSM (Mamba) block.

Prefill materialises the discretised (B, c, di, N) terms one chunk at a
time and carries the (B, di, N) hidden state across chunks, so the peak
stays at one chunk; inside a chunk the first-order recurrence runs step
by step (the reference uses an associative scan: the same recurrence, a
different f32 summation order, which the tests bound).  Decode is the
O(1) single-step recurrence with a rolling conv cache.

The reference mixes f32 and bf16 operands and lets its type promotion
pick f32; torch refuses mixed operands, so the port up-casts explicitly
where the reference promotes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import silu

__all__ = ["mamba_mix"]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, T, di); w: (di, k); b: (di,).

    cache: (B, k-1, di) trailing context from the previous segment
    (decode); returns (y, new_cache).  ``y`` is f32 when ``b`` is.
    """
    B, T, di = x.shape
    k = w.shape[1]
    if cache is None:
        cache = torch.zeros((B, k - 1, di), dtype=x.dtype, device=x.device)
    xx = torch.cat([cache.to(x.dtype), x], dim=1)  # (B, T+k-1, di)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xx[:, i:i + T, :] * w[None, None, :, i]
    new_cache = xx[:, T:, :] if k > 1 else cache
    return y.to(torch.promote_types(y.dtype, b.dtype)) + b[None, None, :], new_cache


def mamba_mix(p: dict, x: torch.Tensor, state: dict | None = None,
              chunk: int = 256) -> tuple[torch.Tensor, dict]:
    """x: (B, T, d) -> (B, T, d).  state carries {h, conv} for decode.

    p: in_proj (d, 2di), conv_w (di, k), conv_b (di,), x_proj (di, r+2N),
       dt_proj (r, di), dt_bias (di,), A_log (di, N), D (di,),
       out_proj (di, d).
    """
    B, T, d = x.shape
    di, N = p["A_log"].shape
    r = p["dt_proj"].shape[0]

    xz = x @ p["in_proj"]
    x1, z = xz.chunk(2, dim=-1)  # (B, T, di)

    conv_cache = None if state is None else state["conv"]
    x1, new_conv = _causal_conv(x1, p["conv_w"], p["conv_b"], conv_cache)
    x1 = silu(x1)

    wide = torch.promote_types(x1.dtype, p["x_proj"].dtype)
    xdbc = x1.to(wide) @ p["x_proj"].to(wide)
    dt_r, B_, C_ = torch.split(xdbc, [r, N, N], dim=-1)
    wide = torch.promote_types(dt_r.dtype, p["dt_proj"].dtype)
    dt = F.softplus(dt_r.to(wide) @ p["dt_proj"].to(wide) + p["dt_bias"]).float()  # (B, T, di)
    A = -torch.exp(p["A_log"].float())  # (di, N)

    if state is None or "h" not in state:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    else:
        h0 = state["h"].float()

    Bf, Cf, xf1 = B_.float(), C_.float(), x1.float()
    if T == 1:  # decode fast path
        dA = torch.exp(dt[:, 0, :, None] * A[None])  # (B, di, N)
        dBx = dt[:, 0, :, None] * Bf[:, 0, None, :] * xf1[:, 0, :, None]
        h = dA * h0 + dBx
        y = torch.einsum("bdn,bn->bd", h, Cf[:, 0])[:, None]
        h_last = h
    else:
        chunk = min(chunk, T)
        if T % chunk:
            raise ValueError(f"prefill length {T} is not a multiple of ssm_chunk {chunk}")
        h_last = h0
        ys = []
        for c0 in range(0, T, chunk):
            sl = slice(c0, c0 + chunk)
            dt_c = dt[:, sl]
            dA = torch.exp(dt_c[..., None] * A[None, None])  # (B, c, di, N)
            dBx = dt_c[..., None] * Bf[:, sl, None, :] * xf1[:, sl, :, None]
            hs = []
            for t in range(chunk):
                h_last = dA[:, t] * h_last + dBx[:, t]
                hs.append(h_last)
            h_all = torch.stack(hs, dim=1)  # (B, c, di, N)
            ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cf[:, sl]))
        y = torch.cat(ys, dim=1)

    y = y + xf1 * p["D"].float()[None, None]
    out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]
    return out, {"h": h_last, "conv": new_conv}
