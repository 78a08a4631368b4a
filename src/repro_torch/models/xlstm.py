"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory, strictly sequential recurrence).

Both use stabilised exponential gating (the m-state max trick) and run as
a time loop carrying their state, for prefill and decode alike: the
reference's time scan, step by step.  Operand dtypes follow the
reference's type promotion, made explicit (torch refuses mixed operands).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import silu

__all__ = ["mlstm_mix", "slstm_mix"]


def mlstm_mix(p: dict, x: torch.Tensor, state: dict | None = None,
              n_heads: int = 4) -> tuple[torch.Tensor, dict]:
    """mLSTM block.  x: (B, T, d).

    p: w_up (d, 2di), wq_l/wk_l/wv_l (di, di), wi/wf (di, H), w_down (di, d).
    state: {C: (B,H,dh,dh), n: (B,H,dh), m: (B,H)}.
    """
    B, T, d = x.shape
    di = p["wq_l"].shape[0]
    H = n_heads
    dh = di // H

    xz = x @ p["w_up"]
    xi, z = xz.chunk(2, dim=-1)  # (B, T, di)

    def heads(w):
        return (xi @ w).reshape(B, T, H, dh)

    q, k, v = heads(p["wq_l"]), heads(p["wk_l"]), heads(p["wv_l"])
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(k.dtype)
    xi32 = xi.float()
    ig = xi32 @ p["wi"].float()  # log-space input gate
    fg = F.logsigmoid(xi32 @ p["wf"].float())

    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        m = torch.full((B, H), -math.inf, dtype=torch.float32, device=x.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]

    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for t in range(T):
        qt, kt, vt, it, ft = qf[:, t], kf[:, t], vf[:, t], ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)
        fs = torch.exp(ft + torch.where(torch.isfinite(m), m, -math.inf) - m_new)
        is_ = torch.exp(it - m_new)
        C = fs[..., None, None] * C + is_[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fs[..., None] * n + is_[..., None] * kt
        num = torch.einsum("bhde,bhd->bhe", C, qt)
        den = torch.einsum("bhd,bhd->bh", n, qt).abs().clamp_min(1.0)
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, T, di).to(x.dtype)
    out = (h * silu(z)) @ p["w_down"]
    return out, {"C": C, "n": n, "m": m}


def slstm_mix(p: dict, x: torch.Tensor, state: dict | None = None,
              n_heads: int = 4) -> tuple[torch.Tensor, dict]:
    """sLSTM block.  x: (B, T, d) with d == hidden width (post-LN residual).

    p: sw_i/sw_f/sw_z/sw_o (d, d), r_i/r_f/r_z/r_o (H, dh, dh),
       b_i/b_f (d,).  state: {h, c, n, m} each (B, H, dh).
    """
    B, T, d = x.shape
    H = n_heads
    dh = d // H

    x32 = x.float()
    wx_i = x32 @ p["sw_i"].float() + p["b_i"]
    wx_f = x32 @ p["sw_f"].float() + p["b_f"]
    wx_z = x32 @ p["sw_z"].float()
    wx_o = x32 @ p["sw_o"].float()

    if state is None:
        h = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        n = torch.ones((B, H, dh), dtype=torch.float32, device=x.device)
        m = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    else:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]

    r_i, r_f, r_z, r_o = (p[name].float() for name in ("r_i", "r_f", "r_z", "r_o"))

    def rec(hh, r):  # block-diagonal recurrent matmul
        return torch.einsum("bhd,hde->bhe", hh, r)

    hs = []
    for t in range(T):
        it = wx_i[:, t].reshape(B, H, dh) + rec(h, r_i)
        ft = wx_f[:, t].reshape(B, H, dh) + rec(h, r_f)
        zt = torch.tanh(wx_z[:, t].reshape(B, H, dh) + rec(h, r_z))
        ot = torch.sigmoid(wx_o[:, t].reshape(B, H, dh) + rec(h, r_o))
        lf = F.logsigmoid(ft)  # forget in log space (sigmoid variant)
        m_new = torch.maximum(lf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = f_ * c + i_ * zt
        n = f_ * n + i_
        h = ot * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    return out, {"h": h, "c": c, "n": n, "m": m}
