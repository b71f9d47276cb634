"""xLSTM blocks (arXiv:2405.04517), the counterpart of `repro.models.xlstm`:
mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar memory, a
sequential scan), with exponential gating and log-space stabilisation.

The JAX package computes both in plain `jnp` (no Pallas kernel), and so
does the port, in plain PyTorch with JAX's casts: the cells run in f32
whatever the model's dtype, and so does their decode state (mLSTM ``C``
(B, NH, DH, DH), ``n`` (B, NH, DH), ``m`` (B, NH) and ``conv``
(B, K - 1, di); sLSTM ``c``, ``n``, ``h`` and ``m``, each (B, NH, DH)).
The mLSTM chunk loop and the sLSTM step loop are Python loops where JAX
runs `lax.scan`.  `mlstm_block` hands decode its conv tail left-padded to
K - 1 rows, as `ssm.mamba2_mixer` does (the departure stated there).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _param, dense_init, init_norm, rms_norm
from .ssm import _causal_conv, conv_step, conv_tail

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel
# ---------------------------------------------------------------------------


def mlstm_chunkwise(q, k, v, logi, logf, *, chunk: int, state=None):
    """q, k, v (B, S, NH, DH); logi / logf (B, S, NH) log input / forget
    gates.  Returns h (B, S, NH, DH) in q's dtype and the final state
    ``{"C" (B, NH, DH, DH), "n" (B, NH, DH), "m" (B, NH)}`` in f32 (the
    stored C and n carry the implicit scale exp(m))."""
    B, S, NH, DH = q.shape
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG)
        logf = F.pad(logf, (0, 0, 0, pad))

    f32 = torch.float32
    qf = (q.to(f32) / math.sqrt(DH)).reshape(B, nc, L, NH, DH)
    kf = k.to(f32).reshape(B, nc, L, NH, DH)
    vf = v.to(f32).reshape(B, nc, L, NH, DH)
    li = logi.to(f32).reshape(B, nc, L, NH)
    lf = logf.to(f32).reshape(B, nc, L, NH)
    b = torch.cumsum(lf, dim=2)  # inclusive

    if state is None:
        C = torch.zeros((B, NH, DH, DH), dtype=f32, device=q.device)
        n = torch.zeros((B, NH, DH), dtype=f32, device=q.device)
        m = torch.full((B, NH), NEG, dtype=f32, device=q.device)
    else:
        C, n, m = (state[name].to(f32) for name in ("C", "n", "m"))

    # intra-chunk log weights D_ij = b_i - b_j + logi_j (j <= i), masked
    # before any exp
    above = ~torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = b[:, :, :, None, :] - b[:, :, None, :, :] + li[:, :, None, :, :]  # (B, nc, i, j, NH)
    D.masked_fill_(above[None, None, :, :, None], NEG)

    hs = []
    for c in range(nc):
        qc, kc, vc, Dc, bc, lic = qf[:, c], kf[:, c], vf[:, c], D[:, c], b[:, c], li[:, c]
        g = bc + m[:, None, :]  # (B, L, NH) inter log-scale
        m_i = torch.maximum(Dc.amax(dim=2), g)  # (B, i, NH), the max over j
        w_intra = torch.exp(Dc - m_i[:, :, None, :])  # (B, i, j, NH)
        w_inter = torch.exp(g - m_i)  # (B, i, NH)
        wqk = w_intra * torch.einsum("bihd,bjhd->bijh", qc, kc)
        num = torch.einsum("bijh,bjhd->bihd", wqk, vc)
        # inter: the true C0 applied to q (q contracts C's key index, as mlstm_step)
        num = num + w_inter[..., None] * torch.einsum("bhde,bihe->bihd", C, qc)
        den = wqk.sum(dim=2) + w_inter * torch.einsum("bihd,bhd->bih", qc, n)
        den = torch.maximum(torch.abs(den), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        bL = bc[:, -1, :]  # (B, NH)
        dj = bL[:, None, :] - bc + lic  # (B, j, NH)
        m_new = torch.maximum(bL + m, dj.amax(dim=1))
        scale_old = torch.exp(bL + m - m_new)
        wj = torch.exp(dj - m_new[:, None, :])  # (B, j, NH)
        C = scale_old[:, :, None, None] * C + torch.einsum("bjhd,bjhe->bhde", wj[..., None] * vc, kc)
        n = scale_old[:, :, None] * n + torch.einsum("bjh,bjhd->bhd", wj, kc)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, nc * L, NH, DH)[:, :S]
    return h.to(q.dtype), {"C": C, "n": n, "m": m}


def mlstm_step(q, k, v, logi, logf, state):
    """Single-token recurrence.  q, k, v (B, NH, DH); logi / logf (B, NH)."""
    f32 = torch.float32
    DH = q.shape[-1]
    qf = q.to(f32) / math.sqrt(DH)
    kf, vf = k.to(f32), v.to(f32)
    C, n, m = (state[name].to(f32) for name in ("C", "n", "m"))
    li, lf = logi.to(f32), logf.to(f32)
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    C_new = fs[..., None, None] * C + is_[..., None, None] * (vf[..., :, None] * kf[..., None, :])
    n_new = fs[..., None] * n + is_[..., None] * kf
    num = torch.einsum("bhde,bhe->bhd", C_new, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_new, qf)), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return h, {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# mLSTM block (up-projection, causal conv, qkv, gates, output gate, down-projection)
# ---------------------------------------------------------------------------


def init_mlstm_block(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    xl = cfg.xlstm
    d, di, NH = cfg.d_model, xl.d_inner_m, xl.n_heads
    init = dict(dtype=cfg.param_dtype, device=device, generator=generator)
    f32 = dict(dtype=torch.float32, device=device)
    return nn.ParameterDict(
        {
            "w_up": dense_init((d, 2 * di), **init),
            "conv_w": dense_init((xl.d_conv, di), **init, scale=1.0 / math.sqrt(xl.d_conv)),
            "conv_b": _param(torch.zeros(di, **f32)),
            "w_q": dense_init((di, di), **init),
            "w_k": dense_init((di, di), **init),
            "w_v": dense_init((di, di), **init),
            "w_if": dense_init(
                (di, 2 * NH), dtype=torch.float32, device=device, generator=generator, scale=0.02
            ),
            "b_i": _param(torch.full((NH,), -10.0, **f32)),  # the paper's negative init
            "b_f": _param(torch.linspace(3.0, 6.0, NH, **f32)),
            "norm": init_norm(di, device=device),
            "w_down": dense_init((di, d), **init, scale=1.0 / math.sqrt(di * 2 * cfg.n_layers)),
        }
    )


def _mlstm_qkv_gates(p, xc, xraw, NH: int, DH: int):
    """xc: the conv'd branch (B, *, di); xraw: the branch before the conv, for v."""
    q = (xc @ p["w_q"]).reshape(*xc.shape[:-1], NH, DH)
    k = (xc @ p["w_k"]).reshape(*xc.shape[:-1], NH, DH)
    v = (xraw @ p["w_v"]).reshape(*xraw.shape[:-1], NH, DH)
    gi, gf = torch.chunk(xc.to(torch.float32) @ p["w_if"], 2, dim=-1)
    return q, k, v, gi + p["b_i"], F.logsigmoid(gf + p["b_f"])


def mlstm_block(p, x: torch.Tensor, cfg, *, state=None):
    """x (B, S, D) -> (y (B, S, D), final state ``{"C", "n", "m", "conv"}``):
    the full-sequence (chunkwise) path."""
    xl = cfg.xlstm
    B, S, _ = x.shape
    NH, DH = xl.n_heads, xl.d_inner_m // xl.n_heads
    xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    tail = conv_tail(xm, xl.d_conv)
    xc = _causal_conv(xm, p["conv_w"], p["conv_b"]).to(x.dtype)
    q, k, v, logi, logf = _mlstm_qkv_gates(p, xc, xm, NH, DH)
    h, fin = mlstm_chunkwise(q, k, v, logi, logf, chunk=xl.chunk, state=state)
    fin["conv"] = tail
    h = rms_norm(h.reshape(B, S, xl.d_inner_m), p["norm"]["scale"], eps=cfg.norm_eps)
    h = h * F.silu(z.to(torch.float32)).to(h.dtype)
    return h @ p["w_down"], fin


def init_mlstm_state(cfg, batch: int, *, device=None) -> dict:
    xl = cfg.xlstm
    NH, DH = xl.n_heads, xl.d_inner_m // xl.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, NH, DH, DH), **f32),
        "n": torch.zeros((batch, NH, DH), **f32),
        "m": torch.full((batch, NH), NEG, **f32),
        "conv": torch.zeros((batch, xl.d_conv - 1, xl.d_inner_m), **f32),
    }


def mlstm_block_decode(p, x: torch.Tensor, cfg, *, state: dict):
    """Single-token decode: x (B, 1, D) -> (y (B, 1, D), the new state)."""
    xl = cfg.xlstm
    B = x.shape[0]
    NH, DH = xl.n_heads, xl.d_inner_m // xl.n_heads
    xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)  # (B, 1, di) each
    window = torch.cat([state["conv"].to(xm.dtype), xm], dim=1)
    xc = conv_step(window, p["conv_w"], p["conv_b"]).to(x.dtype)
    q, k, v, logi, logf = _mlstm_qkv_gates(p, xc[:, 0], xm[:, 0], NH, DH)
    h, new = mlstm_step(q, k, v, logi, logf, state)
    h = rms_norm(h.reshape(B, 1, xl.d_inner_m), p["norm"]["scale"], eps=cfg.norm_eps)
    h = h * F.silu(z.to(torch.float32)).to(h.dtype)
    new["conv"] = window[:, 1:, :].to(state["conv"].dtype)
    return h @ p["w_down"], new


# ---------------------------------------------------------------------------
# sLSTM block (a sequential scan; block-diagonal recurrent weights per head)
# ---------------------------------------------------------------------------


def init_slstm_block(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    """As JAX's: ``ffn.w_gate`` and ``ffn.w_up`` are two parameters that hold
    one draw (JAX draws both from one key)."""
    xl = cfg.xlstm
    d, NH = cfg.d_model, xl.n_heads
    DH = d // NH
    init = dict(dtype=cfg.param_dtype, device=device, generator=generator)
    f32 = dict(dtype=torch.float32, device=device)
    f_up = int(d * 4 / 3)
    b_f = torch.linspace(3.0, 6.0, NH, **f32)[:, None].expand(NH, DH).reshape(-1)
    w_gate = dense_init((d, f_up), **init)
    return nn.ParameterDict(
        {
            "w_gates": dense_init((d, 4 * d), **init),  # z, i, f, o pre-activations
            "r_gates": dense_init(
                (4, NH, DH, DH), dtype=torch.float32, device=device, generator=generator,
                scale=1.0 / math.sqrt(DH),
            ),
            "b_gates": _param(torch.cat([torch.zeros(2 * d, **f32), b_f, torch.zeros(d, **f32)])),
            "norm": init_norm(d, device=device),
            "ffn": nn.ParameterDict(
                {
                    "w_gate": w_gate,
                    "w_up": _param(w_gate.detach().clone()),
                    "w_down": dense_init((f_up, d), **init),
                }
            ),
        }
    )


def init_slstm_state(cfg, batch: int, *, device=None) -> dict:
    NH = cfg.xlstm.n_heads
    shape = (batch, NH, cfg.d_model // NH)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros(shape, **f32),
        "n": torch.full(shape, 1e-6, **f32),
        "h": torch.zeros(shape, **f32),
        "m": torch.full(shape, -10.0, **f32),
    }


def slstm_scan(p, x: torch.Tensor, cfg, *, state=None):
    """x (B, S, D), sequential over S -> (h (B, S, D) in x's dtype, the final
    state).  The bias is added in x's dtype before the f32 cast, as JAX's."""
    xl = cfg.xlstm
    B, S, D = x.shape
    NH, DH = xl.n_heads, D // xl.n_heads
    wx = (x @ p["w_gates"] + p["b_gates"].to(x.dtype)).to(torch.float32)
    wx = wx.reshape(B, S, 4, NH, DH)
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    R = p["r_gates"]
    c, n, h, m = (state[name] for name in ("c", "n", "h", "m"))
    hs = []
    for t in range(S):
        pre = wx[:, t] + torch.einsum("bhd,ghde->bghe", h, R)  # (B, 4, NH, DH)
        zt, it, ft, ot = pre.unbind(dim=1)
        m_new = torch.maximum(ft + m, it)
        fs = torch.exp(ft + m - m_new)
        is_ = torch.exp(it - m_new)
        c = fs * c + is_ * torch.tanh(zt)
        n = fs * n + is_
        h = torch.sigmoid(ot) * c / n.clamp_min(1e-6)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_block(p, x: torch.Tensor, cfg, *, state=None):
    h, fin = slstm_scan(p, x, cfg, state=state)
    h = rms_norm(h, p["norm"]["scale"], eps=cfg.norm_eps)
    f = p["ffn"]
    y = F.silu(h @ f["w_gate"]) * (h @ f["w_up"])
    return y @ f["w_down"], fin


def slstm_block_decode(p, x: torch.Tensor, cfg, *, state: dict):
    return slstm_block(p, x, cfg, state=state)
