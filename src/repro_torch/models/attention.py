"""Attention (the counterpart of `repro.models.attention`): the dense path,
the routing to the flash kernel, and the GQA block (projections + rope +
attention, prefill and decode).

Layout: q (B, S, Hq, hd), k / v (B, T, G, hd).  Masks come from absolute
positions, as in JAX, so ring-buffer decode caches stay correct.

`attention` routes self-attention with one KV head per query head, no
window, soft cap, `kv_valid` or custom scale, and positions ``None``
(``arange`` from 0) to `kernels.attention.flash_attention`: the card's
kernel, at any length, or its plain version on a CPU tensor.  This is the
JAX package's TPU deployment route (its Pallas kernel); the JAX LM itself
runs `dense_attention` there.  The two compute the same function; the
kernel keeps the probabilities in f32 where `dense_attention` rounds them
to v's dtype before p.v.  Everything else runs `dense_attention`, as JAX
does up to 8192 KV positions; `blockwise_attention` above that, MLA and
cross-attention wait (ROADMAP Queue 2 item 8).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels import attention as kattn
from .layers import apply_rope, dense_init

NEG_INF = -1e30
BLOCKWISE_THRESHOLD = 8192  # KV positions above which JAX goes blockwise


def _mask_bias(
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    kv_valid: torch.Tensor | None,
) -> torch.Tensor:
    """(..., Sq, Tk) additive f32 bias from absolute positions.

    q_pos: (Sq,) or (B, Sq); kv_pos: (Tk,) or (B, Tk).  kv_valid: optional
    (Tk,) / (B, Tk) bool; False lanes are masked (ring buffers not yet full).
    """
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = kp < 2**29  # padded / invalid slots carry position >= 2**30
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if kv_valid is not None:
        ok = ok & kv_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _soft_cap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(b, t, h * n_rep, d)


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_pos: torch.Tensor | None = None,
    kv_pos: torch.Tensor | None = None,
    window: int | None = None,
    kv_valid: torch.Tensor | None = None,
    soft_cap: float | None = None,
    scale: float | None = None,
    grouped: bool = False,
) -> torch.Tensor:
    """Plain attention: f32 scores and softmax, probabilities rounded to v's
    dtype before p.v.  `grouped=True` keeps KV un-repeated and reshapes q
    into (G, R) head groups (decode)."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q_pos is None:
        q_pos = torch.arange(S, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(T, device=q.device)
    bias = _mask_bias(q_pos, kv_pos, causal=causal, window=window, kv_valid=kv_valid)
    # bias broadcast: (S, T) -> (1, 1, S, T); (B, S, T) -> (B, 1, S, T)
    bias = bias[None, None] if bias.ndim == 2 else bias[:, None]
    if grouped:
        R = Hq // G
        qg = q.reshape(B, S, G, R, hd)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float()) * sc
        scores = _soft_cap(scores, soft_cap) + bias[:, :, None]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype), v)
        return out.reshape(B, S, Hq, hd)
    kr, vr = _repeat_kv(k, Hq // G), _repeat_kv(v, Hq // G)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kr.float()) * sc
    scores = _soft_cap(scores, soft_cap) + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(vr.dtype), vr)


def attention(
    q,
    k,
    v,
    *,
    causal=True,
    q_pos=None,
    kv_pos=None,
    window=None,
    kv_valid=None,
    soft_cap=None,
    scale=None,
    mode: str | None = None,
):
    """Route to the flash kernel or to `dense_attention` (module docstring).
    `mode` reaches the kernel's wrapper only: ``"ref"`` runs its plain
    version on the card too."""
    if (
        q.shape[2] == k.shape[2]
        and q_pos is None
        and kv_pos is None
        and window is None
        and kv_valid is None
        and soft_cap is None
        and scale is None
    ):
        return kattn.flash_attention(q, k, v, causal=causal, mode=mode)
    if k.shape[1] > BLOCKWISE_THRESHOLD and kv_valid is None:
        raise NotImplementedError(
            f"attention over {k.shape[1]} KV positions needs blockwise_attention, not ported "
            "yet (ROADMAP Queue 2 item 8, step 3)"
        )
    return dense_attention(
        q,
        k,
        v,
        causal=causal,
        q_pos=q_pos,
        kv_pos=kv_pos,
        window=window,
        kv_valid=kv_valid,
        soft_cap=soft_cap,
        scale=scale,
    )


# ---------------------------------------------------------------------------
# Standard GQA attention block (projections + rope + attention)
# ---------------------------------------------------------------------------


def init_gqa(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    d, hq, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    init = dict(dtype=cfg.param_dtype, device=device, generator=generator)
    p = {
        "w_q": dense_init((d, hq * hd), **init),
        "w_k": dense_init((d, g * hd), **init),
        "w_v": dense_init((d, g * hd), **init),
        "w_o": dense_init((hq * hd, d), **init, scale=1.0 / math.sqrt(hq * hd * 2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", hq * hd), ("b_k", g * hd), ("b_v", g * hd)):
            p[name] = nn.Parameter(
                torch.zeros(n, dtype=torch.float32, device=device), requires_grad=False
            )
    return nn.ParameterDict(p)


def gqa_project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, Hq, hd), k / v (B, S, G, hd) with RoPE applied."""
    B, S, _ = x.shape
    hq, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(w, b):
        y = x @ p[w]
        return y + p[b] if b in p else y

    q = proj("w_q", "b_q").reshape(B, S, hq, hd).to(x.dtype)
    k = proj("w_k", "b_k").reshape(B, S, g, hd).to(x.dtype)
    v = proj("w_v", "b_v").reshape(B, S, g, hd).to(x.dtype)
    if cfg.rope_theta:
        q = apply_rope(q, positions, theta=cfg.rope_theta, rotary_dim=cfg.rotary_dim)
        k = apply_rope(k, positions, theta=cfg.rope_theta, rotary_dim=cfg.rotary_dim)
    return q, k, v


def gqa_attn(p, x: torch.Tensor, cfg, *, positions=None, mode: str | None = None):
    """Full-sequence self-attention (prefill).  positions None means
    ``arange(S)`` from 0, the case `attention` may route to the kernel.
    Returns (out, (k, v))."""
    q_pos = positions
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = attention(
        q,
        k,
        v,
        causal=cfg.causal,
        q_pos=q_pos,
        kv_pos=q_pos,
        window=cfg.window,
        soft_cap=cfg.attn_soft_cap,
        scale=cfg.attn_scale,
        mode=mode,
    )
    return out.reshape(*x.shape[:2], -1) @ p["w_o"], (k, v)


def gqa_decode(p, x: torch.Tensor, cfg, *, cache_k, cache_v, pos: int, kv_pos, kv_valid):
    """Single-token decode against a (possibly ring-buffer) KV cache.

    cache_k / cache_v: (B, T, G, hd), written in place at slot ``pos % T``
    (JAX returns updated copies; in place saves copying the whole cache of
    every layer at every step).  pos: absolute position of the new token;
    kv_pos: (T,) absolute position held by each slot after the write;
    kv_valid: (T,) bool.  Returns (out, (cache_k, cache_v)).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    out = dense_attention(
        q,
        cache_k,
        cache_v,
        causal=True,
        q_pos=positions,
        kv_pos=kv_pos,
        window=cfg.window,
        kv_valid=kv_valid,
        soft_cap=cfg.attn_soft_cap,
        scale=cfg.attn_scale,
        grouped=True,
    )
    return out.reshape(B, 1, -1) @ p["w_o"], (cache_k, cache_v)
