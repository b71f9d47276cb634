"""Attention (the counterpart of `repro.models.attention`): the dense and
blockwise paths, the routing to the flash kernel, and the GQA block
(projections + rope + attention, prefill and decode).

Layout: q (B, S, Hq, hd), k / v (B, T, G, hd).  Masks come from absolute
positions, as in JAX, so ring-buffer decode caches stay correct.

`attention` decides its route from the arguments' shapes and settings
before anything runs (`kernel_route`), never by catching a failure.  It
sends a call to `kernels.attention.flash_attention` (the card's kernel, at
any length, or its plain version on a CPU tensor) when all of these hold:

  * ``q_pos``, ``kv_pos``, ``kv_valid``, ``soft_cap`` and ``scale`` are
    None (positions ``arange`` from 0, the default scale);
  * v has k's shape (the kernel reads one head dim for q, k and v);
  * ``Hq % G == 0`` (MHA, GQA or MQA: the kernel maps query heads to KV
    heads);
  * the head dim is a multiple of 8 in [8, 256];
  * there is no window, or the query positions (``q_off`` .. ``q_off + S
    - 1``) and T are all below the window: with positions from 0 every
    pair then lies inside it (``kp > qp - window`` holds for all), so the
    window masks nothing.

``q_off`` places the S query rows at positions ``q_off`` .. ``q_off + S -
1`` of a longer sequence (the keys at 0 .. T - 1): a rank's slice of the
queries under the sequence-parallel layout.  The kernel takes it as its
query offset; off the kernel route it becomes ``q_pos``.

This is the JAX package's TPU deployment route (its Pallas kernel); the JAX
LM itself runs `dense_attention` there.  The two compute the same function;
the kernel keeps the probabilities in f32 where `dense_attention` rounds
them to v's dtype before p.v.  Every other call goes, as in JAX's
`attention`, to `blockwise_attention` when T > 8192 and no ``kv_valid`` is
given, and to `dense_attention` otherwise.  E.g. reduced starcoder2-7b (head
dim 12) runs dense, and an h2o-danube-3-4b prompt longer than its 4096
window runs dense up to 8192 positions and blockwise above.

MLA (DeepSeek-V2/V3, `mla_attn`) has q and k of ``qk_nope + qk_rope``
channels (192) and v of ``v_dim`` (128).  On the kernel route it pads v
with zero channels to q's head dim and keeps the output's first ``v_dim``
(zero channels of v give zero outputs, so the function is unchanged; the
16-bit kernel pads 192 channels to four 64-channel chunks either way).  Off
the route it runs `dense_attention` / `blockwise_attention` unpadded, as in
JAX.  Decode (`mla_decode`) attends in the latent space over the (c_kv,
k_rope) cache, in f32, as JAX's does.

Cross-attention (`cross_attn`: Llama-3.2-Vision's gated layers, the
encoder-decoder's) attends over a context's K and V (`cross_kv`, no RoPE).
JAX calls `dense_attention` there with ``causal=False`` and every position
0, which masks nothing; the port calls `attention` with ``causal=False``
and no positions, the same function, so that it takes the kernel route:
in the prefill (S query rows over the T context rows) and in decode (S =
1, against the context's K / V of the cache).

Decode on a mesh (`sharding.rules.decode_layout`) reads the rank's slots
of the cache where `rules.cache_specs` splits its time axis over "model"
(split-K): the self-attention and MLA's latent attention stay plain
(`dense_attention`, as JAX's), their softmax's row max and denominator
merged over the axis before the probabilities (`softmax_over`) and the
p.v partials summed after; the cross-attention takes the kernel on the
rank's context rows with its log-sum-exp and merges the normalised
outputs by those weights (`merge_lse`).  Under "tp" the rank projects its
heads, the new token's heads are gathered over the axis (the cache holds
every head, as JAX's), every head attends over the rank's slots, and the
rank's heads go into the row-parallel ``w_o``, summed over the axis.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels import attention as kattn
from ..sharding import comm
from .layers import _param, apply_rope, dense_init, rms_norm, tp_rows, tp_sum

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


def softmax_over(scores: torch.Tensor, merge=None) -> torch.Tensor:
    """The softmax along the last axis of `scores`; with `merge`
    (`sharding.comm.Over`) that axis is split over its ranks (a rank's
    slots of the cache): the row max and the denominator are merged before
    the probabilities, so each rank's are the whole softmax's.  A rank
    whose slots are all masked (scores -1e30) gets exp(-1e30 - max) = 0."""
    if merge is None:
        return torch.softmax(scores, dim=-1)
    e = torch.exp(scores - merge.max(torch.amax(scores, dim=-1, keepdim=True)))
    return e / merge.sum(torch.sum(e, dim=-1, keepdim=True))


def merge_lse(out: torch.Tensor, lse: torch.Tensor, merge) -> torch.Tensor:
    """The attention output over the keys of all ranks of `merge` from each
    rank's over its slice: `out` (B, S, H, hd) normalised over the slice,
    `lse` (B, H, S) its log-sum-exp (`kernels.attention.flash_attention`'s).
    Each slice is weighted by exp(lse - max) over the weights' sum, in f32
    (a slice that sees no key, lse -1e30, weighs exactly 0), and the sum is
    rounded once to out's dtype."""
    w = torch.exp(lse - merge.max(lse))
    w = (w / merge.sum(w)).transpose(-1, -2)[..., None]  # (B, S, H, 1)
    return merge.sum(out.float() * w).to(out.dtype)


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
    merge=None,
) -> torch.Tensor:
    """Plain attention: f32 scores and softmax, probabilities rounded to v's
    dtype before p.v.  `grouped=True` keeps KV un-repeated and reshapes q
    into (G, R) head groups (decode).  With `merge` (`sharding.comm.Over`)
    k and v are this rank's slice of the keys (split-K): the softmax is
    merged over the ranks (`softmax_over`) and the p.v partials, in f32,
    summed over them and rounded once to v's dtype; soft cap and mask act
    on each score as without."""
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
        probs = softmax_over(scores, merge).to(v.dtype)
        out = _pv("bgrst,btgd->bsgrd", probs, v, merge)
        return out.reshape(B, S, Hq, hd)
    kr, vr = _repeat_kv(k, Hq // G), _repeat_kv(v, Hq // G)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kr.float()) * sc
    scores = _soft_cap(scores, soft_cap) + bias
    return _pv("bhst,bthd->bshd", softmax_over(scores, merge).to(vr.dtype), vr, merge)


def _pv(eq: str, probs: torch.Tensor, v: torch.Tensor, merge) -> torch.Tensor:
    """p.v; with `merge`, the rank's partial in f32 summed over its ranks."""
    if merge is None:
        return torch.einsum(eq, probs, v)
    return merge.sum(torch.einsum(eq, probs.float(), v.float())).to(v.dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_pos: torch.Tensor | None = None,
    kv_pos: torch.Tensor | None = None,
    window: int | None = None,
    soft_cap: float | None = None,
    scale: float | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of `chunk` positions: JAX's
    `blockwise_attention` (a `lax.scan` there, a loop here), with peak score
    memory O(B * Hq * S * chunk).  Query heads stay in their (G, R) groups
    against un-repeated KV.  As JAX's: the tail is padded with zeros at
    position 2**30 (masked by the ``kp < 2**29`` rule); scores and p.v
    accumulate in f32 (JAX's ``preferred_element_type``: the products are
    computed in f32 here, not in the inputs' 16-bit type); p is rounded to
    v's dtype before p.v; rows masked so far keep m at -1e30 and add 0; the
    output is ``acc / max(l, 1e-30)`` in q's dtype."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    R = Hq // G
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q_pos is None:
        q_pos = torch.arange(S, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(T, device=q.device)
    if kv_pos.ndim == 2 and kv_pos.shape[0] == 1:
        kv_pos = kv_pos[0]  # JAX reshapes kv_pos to (chunks, chunk): one row for the batch
    if kv_pos.ndim != 1:
        raise ValueError(f"blockwise_attention: kv_pos {tuple(kv_pos.shape)} is not one row")
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=2**30)
    qq = q.reshape(B, S, G, R, hd).float()
    acc = torch.zeros((B, S, G, R, hdv), dtype=torch.float32, device=q.device)
    mx = torch.full((B, S, G, R), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(mx)  # noqa: E741
    for c0 in range(0, n_chunks * chunk, chunk):
        kb, vb = k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk]
        bias = _mask_bias(
            q_pos, kv_pos[c0 : c0 + chunk], causal=causal, window=window, kv_valid=None
        )
        # bias (S, C) -> (1, S, 1, 1, C); (B, S, C) -> (B, S, 1, 1, C)
        bb = bias[None, :, None, None, :] if bias.ndim == 2 else bias[:, :, None, None, :]
        s = torch.einsum("bsgrd,bcgd->bsgrc", qq, kb.float()) * sc
        s = _soft_cap(s, soft_cap) + bb
        m_new = torch.maximum(mx, torch.amax(s, dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(mx <= NEG_INF / 2, NEG_INF, mx) - m_safe)
        corr = torch.where(mx <= NEG_INF / 2, 0.0, corr)
        o = torch.einsum("bsgrc,bcgd->bsgrd", p.to(v.dtype).float(), vb.float())
        acc = acc * corr[..., None] + o
        l = l * corr + torch.sum(p, dim=-1)  # noqa: E741
        mx = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, Hq, hdv).to(q.dtype)


def kernel_route(q, k, v, *, q_pos=None, kv_pos=None, window=None, kv_valid=None,
                 soft_cap=None, scale=None, q_off: int = 0) -> bool:
    """Whether `attention` sends this call to the flash kernel (module
    docstring): decided from shapes and settings alone (of v, its shape)."""
    S, Hq, hd = q.shape[1], q.shape[2], q.shape[3]
    T, G = k.shape[1], k.shape[2]
    return (
        v.shape == k.shape
        and q_pos is None
        and kv_pos is None
        and kv_valid is None
        and soft_cap is None
        and scale is None
        and G > 0
        and Hq % G == 0
        and hd % 8 == 0
        and 8 <= hd <= kattn.MAX_HEAD_DIM
        and (window is None or max(q_off + S, T) <= window)
    )


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
    chunk: int = 1024,
    mode: str | None = None,
    q_off: int = 0,
):
    """Route to the flash kernel, `blockwise_attention` (chunks of `chunk`
    KV positions) or `dense_attention` (module docstring).  `mode` reaches
    the kernel's wrapper only: ``"ref"`` runs its plain version on the card
    too.  `q_off` as in the module docstring (with ``q_pos`` and ``kv_pos``
    None)."""
    masks = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, soft_cap=soft_cap, scale=scale)
    if kernel_route(q, k, v, kv_valid=kv_valid, q_off=q_off, **masks):
        return kattn.flash_attention(q, k, v, causal=causal, mode=mode, q_off=q_off)
    if q_off:
        if q_pos is not None or kv_pos is not None:
            raise ValueError("attention: q_off with explicit positions")
        masks["q_pos"] = torch.arange(q_off, q_off + q.shape[1], device=q.device)
        masks["kv_pos"] = torch.arange(k.shape[1], device=q.device)
    if k.shape[1] > BLOCKWISE_THRESHOLD and kv_valid is None:
        return blockwise_attention(q, k, v, causal=causal, chunk=chunk, **masks)
    return dense_attention(
        q, k, v, causal=causal, kv_valid=kv_valid, grouped=q.shape[2] != k.shape[2], **masks
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


def local_heads(cfg, hint):
    """`cfg` as a rank of the tensor-parallel layout computes attention: its
    n_heads / m query and n_kv_heads / m KV heads; else `cfg`."""
    if getattr(hint, "layout", None) != "tp":
        return cfg
    m = hint.model_size
    return cfg.replace(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m)


def _slice_offset(x: torch.Tensor, hint) -> int:
    """The position of the first row of this rank's slice of the sequence."""
    return hint.model_rank * x.shape[1]


def gqa_attn(p, x: torch.Tensor, cfg, *, positions=None, mode: str | None = None, hint=None):
    """Full-sequence self-attention (prefill).  positions None means
    ``arange(S)`` from 0, the case `attention` may route to the kernel;
    above 8192 positions off that route it runs blockwise in chunks of
    ``cfg.blockwise_chunk``.  Returns (out, (k, v)).

    Under a model layout of `hint` (positions None), `x` is this rank's
    slice of the sequence and so is the output.  "tp": the sequence is
    gathered, `p` holds the rank's heads (q, k, v and ``w_o``'s rows:
    JAX's ``"heads_q"`` / ``"heads_kv"`` over "model"), the kernel runs on
    them, and ``w_o``'s partial sums are reduce-scattered to the slices; k
    and v are the rank's heads.  "sp": q, k and v are projected on the
    slice, k and v gathered over the sequence (JAX's ``"heads_q"`` over
    the sequence, ``"heads_kv"`` whole) and the kernel takes the slice's
    offset as its query offset; k and v are whole."""
    layout = getattr(hint, "layout", None)
    if layout == "tp":
        seq = hint.seq_group
        xf = comm.gather_dim(x, 1, seq)
        out, kv = gqa_attn(p, xf, local_heads(cfg, hint), mode=mode)
        return comm.scatter_dim(out, 1, seq), kv
    if layout == "sp":
        seq = hint.seq_group
        off = _slice_offset(x, hint)
        pos = torch.arange(off, off + x.shape[1], device=x.device)[None, :]
        q, k, v = gqa_project_qkv(p, x, cfg, pos)
        k, v = comm.gather_dim(k, 1, seq), comm.gather_dim(v, 1, seq)
        out = attention(q, k, v, causal=cfg.causal, window=cfg.window,
                        soft_cap=cfg.attn_soft_cap, scale=cfg.attn_scale,
                        chunk=cfg.blockwise_chunk, mode=mode, q_off=off)
        return out.reshape(*x.shape[:2], -1) @ p["w_o"], (k, v)
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
        chunk=cfg.blockwise_chunk,
        mode=mode,
    )
    return out.reshape(*x.shape[:2], -1) @ p["w_o"], (k, v)


def _write_slot(caches, new, pos: int, slots) -> None:
    """Write each new token's entry (B, 1, ...) into its cache (B, T, ...)
    at slot ``pos % T``; with `slots` (first, total) the cache holds the
    rank's slots first .. first + T - 1 of `total`, and only the rank that
    holds slot ``pos % total`` writes it."""
    T = caches[0].shape[1]
    slot = pos % (slots[1] if slots else T) - (slots[0] if slots else 0)
    if 0 <= slot < T:
        for c, t in zip(caches, new):
            c[:, slot] = t[:, 0].to(c.dtype)


def _merge(slots, hint):
    """The split-K merges of a cache whose time axis `slots` splits."""
    return None if slots is None else comm.Over(hint.seq_group)


def _own_heads(out: torch.Tensor, hint) -> torch.Tensor:
    """The rank's heads (the "tp" layout's) of every head's output
    (B, S, H * d)."""
    width = out.shape[-1] // hint.model_size
    return out.narrow(-1, hint.model_rank * width, width)


def gqa_decode(p, x: torch.Tensor, cfg, *, cache_k, cache_v, pos: int, kv_pos, kv_valid,
               slots=None, hint=None):
    """Single-token decode against a (possibly ring-buffer) KV cache.

    cache_k / cache_v: (B, T, G, hd), written in place at slot ``pos % T``
    (JAX returns updated copies; in place saves copying the whole cache of
    every layer at every step).  pos: absolute position of the new token;
    kv_pos: (T,) absolute position held by each slot after the write;
    kv_valid: (T,) bool.  Returns (out, (cache_k, cache_v)).

    On a mesh (module docstring): `slots` (first, total) when the cache
    holds the rank's T of `total` slots (the owner of slot ``pos % total``
    writes the token; the attention is merged over the model axis), None
    when it holds them all; under `hint`'s "tp" layout `p` holds the rank's
    heads.
    """
    B = x.shape[0]
    tp = getattr(hint, "layout", None) == "tp"
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project_qkv(p, x, local_heads(cfg, hint), positions)
    if tp:
        q, k, v = (comm.all_gather(t, 2, hint.seq_group) for t in (q, k, v))
    _write_slot((cache_k, cache_v), (k, v), pos, slots)
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
        merge=_merge(slots, hint),
    ).reshape(B, 1, -1)
    if tp:
        return tp_sum(_own_heads(out, hint) @ p["w_o"], hint), (cache_k, cache_v)
    return out @ p["w_o"], (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Cross-attention (VLM gated layers, encoder-decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(cfg, *, gated: bool, device=None, generator=None) -> nn.ParameterDict:
    """`init_gqa`'s projections and, when `gated`, the scalar f32
    ``gate_attn``, 0 at init as in JAX (so a gated layer starts as the
    identity)."""
    p = init_gqa(cfg, device=device, generator=generator)
    if gated:
        p["gate_attn"] = _param(torch.zeros((), dtype=torch.float32, device=device))
    return p


def cross_kv(p, ctx: torch.Tensor, cfg, *, hint=None):
    """Project the context (B, T, D) to K / V (B, T, G, hd) once (no RoPE);
    under the tensor-parallel layout of `hint` the rank's G / m heads."""
    B, T, _ = ctx.shape
    g, hd = local_heads(cfg, hint).n_kv_heads, cfg.head_dim

    def proj(w, b):
        y = ctx @ p[w]
        return (y + p[b] if b in p else y).to(ctx.dtype).reshape(B, T, g, hd)

    return proj("w_k", "b_k"), proj("w_v", "b_v")


def cross_attn(p, x: torch.Tensor, ctx_kv, cfg, *, mode: str | None = None, hint=None,
               split: bool = False):
    """x (B, S, D) attends over the context's (k, v) (B, T, G, hd), every
    pair unmasked (module docstring) -> (B, S, D), times ``tanh(gate_attn)``
    (in f32, cast to the output's dtype, as JAX's) when the layer is gated.
    `mode` reaches the attention kernel.  Under a model layout of `hint`
    `x` is the rank's slice of the sequence and so is the output: "tp" runs
    the rank's heads on the sequence gathered (`cross_kv`'s heads too) and
    reduce-scatters ``w_o``'s partial sums, the gate applied after; "sp"
    runs the slice's queries over the whole context.  In decode
    (``hint.decode``) `x` is the rows whole and (k, v) hold every head:
    `split` when they are the rank's slice of the context rows
    (`rules.cache_specs`), whose outputs are merged over the model axis
    (`merge_lse`); under "tp" the rank's query heads are gathered, every
    head attends, and the rank's heads go into ``w_o``, summed."""
    tp = getattr(hint, "layout", None) == "tp"
    decode = getattr(hint, "decode", False)
    if tp:
        x = tp_rows(x, hint)
    B, S, _ = x.shape
    hq = local_heads(cfg, hint).n_heads
    y = x @ p["w_q"]
    q = (y + p["b_q"] if "b_q" in p else y).to(x.dtype).reshape(B, S, hq, cfg.head_dim)
    if tp and decode:
        q = comm.all_gather(q, 2, hint.seq_group)
    k, v = ctx_kv
    if split:
        out = _cross_split(q, k, v, cfg, mode=mode, merge=comm.Over(hint.seq_group))
    else:
        out = attention(q, k, v, causal=False, scale=cfg.attn_scale, mode=mode)
    out = out.reshape(B, S, -1)
    if tp and decode:
        out = _own_heads(out, hint)
    out = out @ p["w_o"]
    if tp:
        out = tp_sum(out, hint)
    if "gate_attn" in p:
        out = torch.tanh(p["gate_attn"]).to(out.dtype) * out
    return out


def _cross_split(q, k, v, cfg, *, mode, merge):
    """`cross_attn`'s attention over a rank's slice of the context rows,
    merged over `merge`'s ranks: on the kernel route the kernel with its
    log-sum-exp on each slice (`merge_lse`), else `dense_attention`'s
    split-K form."""
    if kernel_route(q, k, v, scale=cfg.attn_scale):
        out, lse = kattn.flash_attention(q, k, v, causal=False, mode=mode, lse=True)
        return merge_lse(out, lse, merge)
    return dense_attention(q, k, v, causal=False, scale=cfg.attn_scale,
                           grouped=q.shape[2] != k.shape[2], merge=merge)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------


def init_mla(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    init = dict(dtype=cfg.param_dtype, device=device, generator=generator)
    qk_head = m.qk_nope_dim + m.qk_rope_dim

    def norm(n):
        return nn.ParameterDict(
            {"scale": _param(torch.ones(n, dtype=torch.float32, device=device))}
        )

    return nn.ParameterDict(
        {
            "w_dq": dense_init((d, m.q_lora_rank), **init),
            "q_norm": norm(m.q_lora_rank),
            "w_uq": dense_init((m.q_lora_rank, h * qk_head), **init),
            "w_dkv": dense_init((d, m.kv_lora_rank), **init),
            "kv_norm": norm(m.kv_lora_rank),
            "w_uk": dense_init((m.kv_lora_rank, h * m.qk_nope_dim), **init),
            "w_uv": dense_init((m.kv_lora_rank, h * m.v_dim), **init),
            "w_kr": dense_init((d, m.qk_rope_dim), **init),
            "w_o": dense_init(
                (h * m.v_dim, d), **init, scale=1.0 / math.sqrt(h * m.v_dim * 2 * cfg.n_layers)
            ),
        }
    )


def _mla_latents(p, x, cfg, positions):
    """Compressed latents: c_kv (B, T, r_kv), k_rope (B, T, 1, rope_dim)."""
    m = cfg.mla
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"]["scale"], eps=cfg.norm_eps)
    k_r = (x @ p["w_kr"]).reshape(*x.shape[:2], 1, m.qk_rope_dim)
    k_r = apply_rope(k_r, positions, theta=cfg.rope_theta)
    return c_kv, k_r


def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    cq = rms_norm(x @ p["w_dq"], p["q_norm"]["scale"], eps=cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(*x.shape[:2], cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    return q_nope, apply_rope(q_rope, positions, theta=cfg.rope_theta)


def mla_project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, S, D) -> q, k (B, S, H, qk_nope + qk_rope), v (B, S, H, v_dim),
    and the latents c_kv (B, S, r_kv), k_rope (B, S, rope_dim) the cache
    keeps."""
    c_kv, k_r = _mla_latents(p, x, cfg, positions)
    q = torch.cat(_mla_q(p, x, cfg, positions), dim=-1)
    k, v = _mla_expand(p, c_kv, k_r, cfg)
    return q, k, v, c_kv, k_r[:, :, 0, :]


def _mla_expand(p, c_kv: torch.Tensor, k_r: torch.Tensor, cfg):
    """The latents c_kv (B, T, r_kv), k_rope (B, T, 1, rope_dim) -> the
    heads' k (B, T, H, qk_nope + qk_rope) and v (B, T, H, v_dim)."""
    m = cfg.mla
    B, T, _ = c_kv.shape
    h = cfg.n_heads
    k_nope = (c_kv @ p["w_uk"]).reshape(B, T, h, m.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, T, h, m.v_dim)
    return torch.cat([k_nope, k_r.expand(B, T, h, m.qk_rope_dim)], dim=-1), v


def _mla_attend(q, k, v, cfg, *, q_pos=None, mode=None, q_off: int = 0):
    """`attention` of MLA's heads, v padded to q's head dim on the kernel
    route (module docstring)."""
    m = cfg.mla
    kw = dict(causal=True, q_pos=q_pos, kv_pos=q_pos, chunk=cfg.blockwise_chunk, mode=mode,
              q_off=q_off)
    # the route is decided on the kernel's shapes: v padded to k's head dim
    if kernel_route(q, k, k, q_pos=q_pos, kv_pos=q_pos, q_off=q_off):
        vp = torch.nn.functional.pad(v, (0, k.shape[-1] - m.v_dim))
        return attention(q, k, vp, **kw)[..., : m.v_dim]
    return attention(q, k, v, **kw)


def mla_attn(p, x: torch.Tensor, cfg, *, positions=None, mode: str | None = None, hint=None):
    """Prefill MLA (materialized heads) -> (out, (c_kv, k_rope)).  JAX passes
    ``scale = 1 / sqrt(qk_nope + qk_rope)``, which is the default for q's
    head dim: here None, so that the call may take the kernel route, where v
    is padded with zeros to q's head dim (module docstring).  positions None
    means ``arange(S)`` from 0, as in `gqa_attn`.  Under a model layout of
    `hint`, as `gqa_attn`: "tp" on the sequence gathered with the rank's
    heads (``w_uq``, ``w_uk``, ``w_uv`` and ``w_o``'s rows), the latents
    whole; "sp" the queries and latents on the slice, the latents gathered
    over the sequence and expanded to K and V there; the latents returned
    are whole."""
    layout = getattr(hint, "layout", None)
    if layout == "tp":
        seq = hint.seq_group
        out, lat = mla_attn(p, comm.gather_dim(x, 1, seq), local_heads(cfg, hint), mode=mode)
        return comm.scatter_dim(out, 1, seq), lat
    if layout == "sp":
        seq = hint.seq_group
        off = _slice_offset(x, hint)
        pos = torch.arange(off, off + x.shape[1], device=x.device)[None, :]
        c_kv, k_r = _mla_latents(p, x, cfg, pos)
        q = torch.cat(_mla_q(p, x, cfg, pos), dim=-1)
        c_kv, k_r = comm.gather_dim(c_kv, 1, seq), comm.gather_dim(k_r, 1, seq)
        k, v = _mla_expand(p, c_kv, k_r, cfg)
        out = _mla_attend(q, k, v, cfg, mode=mode, q_off=off)
        return out.reshape(*x.shape[:2], -1) @ p["w_o"], (c_kv, k_r[:, :, 0, :])
    q_pos = positions
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v, c_kv, k_r = mla_project_qkv(p, x, cfg, positions)
    out = _mla_attend(q, k, v, cfg, q_pos=q_pos, mode=mode)
    return out.reshape(*x.shape[:2], -1) @ p["w_o"], (c_kv, k_r)


def mla_decode(p, x: torch.Tensor, cfg, *, cache_ckv, cache_kr, pos: int, kv_pos, kv_valid,
               slots=None, hint=None):
    """Absorbed-matrix MLA decode: attention runs in the latent space, in
    f32, and the cache stores only (c_kv, k_rope).  cache_ckv (B, T, r_kv)
    and cache_kr (B, T, rope_dim) are written in place at slot ``pos % T``
    (as `gqa_decode`'s).  Returns (out, (cache_ckv, cache_kr)).  On a mesh,
    `slots` and `hint` as in `gqa_decode`: the latents are every rank's;
    under "tp" the rank's heads' latent queries (``w_uq``, ``w_uk``) are
    gathered over the model axis, every head attends over the rank's
    slots, and the rank's heads of the merged latent output go through its
    ``w_uv`` and its rows of ``w_o``, summed over the axis."""
    m = cfg.mla
    B = x.shape[0]
    tp = getattr(hint, "layout", None) == "tp"
    lcfg = local_heads(cfg, hint)
    h = lcfg.n_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    c_kv, k_r = _mla_latents(p, x, cfg, positions)  # (B, 1, r), (B, 1, 1, rd)
    q_nope, q_rope = _mla_q(p, x, lcfg, positions)  # (B, 1, h, *)
    _write_slot((cache_ckv, cache_kr), (c_kv, k_r[:, :, 0]), pos, slots)
    # absorb: q_c = q_nope @ w_uk (per head), a latent-space query
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_dim).float()
    q_c = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
    q_rope = q_rope.float()
    if tp:
        q_c, q_rope = (comm.all_gather(t, 2, hint.seq_group) for t in (q_c, q_rope))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    ckv = cache_ckv.float()
    s = torch.einsum("bshr,btr->bhst", q_c, ckv)
    s = s + torch.einsum("bshd,btd->bhst", q_rope, cache_kr.float())
    bias = _mask_bias(positions, kv_pos, causal=True, window=None, kv_valid=kv_valid)
    merge = _merge(slots, hint)
    probs = softmax_over(s * scale + bias[:, None], merge)
    o_lat = torch.einsum("bhst,btr->bshr", probs, ckv)
    if merge is not None:
        o_lat = merge.sum(o_lat)
    if tp:
        o_lat = o_lat.narrow(2, hint.model_rank * h, h)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_dim).float()
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv).to(x.dtype)
    y = out.reshape(B, 1, -1) @ p["w_o"]
    return (tp_sum(y, hint) if tp else y), (cache_ckv, cache_kr)
