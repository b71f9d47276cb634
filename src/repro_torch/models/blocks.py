"""Per-layer blocks (the counterpart of `repro.models.blocks`): init,
full-sequence apply, decode apply and the cache of one layer.

Kinds (all of the JAX package's):
  attn      self-attention (GQA/MQA/MHA, optional SWA) + dense MLP
  moe       self-attention + MoE FFN (optionally + a parallel dense FFN
            with its own ``ln_dense`` norm: Arctic)
  mla       MLA attention + dense MLP            (DeepSeek dense layers)
  mla_moe   MLA attention + MoE FFN              (DeepSeek MoE layers)
  mamba     Mamba2 mixer                          (Zamba2 backbone)
  mlstm     xLSTM mLSTM block
  slstm     xLSTM sLSTM block
  xattn     gated cross-attention + gated MLP     (Llama-3.2-Vision)
  enc       bidirectional self-attention + MLP    (encoder)
  dec       causal self-attn + cross-attn + MLP   (decoder)

A layer's cache entry is ``{"k", "v"}`` (B, T, G, hd) for attention and
``{"ckv", "kr"}`` (B, T, r_kv) / (B, T, rope_dim) for MLA, the time axis 1
in both.  The state kinds (`STATE_KINDS`: ``ln1`` and their mixer or cell,
no MLP) keep their f32 state by name, with no time axis: ``mamba``
``{"ssm", "conv"}``, ``mlstm`` ``{"C", "n", "m", "conv"}``, ``slstm``
``{"c", "n", "h", "m"}``.  The kinds that attend over a context
(``xattn``, ``dec``: `CONTEXT_ENTRIES`) keep its K and V under JAX's names,
filled by the prefill and read, never written, by decode: ``xattn``
``{"k", "v"}`` (B, T_ctx, G, hd), ``dec`` its self-attention's ``{"k",
"v"}`` and the context's ``{"xk", "xv"}``.  ``enc`` runs in the encoder's
prefill only and has no decode.  Decode writes every other entry in place.
The gates of ``xattn`` (``attn.gate_attn``, ``gate_mlp``) are scalar f32
parameters, 0 at init as in JAX: a fresh layer is the identity.

Under a model layout (`sharding.rules.model_layout`, the hint's) a block's
input and output are the rank's slice of the sequence (JAX's ``"act"``):
the norms run there, attention and the MLP split the work as the layout
says (`attention`, `layers.apply_mlp`), and a recurrent mixer gathers the
sequence at entry.  The Mamba2 mixer then computes the rank's SSD heads
where they divide the model axis (`sharding.rules.ssm_heads`, JAX's
``"ssm_heads"``) and its row-parallel output is reduce-scattered back to
the sequence slices; its final state is the rank's heads' part
(`lm.prefill` gathers it).  Elsewhere, and the xLSTM cells always, the
mixer computes the sequence whole and keeps its slice at exit.  In
decode (`sharding.rules.decode_layout`) the rows are whole on every rank
of the model axis: attention reads the rank's slots of the cache
(split-K), "tp" splits the heads and the FFN hidden, the MoE experts run
where they lie, and a recurrent mixer computes its whole state, as JAX's
(whose `cache_specs` does not split it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ..sharding import comm
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import _param, apply_mlp, apply_norm, init_mlp, init_norm

PORTED = ("attn", "moe", "mla", "mla_moe", "mamba", "mlstm", "slstm", "xattn", "enc", "dec")
MLA_KINDS = ("mla", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")
STATE_KINDS = ("mamba", "mlstm", "slstm")
# kind -> the cache entries that hold the context's K and V (no prompt positions)
CONTEXT_ENTRIES = {"xattn": ("k", "v"), "dec": ("xk", "xv")}


class _StateKind(NamedTuple):
    module: str  # the block's sub-module beside ``ln1``
    init: Callable
    apply: Callable  # full sequence -> (y, final state)
    decode: Callable  # one token against a state -> (y, new state)
    init_state: Callable


_STATE = {
    "mamba": _StateKind("mixer", ssm_mod.init_mamba2, ssm_mod.mamba2_mixer,
                        ssm_mod.mamba2_decode, ssm_mod.init_mamba2_state),
    "mlstm": _StateKind("cell", xlstm_mod.init_mlstm_block, xlstm_mod.mlstm_block,
                        xlstm_mod.mlstm_block_decode, xlstm_mod.init_mlstm_state),
    "slstm": _StateKind("cell", xlstm_mod.init_slstm_block, xlstm_mod.slstm_block,
                        xlstm_mod.slstm_block_decode, xlstm_mod.init_slstm_state),
}

def check_kind(kind: str) -> None:
    if kind not in PORTED:
        raise ValueError(f"unknown block kind {kind!r}")


def _norm(cfg) -> dict:
    return dict(kind=cfg.norm, eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)


def init_block(kind: str, cfg, *, device=None, generator=None) -> nn.ModuleDict:
    check_kind(kind)
    d = cfg.d_model
    init = dict(device=device, generator=generator)

    def nrm():
        return init_norm(d, kind=cfg.norm, gemma_style=cfg.gemma_norm, device=device)

    def mlp():
        return init_mlp(d, cfg.d_ff, style=cfg.mlp_style, dtype=cfg.param_dtype, **init)

    if kind in STATE_KINDS:
        sk = _STATE[kind]
        return nn.ModuleDict({"ln1": nrm(), sk.module: sk.init(cfg, **init)})
    if kind == "xattn":
        p = nn.ModuleDict({"ln1": nrm(), "attn": attn_mod.init_cross_attn(cfg, gated=True, **init),
                           "ln2": nrm(), "mlp": mlp()})
        p.register_parameter("gate_mlp", _param(torch.zeros((), dtype=torch.float32, device=device)))
        return p
    if kind == "dec":
        return nn.ModuleDict({"ln1": nrm(), "attn": attn_mod.init_gqa(cfg, **init), "ln_x": nrm(),
                              "xattn": attn_mod.init_cross_attn(cfg, gated=False, **init),
                              "ln2": nrm(), "mlp": mlp()})
    attn = attn_mod.init_mla(cfg, **init) if kind in MLA_KINDS else attn_mod.init_gqa(cfg, **init)
    p = {"ln1": nrm(), "attn": attn, "ln2": nrm()}
    if kind in MOE_KINDS:
        p["moe"] = moe_mod.init_moe(cfg, **init)
        if cfg.moe.dense_parallel:
            p["dense_mlp"] = mlp()
            p["ln_dense"] = nrm()
    else:
        p["mlp"] = mlp()
    return nn.ModuleDict(p)


def _ffn(kind: str, p, h: torch.Tensor, cfg, *, capacity_factor=None, hint=None):
    """The block's second half: h -> (h + FFN(h), MoE metrics or {})."""
    n = _norm(cfg)
    x2 = apply_norm(h, p["ln2"], **n)
    if kind not in MOE_KINDS:
        return h + apply_mlp(p["mlp"], x2, act=cfg.act, style=cfg.mlp_style, hint=hint), {}
    mo, metrics = moe_mod.moe_ffn(p["moe"], x2, cfg, capacity_factor=capacity_factor, hint=hint)
    if "dense_mlp" in p:
        xd = apply_norm(h, p["ln_dense"], **n)
        mo = mo + apply_mlp(p["dense_mlp"], xd, act=cfg.act, style=cfg.mlp_style, hint=hint)
    return h + mo, metrics


def _gated_ffn(p, h: torch.Tensor, cfg, hint=None) -> torch.Tensor:
    """``xattn``'s second half: h + tanh(gate_mlp) * MLP(h), the gate in f32
    cast to the MLP's dtype, as JAX's."""
    m = apply_mlp(p["mlp"], apply_norm(h, p["ln2"], **_norm(cfg)), act=cfg.act,
                  style=cfg.mlp_style, hint=hint)
    return h + torch.tanh(p.gate_mlp).to(m.dtype) * m


def apply_block(kind: str, p, h: torch.Tensor, cfg, *, positions=None, ctx=None,
                mode: str | None = None, hint=None):
    """Full-sequence apply (prefill) -> (h, cache entry, metrics), as JAX's:
    the metrics are the MoE FFN's (``moe_aux``, ``moe_z``, ``expert_load``,
    ``moe_drop_frac``), empty for a dense FFN.  positions None means
    ``arange(S)``; `ctx` (B, T, D) is the context of ``xattn`` and ``dec``
    (the image embeddings, the encoder's output); `mode` reaches the
    attention kernel.  ``enc`` is ``attn`` at ``causal=False``.  `hint`
    reaches the layers: under its layout `h` is the rank's slice of the
    sequence (module docstring), positions must be None, and the cache
    entry's K / V hold the rank's heads under "tp" (`lm.prefill` gathers
    them)."""
    check_kind(kind)
    layout = getattr(hint, "layout", None)
    if layout is not None and positions is not None:
        raise ValueError("apply_block: a model layout takes positions from 0 (positions=None)")
    x = apply_norm(h, p["ln1"], **_norm(cfg))
    if kind in STATE_KINDS:
        sk = _STATE[kind]
        if layout is not None:
            x = comm.gather_dim(x, 1, hint.seq_group)
        if kind == "mamba" and getattr(hint, "ssm_heads", False):
            y, fin = ssm_mod.mamba2_mixer(p[sk.module], x, cfg, group=hint.seq_group)
            return h + comm.scatter_dim(y, 1, hint.seq_group), fin, {}
        y, fin = sk.apply(p[sk.module], x, cfg)
        if layout is not None:
            y = comm.slice_dim(y, 1, hint.seq_group)
        return h + y, fin, {}
    if kind == "xattn":
        k, v = attn_mod.cross_kv(p["attn"], ctx, cfg, hint=hint)
        h = h + attn_mod.cross_attn(p["attn"], x, (k, v), cfg, mode=mode, hint=hint)
        return _gated_ffn(p, h, cfg, hint), {"k": k, "v": v}, {}
    if kind in MLA_KINDS:
        a, (ckv, kr) = attn_mod.mla_attn(p["attn"], x, cfg, positions=positions, mode=mode,
                                         hint=hint)
        cache = {"ckv": ckv, "kr": kr}
    else:
        self_cfg = cfg.replace(causal=False) if kind == "enc" else cfg
        a, (k, v) = attn_mod.gqa_attn(p["attn"], x, self_cfg, positions=positions, mode=mode,
                                      hint=hint)
        cache = {"k": k, "v": v}
    h = h + a
    if kind == "dec":
        xk, xv = attn_mod.cross_kv(p["xattn"], ctx, cfg, hint=hint)
        x = apply_norm(h, p["ln_x"], **_norm(cfg))
        h = h + attn_mod.cross_attn(p["xattn"], x, (xk, xv), cfg, mode=mode, hint=hint)
        cache |= {"xk": xk, "xv": xv}
    h, metrics = _ffn(kind, p, h, cfg, hint=hint)
    return h, cache, metrics


def init_block_cache(
    kind: str, cfg, batch: int, cache_len: int, dtype, *, ctx_len: int | None = None, device=None
) -> dict[str, torch.Tensor]:
    """Zero cache entry for one layer of `kind`: a state kind's is f32 and
    has no time axis, whatever `dtype` and `cache_len` (as JAX's); the
    context's K / V hold `ctx_len` rows (None: ``xattn`` n_image_tokens,
    ``dec`` `cache_len`, as JAX's)."""
    check_kind(kind)
    if kind in STATE_KINDS:
        return _STATE[kind].init_state(cfg, batch, device=device)
    z = dict(dtype=dtype, device=device)
    if kind in MLA_KINDS:
        m = cfg.mla
        return {
            "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), **z),
            "kr": torch.zeros((batch, cache_len, m.qk_rope_dim), **z),
        }
    g, hd = cfg.n_kv_heads, cfg.head_dim
    if kind == "xattn":
        shape = (batch, ctx_len or cfg.n_image_tokens, g, hd)
        return {"k": torch.zeros(shape, **z), "v": torch.zeros(shape, **z)}
    shape = (batch, cache_len, g, hd)
    entry = {"k": torch.zeros(shape, **z), "v": torch.zeros(shape, **z)}
    if kind == "dec":
        shape = (batch, ctx_len or cache_len, g, hd)
        entry |= {"xk": torch.zeros(shape, **z), "xv": torch.zeros(shape, **z)}
    return entry


def apply_block_decode(kind: str, p, h: torch.Tensor, cfg, *, cache, pos: int, kv_pos, kv_valid,
                       hint=None, slots=None, ctx_split: bool = False):
    """One-token apply -> (h, cache entry), the entry's tensors written in
    place (`attention.gqa_decode`, `attention.mla_decode`; a state kind's
    new state copied into its entry); the context's K / V are read only
    (``xattn`` returns its entry as it was).  The MoE FFN runs at
    ``decode_capacity_factor``, as in JAX.  ``enc`` has no decode
    (`ValueError`, as in JAX).  On a mesh (`hint` a decode hint): `slots`
    the rank's slot range of the self-attention's cache (`gqa_decode`),
    `ctx_split` whether the context's K / V are the rank's rows of it
    (`attention.cross_attn`)."""
    check_kind(kind)
    if kind == "enc":
        raise ValueError("block kind 'enc' runs in the encoder's prefill only: it has no decode")
    x = apply_norm(h, p["ln1"], **_norm(cfg))
    if kind in STATE_KINDS:
        sk = _STATE[kind]
        y, new = sk.decode(p[sk.module], x, cfg, state=cache)
        for entry, t in new.items():
            cache[entry].copy_(t)
        return h + y, cache
    if kind == "xattn":
        h = h + attn_mod.cross_attn(p["attn"], x, (cache["k"], cache["v"]), cfg, hint=hint,
                                    split=ctx_split)
        return _gated_ffn(p, h, cfg, hint), cache
    mask = dict(pos=pos, kv_pos=kv_pos, kv_valid=kv_valid, slots=slots, hint=hint)
    if kind in MLA_KINDS:
        a, (ckv, kr) = attn_mod.mla_decode(
            p["attn"], x, cfg, cache_ckv=cache["ckv"], cache_kr=cache["kr"], **mask
        )
        new_cache = dict(cache, ckv=ckv, kr=kr)
    else:
        a, (ck, cv) = attn_mod.gqa_decode(
            p["attn"], x, cfg, cache_k=cache["k"], cache_v=cache["v"], **mask
        )
        new_cache = dict(cache, k=ck, v=cv)
    h = h + a
    if kind == "dec":
        x = apply_norm(h, p["ln_x"], **_norm(cfg))
        h = h + attn_mod.cross_attn(p["xattn"], x, (cache["xk"], cache["xv"]), cfg, hint=hint,
                                    split=ctx_split)
    cf = cfg.moe.decode_capacity_factor if kind in MOE_KINDS else None
    h, _ = _ffn(kind, p, h, cfg, capacity_factor=cf, hint=hint)
    return h, new_cache
