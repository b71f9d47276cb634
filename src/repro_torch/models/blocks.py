"""Per-layer blocks (the counterpart of `repro.models.blocks`): init,
full-sequence apply, decode apply and the KV cache of one layer.

Ported: kind ``"attn"`` (self-attention with GQA/MQA/MHA + dense MLP).
Every other kind of the JAX package raises `NotImplementedError` naming
the step of ROADMAP Queue 1 item 8 that ports it.
"""

from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

# kind -> the step of ROADMAP Queue 1 item 8 (the LM stack) that ports it
_QUEUED = {
    "moe": "step 4 (MoE)",
    "mla": "step 5 (MLA)",
    "mla_moe": "step 5 (MLA)",
    "mamba": "step 6 (Mamba2 and xLSTM)",
    "mlstm": "step 6 (Mamba2 and xLSTM)",
    "slstm": "step 6 (Mamba2 and xLSTM)",
    "xattn": "step 7 (cross-attention and enc-dec)",
    "enc": "step 7 (cross-attention and enc-dec)",
    "dec": "step 7 (cross-attention and enc-dec)",
}


def check_kind(kind: str) -> None:
    if kind == "attn":
        return
    if kind in _QUEUED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: ROADMAP Queue 1 item 8, {_QUEUED[kind]}"
        )
    raise ValueError(f"unknown block kind {kind!r}")


def _norm(cfg) -> dict:
    return dict(kind=cfg.norm, eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)


def init_block(kind: str, cfg, *, device=None, generator=None) -> nn.ModuleDict:
    check_kind(kind)
    d = cfg.d_model

    def nrm():
        return init_norm(d, kind=cfg.norm, gemma_style=cfg.gemma_norm, device=device)

    return nn.ModuleDict(
        {
            "ln1": nrm(),
            "attn": attn_mod.init_gqa(cfg, device=device, generator=generator),
            "ln2": nrm(),
            "mlp": init_mlp(
                d,
                cfg.d_ff,
                style=cfg.mlp_style,
                dtype=cfg.param_dtype,
                device=device,
                generator=generator,
            ),
        }
    )


def apply_block(kind: str, p, h: torch.Tensor, cfg, *, positions=None, mode: str | None = None):
    """Full-sequence apply (prefill) -> (h, cache entry {"k", "v"}).
    positions None means ``arange(S)``; `mode` reaches the attention kernel."""
    check_kind(kind)
    n = _norm(cfg)
    x = apply_norm(h, p["ln1"], **n)
    a, (k, v) = attn_mod.gqa_attn(p["attn"], x, cfg, positions=positions, mode=mode)
    h = h + a
    x2 = apply_norm(h, p["ln2"], **n)
    h = h + apply_mlp(p["mlp"], x2, act=cfg.act, style=cfg.mlp_style)
    return h, {"k": k, "v": v}


def init_block_cache(
    kind: str, cfg, batch: int, cache_len: int, dtype, *, device=None
) -> dict[str, torch.Tensor]:
    """Zero cache entry for one layer of `kind`."""
    check_kind(kind)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def apply_block_decode(kind: str, p, h: torch.Tensor, cfg, *, cache, pos: int, kv_pos, kv_valid):
    """One-token apply -> (h, cache entry), the entry's tensors written in
    place (`attention.gqa_decode`)."""
    check_kind(kind)
    n = _norm(cfg)
    x = apply_norm(h, p["ln1"], **n)
    a, (ck, cv) = attn_mod.gqa_decode(
        p["attn"],
        x,
        cfg,
        cache_k=cache["k"],
        cache_v=cache["v"],
        pos=pos,
        kv_pos=kv_pos,
        kv_valid=kv_valid,
    )
    h = h + a
    x2 = apply_norm(h, p["ln2"], **n)
    h = h + apply_mlp(p["mlp"], x2, act=cfg.act, style=cfg.mlp_style)
    return h, dict(cache, k=ck, v=cv)
