"""Mixture-of-Experts FFN (the counterpart of `repro.models.moe`): top-k
token-choice routing with capacity, scatter dispatch / combine, shared
experts, and aux-free bias routing (DeepSeek-V3).

Capacity is grouped, as in JAX: each sequence is a group, every expert
takes at most ``C = max(ceil(S * k / E * cf), 1)`` of a group's tokens, and
a token's slot in its expert's buffer is its rank among the group's
choices of that expert in the flattened (S * k) order.  A choice past
capacity is dropped with weight 0 (the residual path still carries the
token), and ``moe_drop_frac`` reports the share dropped.

Routing styles:
  "softmax"  softmax over logits, top-k probs as weights (Switch/Mixtral);
  "sigmoid"  DeepSeek-V3: sigmoid scores, selection adds the non-trainable
             ``router_bias`` (aux-free load balancing), weights are the
             *unbiased* scores normalized over the selected k.

`moe_ffn` is JAX's grouped-scatter path (`_moe_ffn_scatter`) on one card:
it takes no mesh.  JAX's all-to-all expert-parallel path (`_a2a_plan`,
`_moe_ffn_a2a`) waits for sharding (ROADMAP Queue 1 item 8 step 9), and
the update of ``router_bias`` for training (step 8).  The expert products
are batched matmuls over E, as JAX's einsums are (no Pallas kernel there).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ACTIVATIONS, _param, apply_mlp, dense_init, init_mlp


def init_moe(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    init = dict(device=device, generator=generator)
    dt = cfg.param_dtype
    p = {
        "router": dense_init((d, e), dtype=torch.float32, scale=0.02, **init),
        "w_gate": dense_init((e, d, f), dtype=dt, **init),
        "w_up": dense_init((e, d, f), dtype=dt, **init),
        "w_down": dense_init(
            (e, f, d), dtype=dt, scale=1.0 / math.sqrt(f * 2 * cfg.n_layers), **init
        ),
    }
    if m.router_style == "sigmoid":
        # non-trainable: a training loop updates it (ROADMAP Queue 1 item 8 step 8)
        p["router_bias"] = _param(torch.zeros(e, dtype=torch.float32, device=device))
    if m.n_shared:
        p["shared"] = init_mlp(d, m.d_ff_shared * m.n_shared, style="glu", dtype=dt, **init)
    return nn.ParameterDict(p)


def selection_scores(p, x: torch.Tensor, m):
    """x (B, S, D) -> (logits, probs, sel), each (B, S, E) in f32: the
    router's logits, the probabilities the aux loss reads, and the scores
    top-k selects on (sigmoid: the scores plus ``router_bias``)."""
    logits = x.to(torch.float32) @ p["router"]
    if m.router_style == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"] if "router_bias" in p else scores
        probs = scores / torch.clamp(torch.sum(scores, dim=-1, keepdim=True), min=1e-9)
        return logits, probs, sel
    probs = torch.softmax(logits, dim=-1)
    return logits, probs, probs


def _route(p, x: torch.Tensor, m):
    """x (B, S, D) -> (weights (B, S, k) f32, idx (B, S, k) int64, metrics)."""
    logits, probs, sel = selection_scores(p, x, m)
    w, idx = torch.topk(sel, m.top_k, dim=-1)
    if m.router_style == "sigmoid":
        w = torch.gather(torch.sigmoid(logits), -1, idx)
    if m.router_style == "sigmoid" or m.norm_topk:
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    # Switch-style load-balance aux loss + router z-loss (both f32)
    f_e = torch.mean(torch.sum(F.one_hot(idx, e).to(torch.float32), dim=-2), dim=(0, 1))
    p_e = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(f_e / m.top_k * p_e)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return w, idx, {"moe_aux": aux, "moe_z": z, "expert_load": f_e}


def capacity(cfg, seq_len: int, capacity_factor: float | None = None) -> int:
    """Slots an expert has for one sequence of `seq_len` tokens."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    return max(int(math.ceil(seq_len * m.top_k / m.n_experts * cf)), 1)


def moe_ffn(p, x: torch.Tensor, cfg, *, capacity_factor: float | None = None):
    """x (B, S, D) -> (out (B, S, D), metrics): route, dispatch each group's
    kept choices into (B, E, C, D) buffers, run the experts as batched
    matmuls over E, gather each choice's output back and sum its k weighted
    outputs; plus the shared experts.  `capacity_factor` None is the
    config's (decode passes ``decode_capacity_factor``)."""
    m = cfg.moe
    B, S, D = x.shape
    k, E = m.top_k, m.n_experts
    C = capacity(cfg, S, capacity_factor)

    w, idx, metrics = _route(p, x, m)

    # group-local slot assignment (group = sequence)
    idxg = idx.reshape(B, S * k)
    ohg = F.one_hot(idxg, E)  # (B, S*k, E)
    ranks = torch.cumsum(ohg, dim=1) - ohg  # rank within the group
    slot = torch.gather(ranks, 2, idxg[:, :, None])[:, :, 0]
    del ohg, ranks
    keep = slot < C
    metrics["moe_drop_frac"] = 1.0 - torch.mean(keep.to(torch.float32))
    slot_c = torch.clamp(slot, max=C - 1)

    # dispatch: a kept choice to its slot; a dropped one adds zero at C - 1
    x_rep = torch.repeat_interleave(x, k, dim=1)  # (B, S*k, D)
    upd = torch.where(keep[:, :, None], x_rep, torch.zeros((), dtype=x.dtype, device=x.device))
    del x_rep
    b_iota = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    x_eg = x.new_zeros((B, E, C, D))
    x_eg.index_put_((b_iota, idxg, slot_c), upd, accumulate=True)
    del upd
    x_e = x_eg.transpose(0, 1).reshape(E, B * C, D)
    del x_eg

    # the experts, batched over E
    act = ACTIVATIONS[m.act]
    h = act(torch.bmm(x_e, p["w_gate"])) * torch.bmm(x_e, p["w_up"])
    del x_e
    y_e = torch.bmm(h, p["w_down"])
    del h

    # combine: gather each choice's output, weighted k-sum
    y_eg = y_e.reshape(E, B, C, D).transpose(0, 1)
    y = y_eg[b_iota, idxg, slot_c]  # (B, S*k, D)
    del y_e, y_eg
    y = y * (w.reshape(B, S * k, 1) * keep[:, :, None]).to(y.dtype)
    out = torch.sum(y.reshape(B, S, k, D), dim=2)

    if m.n_shared and "shared" in p:
        out = out + apply_mlp(p["shared"], x, act=m.act, style="glu")
    return out, metrics
