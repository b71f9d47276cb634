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

`moe_ffn` chooses between JAX's two paths as JAX does: on a mesh whose
shapes divide (`_a2a_plan`), the all-to-all expert-parallel path
(`_moe_ffn_a2a`): each rank takes its slice of the sequence on the model
axis (the model layout's ``"act"``), scatters its tokens into (E, C, D) buffers, sends each expert's
buffer to the rank holding that expert (an all-to-all over the
expert-parallel axes), runs its local experts and sends the outputs back;
otherwise the grouped-scatter path (`_moe_ffn_scatter`) with the experts
gathered, whose load statistics are averaged over the ranks that split the
batch, so that the aux loss is the global batch's, as under JAX's GSPMD.
Under a model layout (`sharding.rules.model_layout`) the input is the
rank's slice of the sequence: the grouped-scatter path, whose capacity
groups are whole sequences, gathers the sequence and keeps its slice of
the output.  A decode step on a mesh (``hint.decode``) takes the
expert-parallel path of JAX's ``"moe_group"`` / ``"moe_dispatch"`` hints
at S = 1 (`_moe_decode_ep`): the experts stay where `rules.param_specs`
lays them (over ("data", "model") or "model" alone), each rank runs its
experts on every row routed to them, the rows gathered over the batch
axes the stacks span, and the partial outputs are summed over the
stacks' axes; no rank gathers an expert stack.  The shared experts run
as the dense MLP does (`layers.apply_mlp`, "tp" or "sp").
``router_bias`` is updated by `train.step`.  The expert products are
batched matmuls over E, as JAX's einsums are (no Pallas kernel there).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..sharding import comm
from ..sharding import rules
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
        # non-trainable: `train.step` moves it by the aux-free balancing rule
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


def _route(p, x: torch.Tensor, m, group=None):
    """x (B, S, D) -> (weights (B, S, k) f32, idx (B, S, k) int64, metrics).
    With `group`, the ranks that split the batch: the load statistics and
    the z loss are averaged over them before the aux loss (the global
    batch's)."""
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
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    if group is not None:
        f_e, p_e, z = (comm.mean_over(t, group) for t in (f_e, p_e, z))
    aux = e * torch.sum(f_e / m.top_k * p_e)
    return w, idx, {"moe_aux": aux, "moe_z": z, "expert_load": f_e}


def capacity(cfg, seq_len: int, capacity_factor: float | None = None) -> int:
    """Slots an expert has for one sequence of `seq_len` tokens."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    return max(int(math.ceil(seq_len * m.top_k / m.n_experts * cf)), 1)


def moe_ffn(p, x: torch.Tensor, cfg, *, capacity_factor: float | None = None, hint=None):
    """x (B, S, D) -> (out (B, S, D), metrics).  `capacity_factor` None is
    the config's (decode passes ``decode_capacity_factor``).  With a
    sharded `hint` (`sharding.rules.make_hint`, its ``batch`` the global
    batch size), `x` is this rank's rows and `p` a `lm.Gathered` view: the
    all-to-all path when `_a2a_plan` gives a plan, as in JAX."""
    out, metrics = _routed(p, x, cfg, capacity_factor, hint)
    if cfg.moe.n_shared and "shared" in p:
        out = out + apply_mlp(p["shared"], x, act=cfg.moe.act, style="glu", hint=hint)
    return out, metrics


def _routed(p, x: torch.Tensor, cfg, capacity_factor, hint):
    """The routed experts of `moe_ffn` (its paths) -> (out, metrics)."""
    mesh = getattr(hint, "mesh", None)
    if mesh is None:
        return _moe_ffn_scatter(p, x, cfg, capacity_factor=capacity_factor)
    B, S, D = x.shape
    if getattr(hint, "decode", False):
        plan = _ep_decode_plan(mesh, cfg, hint.batch)
        if plan is not None:
            return _moe_decode_ep(p, x, cfg, capacity_factor, plan)
        return _moe_ffn_scatter(p, x, cfg, capacity_factor=capacity_factor)
    sliced = getattr(hint, "layout", None) is not None
    S_glob = S * hint.model_size if sliced else S
    n = hint.batch if S > 1 else B
    plan = _a2a_plan(mesh, cfg, (n, S_glob, D), capacity_factor)
    if plan is not None:
        if "model" in rules.dp_axes(mesh, cfg):
            raise ValueError(f"{cfg.name}: the all-to-all MoE path needs the batch off the "
                             "model axis (dp_over_model is set)")
        return _moe_ffn_a2a(p, x, cfg, plan)
    axes = rules.batch_axes(n, mesh, cfg) if S > 1 else ()
    group = comm.axes_group(mesh, axes) if axes else None
    if not sliced:
        return _moe_ffn_scatter(p, x, cfg, capacity_factor=capacity_factor, group=group)
    seq = hint.seq_group
    out, metrics = _moe_ffn_scatter(p, comm.gather_dim(x, 1, seq), cfg,
                                    capacity_factor=capacity_factor, group=group)
    return comm.slice_dim(out, 1, seq), metrics


def _a2a_plan(mesh, cfg, xshape, capacity_factor):
    """JAX's plan of the all-to-all path for a global batch of shape
    `xshape` (B, S, D), or None (decode, one rank, indivisible shapes):
    the batch axes ``bdp``, the expert-parallel axes ``a2a_axes`` and their
    rank count ``n_ep``, every axis of the metrics' mean ``all_axes``, and
    a shard's tokens ``L`` and expert capacity ``C``."""
    m = cfg.moe
    B, S, D = xshape
    sizes = rules.mesh_axis_sizes(mesh)
    bdp = tuple(a for a in ("pod", "data") if a in sizes)  # batch axes
    n_b = math.prod(sizes[a] for a in bdp)
    n_s = sizes.get("model", 1)  # the sequence axis
    ep_total = sizes.get("data", 1) * n_s
    if m.n_experts % ep_total == 0 and ep_total > 1:
        a2a_axes: tuple = ("data", "model")
        n_ep = ep_total
    elif m.n_experts % n_s == 0 and n_s > 1:
        a2a_axes = ("model",)
        n_ep = n_s
    else:
        return None
    # decode (S == 1) stays on the scatter path; indivisible shapes too
    if S == 1 or B % n_b or (S % n_s if S > 1 else 0):
        return None
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    L = (B // n_b) * (S // n_s)  # tokens a shard
    C = max(int(math.ceil(L * m.top_k / m.n_experts * cf)), 1)
    return {"mesh": mesh, "bdp": bdp, "a2a_axes": a2a_axes,
            "all_axes": bdp + (("model",) if n_s > 1 else ()),
            "L": L, "C": C, "n_ep": n_ep}


def _moe_ffn_a2a(p, x: torch.Tensor, cfg, plan):
    """JAX's expert-parallel path on this rank's rows' slice of the
    sequence `x` (B_loc, S / m, D): a plan over a model axis of m > 1 ranks
    comes only with a model layout (`rules.model_layout`: the plan and the
    layout both need m to divide S), whose ``"act"`` is that slice, and
    the output is too.  Its L * k choices ranked by a cumsum over the shard
    (capacity C a shard), scattered into (E, C, D), the all-to-all to the
    experts' ranks, the local experts, the all-to-all back, the weighted
    k-sum; the metrics averaged over all the plan's axes."""
    m = cfg.moe
    mesh = plan["mesh"]
    L, C, n_ep = plan["L"], plan["C"], plan["n_ep"]
    E, k = m.n_experts, m.top_k
    E_loc = E // n_ep
    D = x.shape[-1]
    if x.shape[0] * x.shape[1] != L:
        raise ValueError(f"_moe_ffn_a2a: {tuple(x.shape)} is not this plan's {L} tokens a shard")
    pr = {"router": p["router"]}
    if "router_bias" in p:
        pr["router_bias"] = p["router_bias"]
    w, idx, metrics = _route(pr, x, m)
    idxf = idx.reshape(L * k)
    oh = F.one_hot(idxf, E)
    slot = torch.gather(torch.cumsum(oh, dim=0) - oh, 1, idxf[:, None])[:, 0]
    del oh
    keep = slot < C
    slot_c = torch.clamp(slot, max=C - 1)
    upd = torch.where(keep[:, None], torch.repeat_interleave(x.reshape(L, D), k, dim=0),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = x.new_zeros((E, C, D)).index_put((idxf, slot_c), upd, accumulate=True)
    # dispatch: expert e's buffer to the rank holding it -> (E_loc, n_ep * C, D)
    ep = comm.axes_group(mesh, plan["a2a_axes"])
    xe = comm.all_to_all(buf.reshape(n_ep, E_loc, C, D), ep)
    xe = xe.transpose(0, 1).reshape(E_loc, n_ep * C, D)
    act = ACTIVATIONS[m.act]
    wg, wu, wd = (p.local(n) for n in ("w_gate", "w_up", "w_down"))
    ye = torch.bmm(act(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)
    # combine: each source rank's outputs back to it -> (E, C, D)
    yb = comm.all_to_all(ye.reshape(E_loc, n_ep, C, D).transpose(0, 1), ep).reshape(E, C, D)
    y = yb[idxf, slot_c]
    y = y * (w.reshape(L * k, 1) * keep[:, None]).to(y.dtype)
    out = torch.sum(y.reshape(L, k, D), dim=1).reshape(x.shape)
    drop = 1.0 - torch.mean(keep.to(torch.float32))
    everyone = comm.axes_group(mesh, plan["all_axes"])
    mets = comm.mean_over(torch.stack([metrics["moe_aux"], metrics["moe_z"], drop]), everyone)
    load = comm.mean_over(metrics["expert_load"], everyone)
    metrics = {"moe_aux": mets[0], "moe_z": mets[1], "moe_drop_frac": mets[2],
               "expert_load": load}
    return out, metrics


def _ep_decode_plan(mesh, cfg, batch: int):
    """The expert-parallel decode of a global batch of `batch` rows on
    `mesh`, or None where the expert stacks are whole on every rank: the
    axes the stacks lie over (``ep``, `rules.param_specs`' rule) and the
    batch axes among them over which the rows are
    gathered (``rows``: a row is whole along "model", and along an axis
    that does not split the batch every rank holds the same rows)."""
    sizes = rules.mesh_axis_sizes(mesh)
    ax = rules._maybe(("data", "model"), cfg.moe.n_experts, sizes)
    if ax is None:
        return None
    ep = (ax,) if isinstance(ax, str) else tuple(ax)
    rows = tuple(a for a in rules.batch_axes(batch, mesh, cfg) if a in ep)
    return {"mesh": mesh, "ep": ep, "rows": rows}


def _moe_decode_ep(p, x: torch.Tensor, cfg, capacity_factor, plan):
    """The routed experts of a decode step (`_ep_decode_plan`) on this
    rank's rows `x` (B, 1, D), whole on every rank of the model axis: the
    rows, their choices and their weights gathered over ``plan["rows"]``,
    this rank's experts (its part of the stacks, `lm.Gathered.local`) run on
    every gathered row routed to them, the weighted outputs summed in f32
    over the stacks' ranks and rounded once, and the rank's rows kept.
    Each (row, expert) pair is computed on the one rank holding the expert.
    The capacity is a row's (C = ceil(k / E x cf), as `_moe_ffn_scatter`'s
    at S = 1): a choice past it weighs 0."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    mesh = plan["mesh"]
    w, idx, metrics = _route(p, x, m)
    idx = idx.reshape(B * S, k)
    oh = F.one_hot(idx, E)
    slot = torch.gather(torch.cumsum(oh, dim=1) - oh, 2, idx[:, :, None])[:, :, 0]
    del oh
    keep = slot < capacity(cfg, S, capacity_factor)
    metrics["moe_drop_frac"] = 1.0 - torch.mean(keep.to(torch.float32))
    wk = w.reshape(B * S, k) * keep
    xr = x.reshape(B * S, D)
    rows = comm.axes_group(mesh, plan["rows"]) if plan["rows"] else None
    if rows is not None:
        xr, idx, wk = (comm.all_gather(t, 0, rows) for t in (xr, idx, wk))
    wg, wu, wd = (p.local(n) for n in ("w_gate", "w_up", "w_down"))
    ep = comm.axes_group(mesh, plan["ep"])
    E_loc = wg.shape[0]
    e0 = dist.get_rank(ep) * E_loc
    mine = (idx >= e0) & (idx < e0 + E_loc)
    e_loc = torch.clamp(idx - e0, 0, E_loc - 1)
    n = xr.shape[0]
    row = torch.arange(n, device=x.device)[:, None].expand(n, k)
    upd = torch.where(mine[:, :, None], xr[:, None, :].expand(n, k, D),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    x_e = xr.new_zeros((E_loc, n, D)).index_put_((e_loc, row), upd, accumulate=True)
    del upd
    act = ACTIVATIONS[m.act]
    y_e = torch.bmm(act(torch.bmm(x_e, wg)) * torch.bmm(x_e, wu), wd)
    del x_e
    y = torch.sum(y_e[e_loc, row].float() * (wk * mine)[:, :, None], dim=1)
    y = comm.sum_over(y, ep)
    if rows is not None:
        y = y.chunk(comm.group_size(rows))[dist.get_rank(rows)]
    return y.to(x.dtype).reshape(B, S, D), metrics


def _moe_ffn_scatter(p, x: torch.Tensor, cfg, *, capacity_factor: float | None = None,
                     group=None):
    """The grouped-scatter path: route, dispatch each group's kept choices
    into (B, E, C, D) buffers, run the experts as batched matmuls over E,
    gather each choice's output back and sum its k weighted outputs (the
    shared experts are `moe_ffn`'s).  `group` as in `_route` (its drop
    share averaged too)."""
    m = cfg.moe
    B, S, D = x.shape
    k, E = m.top_k, m.n_experts
    C = capacity(cfg, S, capacity_factor)

    # JAX's three-argument call off a mesh (`_route` is wrapped by the route
    # recorders of the checks)
    w, idx, metrics = _route(p, x, m) if group is None else _route(p, x, m, group)

    # group-local slot assignment (group = sequence)
    idxg = idx.reshape(B, S * k)
    ohg = F.one_hot(idxg, E)  # (B, S*k, E)
    ranks = torch.cumsum(ohg, dim=1) - ohg  # rank within the group
    slot = torch.gather(ranks, 2, idxg[:, :, None])[:, :, 0]
    del ohg, ranks
    keep = slot < C
    metrics["moe_drop_frac"] = 1.0 - torch.mean(keep.to(torch.float32))
    if group is not None:
        metrics["moe_drop_frac"] = comm.mean_over(metrics["moe_drop_frac"], group)
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
    return out, metrics
