"""The train step and the loss (the counterpart of `repro.train.step`).

f32 loss over the model's logits, global-norm clipping, AdamW or
Adafactor, microbatch gradient accumulation, the MoE aux and z losses, and
DeepSeek's aux-free update of the sigmoid router's ``router_bias``.

The state is ``{"model": LM, "opt": the optimizer's state, "step": int}``.
A step updates the model's parameters and the optimizer's state in place
and returns the same dict with ``step`` one higher (JAX returns a new,
donated state).

On a mesh (``mesh=``, a `launch.mesh` mesh): the model's parameters are
DTensors (`lm.shard_model`), each rank computes the loss of its rows of
the global batch and differentiates ``loss / world_size``, so that every
parameter's gradient arrives summed over the ranks and in its shards
(`sharding.comm`).  The ranks of the model axis split their rows' work
(`sharding.rules.model_layout`) and compute the loss together over the
vocab-parallel logits (`layers.softmax_cross_entropy_vp`), or, with the
vocabulary whole, as the mean of their sequence slices' losses: each of
them holds the same loss, so that the sum over the mesh of ``loss /
world_size`` counts it once.  The optimizer's state lies as JAX's dry run
lowers it, in ZeRO-1's layout (`sharding.rules.opt_state_specs`: AdamW's
moments and Adafactor's factors split over the mesh axes their parameter
does not use as well); each rank updates its slice of every parameter and
the slices are gathered back (`optim.zero`), so no leaf is ever gathered
whole.  The global gradient norm sums each shard once.  The metrics are
averaged over the ranks.

`state_tensors` lists a state's tensors as JAX's checkpoint holds them
(the flattened ``{"opt", "params", "step"}`` tree, in its order, named by
JAX's key paths, each run of layers stacked), so that one package's
checkpoint resumes in the other; `load_state_tensors` writes such a list
back.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..models import lm
from ..models.layers import softmax_cross_entropy, softmax_cross_entropy_vp
from ..optim import adafactor_init, adafactor_update, adamw_init, adamw_update, cosine_schedule
from ..optim.adamw import pieces
from ..optim.zero import zero_layout
from ..sharding import comm
from ..sharding import rules

OPTIMIZERS = {"adamw": (adamw_init, adamw_update), "adafactor": (adafactor_init, adafactor_update)}
F32 = torch.float32


def _optimizer(name: str):
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; expected one of {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


def _local(t):
    """A DTensor's local part (sharing its storage); any other tensor as is."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def local_leaves(leaves) -> list:
    """`lm.param_leaves` with each parameter's local part (the parameter
    itself off a mesh)."""
    return [lm.Leaf(lf.name, [_local(p) for p in lf.params], lf.stacked) for lf in leaves]


def init_state(cfg, *, optimizer: str = "adamw", device=None, generator=None,
               model: lm.LM | None = None, mesh=None) -> dict:
    """A fresh training state: `cfg`'s model drawn on `device` (None =
    "cuda") from `generator`, or `model` when given (e.g. one carried across
    by `convert.from_jax_lm_params`), made trainable (`lm.make_trainable`),
    with zero optimizer state at step 0.  With `mesh`, the model is
    sharded onto it (`lm.shard_model`; every rank draws the same model), and
    on a sharded model the state is each rank's block of ZeRO-1's layout
    (`_layouts`)."""
    init, _ = _optimizer(optimizer)
    if model is None:
        model = lm.LM(cfg, device=resolve_device(device), generator=generator)
    if mesh is not None and getattr(model, "mesh", None) is None:
        lm.shard_model(model, mesh)
    lm.make_trainable(model)
    leaves = lm.param_leaves(model)
    return {"model": model,
            "opt": init(local_leaves(leaves), _layouts(model, leaves, optimizer)[0]), "step": 0}


def _layouts(model: lm.LM, leaves, optimizer: str) -> tuple:
    """(`optim.zero.zero_layout`, `rules.opt_state_specs` or None off a
    mesh) of the model's leaves for `optimizer`: made once for the model's
    mesh, which fixes them, and kept on the model."""
    mesh = getattr(model, "mesh", None)
    kept = getattr(model, "opt_layouts", None)
    if kept is None or kept[:2] != (mesh, optimizer):
        specs = None if mesh is None else rules.opt_state_specs(
            leaves, rules.param_specs(leaves, model.cfg, mesh), mesh, optimizer)
        kept = (mesh, optimizer, zero_layout(leaves, model.cfg, mesh, optimizer), specs)
        model.opt_layouts = kept
    return kept[2:]


def loss_fn(model: lm.LM, batch: dict, *, mode: str | None = None, hint=None):
    """-> (loss, metrics) of `batch` (``tokens`` (B, S), optional ``labels``,
    and the arch's context input): the labels default to the tokens shifted
    by one (the last repeated); the MoE aux and z losses are added with the
    config's weights.  `mode` reaches the attention kernel.  With a sharded
    `hint`, `batch` is the global batch and the loss and metrics are those
    of this rank's rows (`lm.local_batch`)."""
    cfg = model.cfg
    batch = dict(batch)
    tokens = batch["tokens"]
    if batch.get("labels") is None:
        batch["labels"] = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    batch, hint = lm.local_batch(batch, hint)
    tokens = batch.pop("tokens").to(model.device)
    labels = batch.pop("labels")
    logits, metrics = lm.forward_local(model, tokens, extras=batch or None, mode=mode, hint=hint)
    labels = labels.to(model.device)
    split = lm.logits_layout(hint)
    if split == 2:
        loss, lmm = softmax_cross_entropy_vp(logits, labels, hint.seq_group, z_loss=cfg.z_loss)
    elif split == 1:  # the slice's mean; the slices' mean is the rows' (equal slices)
        labels = comm.slice_dim(labels, 1, hint.seq_group)
        loss, lmm = softmax_cross_entropy(logits, labels, z_loss=cfg.z_loss)
        loss = comm.mean_over(loss, hint.seq_group)
        lmm = {k: comm.mean_over(v, hint.seq_group) for k, v in lmm.items()}
    else:
        loss, lmm = softmax_cross_entropy(logits, labels, z_loss=cfg.z_loss)
    del logits
    metrics = dict(metrics)
    metrics.update(lmm)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * metrics.get("moe_aux", 0.0)
        loss = loss + cfg.moe.z_loss_weight * metrics.get("moe_z", 0.0)
    metrics["loss"] = loss
    return loss, metrics


def _grads(leaves) -> list:
    """The gradient of each trainable parameter after a backward pass, one
    list a leaf (None for ``router_bias``, zeros where no gradient arrived,
    as JAX's); on a mesh, each its local part."""
    out = []
    for leaf in leaves:
        if not all(p.requires_grad for p in leaf.params):
            out.append(None)
            continue
        out.append([_local(p.grad) if p.grad is not None else torch.zeros_like(_local(p))
                    for p in leaf.params])
    return out


def _replicas(leaves) -> list:
    """For each leaf, the ranks holding each shard of it (1 off a mesh)."""
    out = []
    for leaf in leaves:
        p = leaf.params[0]
        mesh = getattr(p, "device_mesh", None)
        out.append(1 if mesh is None else
                   math.prod(mesh.size(i) for i, pl in enumerate(p.placements)
                             if not pl.is_shard()))
    return out


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(g[k].to(F32))) for k in pieces(g.shape))


def _global_norm(grads, replicas=None) -> torch.Tensor:
    if replicas is None:
        sq = sum(_square_sum(g) for gs in grads if gs for g in gs)
        return torch.sqrt(sq)
    # each shard once: a shard's square sum over the ranks that hold it
    sq = sum(_square_sum(g) / r for gs, r in zip(grads, replicas) if gs for g in gs)
    return torch.sqrt(comm.all_reduce(sq, dist.group.WORLD))


@torch.no_grad()
def _clip_by_global_norm(grads, max_norm: float, replicas=None) -> torch.Tensor:
    """Scale every gradient in place by ``min(1, max_norm / norm)``, in f32
    and rounded back to its dtype, as JAX's -> the norm before clipping
    (`replicas`: on a mesh, `_replicas` of the gradients' leaves)."""
    norm = _global_norm(grads, replicas)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for gs in grads:
        for g in gs or ():
            for k in pieces(g.shape):
                g[k].copy_(g[k].to(F32) * scale)
    return norm


@torch.no_grad()
def _update_router_bias(model: lm.LM, expert_load: torch.Tensor, gamma: float = 1e-3) -> None:
    """DeepSeek-V3 aux-free balancing: push every ``router_bias`` against
    the over-loaded experts by ``gamma * sign(load - mean(load))``."""
    err = expert_load - torch.mean(expert_load)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "router_bias":
            p = _local(p)  # replicated: every rank moves its copy alike
            p.copy_(p - gamma * torch.sign(err))


def _zero_grads(model: lm.LM) -> None:
    for p in model.parameters():
        p.grad = None


def _hint(cfg, mesh):
    return rules.make_hint(mesh, cfg) if mesh is not None else None


def _world(hint) -> int:
    return dist.get_world_size() if lm.sharded(hint) else 1


def _mean_metrics(metrics: dict, hint) -> dict:
    """The metrics detached, on a mesh averaged over the ranks (each rank's
    are its rows'; the ranks of one row block agree)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not lm.sharded(hint):
        return metrics
    w = dist.get_world_size()
    return {k: comm.all_reduce(v.clone(), dist.group.WORLD) / w for k, v in metrics.items()}


@torch.no_grad()
def _update(optimizer: str, model: lm.LM, leaves, grads, opt: dict, lr) -> None:
    """One optimizer step in place, on each rank's ZeRO-1 blocks of the
    state and slices of the local parts (`_layouts`)."""
    _, update = _optimizer(optimizer)
    update(local_leaves(leaves), grads, opt, lr=lr, zero=_layouts(model, leaves, optimizer)[0])


def make_train_step(cfg, mesh=None, *, optimizer: str = "adamw", peak_lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 10000, max_grad_norm: float = 1.0,
                    mode: str | None = None):
    """-> train_step(state, batch) -> (state, metrics): the loss's gradient,
    clipped, one optimizer step at `cosine_schedule`'s lr for the state's
    step, then the router-bias update of a sigmoid-routed MoE.  The
    metrics (0-d tensors on the model's device, but ``lr`` on the CPU) are
    JAX's: ``loss``, ``nll``, ``z_loss``, the MoE metrics but
    ``expert_load``, ``grad_norm`` and ``lr``.  With `mesh`, the state's
    model is sharded on it (`init_state`) and `batch` is the global batch,
    which every rank holds (module docstring).  For gradient accumulation
    use `make_accum_train_step`."""
    _optimizer(optimizer)
    hint = _hint(cfg, mesh)

    def train_step(state: dict, batch: dict):
        model = state["model"]
        _zero_grads(model)
        loss, metrics = loss_fn(model, batch, mode=mode, hint=hint)
        (loss / _world(hint)).backward()
        metrics = _mean_metrics(metrics, hint)
        leaves = lm.param_leaves(model)
        grads = _grads(leaves)
        metrics["grad_norm"] = _clip_by_global_norm(
            grads, max_grad_norm, _replicas(leaves) if hint else None)
        lr = cosine_schedule(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        metrics["lr"] = lr
        _update(optimizer, model, leaves, grads, state["opt"], lr)
        del grads
        _zero_grads(model)
        if cfg.moe is not None and cfg.moe.router_style == "sigmoid" and "expert_load" in metrics:
            _update_router_bias(model, metrics["expert_load"])
        metrics.pop("expert_load", None)
        state["step"] += 1
        return state, metrics

    return train_step


def make_accum_train_step(cfg, mesh=None, *, optimizer: str = "adamw", accum: int = 4,
                          peak_lr: float = 3e-4, warmup: int = 200, total_steps: int = 10000,
                          max_grad_norm: float = 1.0):
    """The gradient-accumulation step: the batch cut into `accum`
    microbatches along its first axis, their gradients summed in f32 (each
    divided by `accum`, as JAX's scan), then one clipped update.  As in
    JAX, the metrics are the mean ``loss``, ``grad_norm`` and ``lr``, and
    ``router_bias`` is not updated.  `mesh` as in `make_train_step`: each
    microbatch is split over the ranks as JAX splits it."""
    _optimizer(optimizer)
    hint = _hint(cfg, mesh)

    def train_step(state: dict, batch: dict):
        model = state["model"]
        leaves = lm.param_leaves(model)
        acc = [[torch.zeros_like(_local(p), dtype=F32) for p in leaf.params]
               if all(p.requires_grad for p in leaf.params) else None for leaf in leaves]
        losses = []
        for mb in zip(*(torch.chunk(v, accum, dim=0) for v in batch.values())):
            _zero_grads(model)
            loss, m = loss_fn(model, dict(zip(batch, mb)), hint=hint)
            (loss / _world(hint)).backward()
            with torch.no_grad():
                for a, gs in zip(acc, _grads(leaves)):
                    for ai, g in zip(a or (), gs or ()):
                        ai += g.to(F32) / accum
            losses.append(_mean_metrics({"loss": loss}, hint)["loss"])
        _zero_grads(model)
        gnorm = _clip_by_global_norm(acc, max_grad_norm, _replicas(leaves) if hint else None)
        lr = cosine_schedule(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        _update(optimizer, model, leaves, acc, state["opt"], lr)
        state["step"] += 1
        return state, {"loss": torch.mean(torch.stack(losses)), "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# The state as JAX's checkpoint holds it (train.checkpoint)
# ---------------------------------------------------------------------------

COUNT, STEP = "['opt']['count']", "['step']"  # Python ints in the state, int32 on disk


def jax_path(*parts: str) -> str:
    """JAX's key path of a leaf (`jax.tree_util.keystr`): dict keys quoted,
    list indices bare (``['params']['groups'][0]['attn']['w_q']``)."""
    keys = [k for part in parts for k in part.split(".")]
    return "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in keys)


def _shifted(placements) -> tuple:
    """A layer's placements on the stacked leaf (the layer axis first)."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(pl.dim + 1) if pl.is_shard() else pl for pl in placements)


def _leaf_layout(leaf):
    """The `rules.NamedSharding` of a leaf in JAX's stacked shape; None off
    a mesh."""
    p = leaf.params[0]
    mesh = getattr(p, "device_mesh", None)
    if mesh is None:
        return None
    return rules.NamedSharding(mesh, _shifted(p.placements) if leaf.stacked
                               else tuple(p.placements))


def _as_leaf(local: torch.Tensor, layout):
    """A leaf's local part in JAX's shape as a DTensor on its mesh, or a
    `rules.SpecPart` (`rules.NamedSharding.wrap`); as is off a mesh."""
    return local if layout is None else layout.wrap(local)


def _opt_entries(state: dict, leaves) -> list:
    """(JAX path, the state tensor, its `rules.NamedSharding` or None) of
    the optimizer's state in JAX's order: AdamW ``m`` then ``v`` per leaf;
    Adafactor ``f`` a list parallel to the leaves, each ``vc`` before
    ``vr``; on a mesh each in `rules.opt_state_specs`' layout."""
    opt = state["opt"]
    optimizer = "adamw" if "m" in opt else "adafactor"
    mesh = getattr(state["model"], "mesh", None)
    specs = _layouts(state["model"], leaves, optimizer)[1]

    def layout(*keys):  # the spec under `keys` in `specs`, as a NamedSharding
        if specs is None:
            return None
        spec = specs
        for k in keys:
            spec = spec[k]
        return rules.NamedSharding(mesh, spec)

    if optimizer == "adamw":
        return [(jax_path("opt", key, lf.name), opt[key][lf.name], layout(key, lf.name))
                for key in ("m", "v") for lf in leaves]
    return [(jax_path("opt", "f", str(i), k), opt["f"][lf.name][k], layout("f", i, k))
            for i, lf in enumerate(leaves) for k in sorted(opt["f"][lf.name])]


def state_tensors(state: dict) -> dict:
    """The state's tensors in the order and under the names of JAX's
    checkpoint: ``['opt']['count']``, the optimizer's state, each parameter
    leaf (`lm.param_leaves`, a run of layers stacked: a copy), then
    ``['step']``; the counters as 0-d int32 CPU tensors.  On a mesh each
    tensor is a DTensor of its layout (a parameter's, or the state's
    ZeRO-1 spec: a `rules.SpecPart` where DTensor cannot say it), the
    counters plain."""
    leaves = lm.param_leaves(state["model"])
    out = {COUNT: torch.tensor(state["opt"]["count"], dtype=torch.int32)}
    for name, t, layout in _opt_entries(state, leaves):
        out[name] = _as_leaf(t, layout)
    for lf in leaves:
        local = [_local(p) for p in lf.params]
        out[jax_path("params", lf.name)] = _as_leaf(
            torch.stack(local) if lf.stacked else local[0], _leaf_layout(lf))
    out[STEP] = torch.tensor(state["step"], dtype=torch.int32)
    return out


def state_names(state: dict) -> list:
    """The names of `state_tensors`, in order (nothing copied)."""
    leaves = lm.param_leaves(state["model"])
    return ([COUNT] + [name for name, _, _ in _opt_entries(state, leaves)]
            + [jax_path("params", lf.name) for lf in leaves] + [STEP])


def _part(src, layout):
    """The local part of `src` (a full tensor, or a DTensor or
    `rules.SpecPart` whose local part is taken as it is) for a destination
    of `layout` (a `rules.NamedSharding` or None)."""
    from torch.distributed.tensor import DTensor

    if isinstance(src, DTensor):
        return src.to_local()
    if isinstance(src, rules.SpecPart):
        return src.local
    return src if layout is None else layout.part(src)


@torch.no_grad()
def load_state_tensors(state: dict, tensors: dict) -> None:
    """Write `tensors` (named as `state_tensors` names them: full tensors,
    or DTensors and `rules.SpecPart`s of the state's layouts) into `state`: each copied into its
    place (a stacked leaf split over its layers), the counters set."""
    if list(tensors) != state_names(state):
        raise ValueError("load_state_tensors: the names do not match the state's")
    leaves = lm.param_leaves(state["model"])
    for name, t, layout in _opt_entries(state, leaves):
        t.copy_(_part(tensors[name], layout))
    for lf in leaves:
        layout = _leaf_layout(lf)
        src = _part(tensors[jax_path("params", lf.name)], layout)
        for p, s in zip(lf.params, src if lf.stacked else [src]):
            _local(p).copy_(s)
    state["step"] = int(tensors[STEP])
    state["opt"]["count"] = int(tensors[COUNT])
