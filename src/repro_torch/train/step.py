"""The train step and the loss (the counterpart of `repro.train.step`).

f32 loss over the model's logits, global-norm clipping, AdamW or
Adafactor, microbatch gradient accumulation, the MoE aux and z losses, and
DeepSeek's aux-free update of the sigmoid router's ``router_bias``.

The state is ``{"model": LM, "opt": the optimizer's state, "step": int}``.
A step updates the model's parameters and the optimizer's state in place
and returns the same dict with ``step`` one higher (JAX returns a new,
donated state).  These functions take no mesh: sharding waits for ROADMAP
Queue 1 item 8 step 9.  `state_tensors` lists a state's named tensors in a
fixed order for `train.checkpoint`, and `load_state_tensors` writes such a
list back.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..models import lm
from ..models.layers import softmax_cross_entropy
from ..optim import adafactor_init, adafactor_update, adamw_init, adamw_update, cosine_schedule

OPTIMIZERS = {"adamw": (adamw_init, adamw_update), "adafactor": (adafactor_init, adafactor_update)}
F32 = torch.float32


def _optimizer(name: str):
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; expected one of {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


def init_state(cfg, *, optimizer: str = "adamw", device=None, generator=None,
               model: lm.LM | None = None) -> dict:
    """A fresh training state: `cfg`'s model drawn on `device` (None =
    "cuda") from `generator`, or `model` when given (e.g. one carried across
    by `convert.from_jax_lm_params`), made trainable (`lm.make_trainable`),
    with zero optimizer state at step 0."""
    init, _ = _optimizer(optimizer)
    if model is None:
        model = lm.LM(cfg, device=resolve_device(device), generator=generator)
    lm.make_trainable(model)
    return {"model": model, "opt": init(lm.param_leaves(model)), "step": 0}


def loss_fn(model: lm.LM, batch: dict, *, mode: str | None = None):
    """-> (loss, metrics) of `batch` (``tokens`` (B, S), optional ``labels``,
    and the arch's context input): the labels default to the tokens shifted
    by one (the last repeated); the MoE aux and z losses are added with the
    config's weights.  `mode` reaches the attention kernel."""
    cfg = model.cfg
    tokens = batch["tokens"].to(model.device)
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, metrics = lm.forward(model, tokens, extras=extras or None, mode=mode)
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    loss, lmm = softmax_cross_entropy(logits, labels.to(model.device), z_loss=cfg.z_loss)
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
    as JAX's)."""
    out = []
    for leaf in leaves:
        if not all(p.requires_grad for p in leaf.params):
            out.append(None)
            continue
        out.append([p.grad if p.grad is not None else torch.zeros_like(p) for p in leaf.params])
    return out


def _global_norm(grads) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(F32))) for gs in grads if gs for g in gs)
    return torch.sqrt(sq)


@torch.no_grad()
def _clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale every gradient in place by ``min(1, max_norm / norm)``, in f32
    and rounded back to its dtype, as JAX's -> the norm before clipping."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for gs in grads:
        for g in gs or ():
            g.copy_(g.to(F32) * scale)
    return norm


@torch.no_grad()
def _update_router_bias(model: lm.LM, expert_load: torch.Tensor, gamma: float = 1e-3) -> None:
    """DeepSeek-V3 aux-free balancing: push every ``router_bias`` against
    the over-loaded experts by ``gamma * sign(load - mean(load))``."""
    err = expert_load - torch.mean(expert_load)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "router_bias":
            p.copy_(p - gamma * torch.sign(err))


def _zero_grads(model: lm.LM) -> None:
    for p in model.parameters():
        p.grad = None


def make_train_step(cfg, *, optimizer: str = "adamw", peak_lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 10000, max_grad_norm: float = 1.0,
                    mode: str | None = None):
    """-> train_step(state, batch) -> (state, metrics): the loss's gradient,
    clipped, one optimizer step at `cosine_schedule`'s lr for the state's
    step, then the router-bias update of a sigmoid-routed MoE.  The
    metrics (0-d tensors on the model's device, but ``lr`` on the CPU) are
    JAX's: ``loss``, ``nll``, ``z_loss``, the MoE metrics but
    ``expert_load``, ``grad_norm`` and ``lr``.  For gradient accumulation
    use `make_accum_train_step`."""
    _, update = _optimizer(optimizer)

    def train_step(state: dict, batch: dict):
        model = state["model"]
        _zero_grads(model)
        loss, metrics = loss_fn(model, batch, mode=mode)
        loss.backward()
        leaves = lm.param_leaves(model)
        grads = _grads(leaves)
        metrics["grad_norm"] = _clip_by_global_norm(grads, max_grad_norm)
        lr = cosine_schedule(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        metrics["lr"] = lr
        update(leaves, grads, state["opt"], lr=lr)
        del grads
        _zero_grads(model)
        if cfg.moe is not None and cfg.moe.router_style == "sigmoid" and "expert_load" in metrics:
            _update_router_bias(model, metrics["expert_load"])
        metrics.pop("expert_load", None)
        state["step"] += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_accum_train_step(cfg, *, optimizer: str = "adamw", accum: int = 4,
                          peak_lr: float = 3e-4, warmup: int = 200, total_steps: int = 10000,
                          max_grad_norm: float = 1.0):
    """The gradient-accumulation step: the batch cut into `accum`
    microbatches along its first axis, their gradients summed in f32 (each
    divided by `accum`, as JAX's scan), then one clipped update.  As in
    JAX, the metrics are the mean ``loss``, ``grad_norm`` and ``lr``, and
    ``router_bias`` is not updated."""
    _, update = _optimizer(optimizer)

    def train_step(state: dict, batch: dict):
        model = state["model"]
        leaves = lm.param_leaves(model)
        acc = [[torch.zeros_like(p, dtype=F32) for p in leaf.params]
               if all(p.requires_grad for p in leaf.params) else None for leaf in leaves]
        losses = []
        for mb in zip(*(torch.chunk(v, accum, dim=0) for v in batch.values())):
            _zero_grads(model)
            loss, _ = loss_fn(model, dict(zip(batch, mb)))
            loss.backward()
            with torch.no_grad():
                for a, gs in zip(acc, _grads(leaves)):
                    for ai, g in zip(a or (), gs or ()):
                        ai += g.to(F32) / accum
            losses.append(loss.detach())
        _zero_grads(model)
        gnorm = _clip_by_global_norm(acc, max_grad_norm)
        lr = cosine_schedule(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        update(leaves, acc, state["opt"], lr=lr)
        state["step"] += 1
        return state, {"loss": torch.mean(torch.stack(losses)), "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# The state as named tensors (train.checkpoint)
# ---------------------------------------------------------------------------

_COUNTERS = ("step", "opt.count")  # Python ints in the state, int32 on disk


def _flat(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = v


def state_tensors(state: dict) -> dict:
    """The state's named tensors in a fixed order: ``params.<name>`` in the
    model's order, ``opt.<...>`` in the optimizer state's, then ``step``;
    the counters (``opt.count``, ``step``) as 0-d int32 CPU tensors."""
    out = {f"params.{n}": p for n, p in state["model"].named_parameters()}
    _flat("opt.", state["opt"], out)
    out["step"] = state["step"]
    return {k: torch.tensor(v, dtype=torch.int32) if k in _COUNTERS else v
            for k, v in out.items()}


@torch.no_grad()
def load_state_tensors(state: dict, tensors: dict) -> None:
    """Write `tensors` (named as `state_tensors` names them) into `state`:
    each tensor copied into its place, the counters set."""
    targets = state_tensors(state)
    if list(tensors) != list(targets):
        raise ValueError("load_state_tensors: the names do not match the state's")
    for name, t in targets.items():
        if name not in _COUNTERS:
            t.copy_(tensors[name])
    state["step"] = int(tensors["step"])
    state["opt"]["count"] = int(tensors["opt.count"])
