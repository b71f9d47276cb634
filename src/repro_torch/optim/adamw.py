"""Optimizers as plain functions on named tensors (the counterpart of
`repro.optim.adamw`).

The parameters come as `models.lm.param_leaves`: JAX's parameter tree,
each leaf of a run of layers stacked over the run in JAX and one tensor a
layer in the port.  The state is kept by leaf name in JAX's layout (a
stacked leaf's state has the leading layer axis), and the arithmetic is
JAX's, step for step, in f32:

  AdamW: f32 first and second moments, JAX's bias correction
      (``1 - b ** count`` in f32), weight decay for leaves of rank 2 and
      above, never ``router_bias``;
  Adafactor (Shazeer & Stern, arXiv:1804.04235): a factored second moment
      (row and column means of g^2 + eps) for leaves of rank 2 and above,
      no first moment, and update clipping (the RMS of a leaf's step at
      most `clip`).

Rank is the stacked leaf's, as in JAX: a layer's norm scale (d,) is a
(L, d) leaf, so AdamW decays it and Adafactor factors it over the layer
axis, and a leaf's update RMS runs over all its layers.  ``router_bias``
is never trained: `train.step` moves it by its own rule.  Both updates
write the parameters and the state in place (JAX returns new trees), one
tensor at a time, so their f32 scratch is a few copies of the largest
layer tensor, never of the model.  `torch.optim.AdamW` is not used: it
rounds its update differently.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _trainable(leaf) -> bool:
    return "router_bias" not in leaf.name.split(".")  # updated by the balance rule


def _rank(leaf) -> int:
    """The rank of the leaf in JAX's tree (a stacked leaf has the layer axis)."""
    return leaf.params[0].ndim + int(leaf.stacked)


def _decay(leaf) -> bool:
    """JAX's `_decay_mask`: weights of rank 2 and above, never router_bias."""
    return _trainable(leaf) and _rank(leaf) >= 2


def _shape(leaf) -> tuple:
    p = leaf.params[0]
    return (len(leaf.params), *p.shape) if leaf.stacked else tuple(p.shape)


def _slices(leaf, t: torch.Tensor) -> list:
    """A state tensor of the leaf's JAX shape -> one view a parameter."""
    return list(t) if leaf.stacked else [t]


def _apply(p: torch.Tensor, step: torch.Tensor, lr) -> None:
    """p <- (p.f32 - lr * step) rounded to p's dtype, as JAX's."""
    p.copy_(p.to(F32) - lr * step)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(leaves) -> dict:
    """``{"m": {leaf: f32 zeros}, "v": {leaf: f32 zeros}, "count": 0}``."""
    def zeros(leaf):
        return torch.zeros(_shape(leaf), dtype=F32, device=leaf.params[0].device)

    return {"m": {lf.name: zeros(lf) for lf in leaves},
            "v": {lf.name: zeros(lf) for lf in leaves}, "count": 0}


@torch.no_grad()
def adamw_update(leaves, grads, state: dict, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.1) -> None:
    """One AdamW step in place: `grads` is one list of tensors a leaf,
    parallel to the leaf's parameters (None for ``router_bias``); `lr` a
    0-d f32 tensor (`schedule.cosine_schedule`)."""
    state["count"] += 1
    c = torch.tensor(state["count"], dtype=F32)
    bc1 = 1.0 - b1**c
    bc2 = 1.0 - b2**c
    for leaf, gs in zip(leaves, grads):
        if not _trainable(leaf):
            continue
        ms, vs = _slices(leaf, state["m"][leaf.name]), _slices(leaf, state["v"][leaf.name])
        for p, g, m, v in zip(leaf.params, gs, ms, vs):
            gf = g.to(F32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            del gf
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            if _decay(leaf):
                step.add_(wd * p.to(F32))
            _apply(p, step, lr)


# ---------------------------------------------------------------------------
# Adafactor: factored v, no momentum
# ---------------------------------------------------------------------------


def adafactor_init(leaves) -> dict:
    """``{"f": {leaf: {"vr", "vc"} (rank >= 2) or {"v"}}, "count": 0}``,
    f32 zeros of JAX's shapes."""

    def factored(leaf):
        shape, dev = _shape(leaf), leaf.params[0].device
        z = dict(dtype=F32, device=dev)
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], **z),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], **z)}
        return {"v": torch.zeros(shape, **z)}

    return {"f": {lf.name: factored(lf) for lf in leaves}, "count": 0}


def _units(leaf, gs, f: dict) -> list:
    """The parts of a leaf whose Adafactor math needs nothing of the others
    but the RMS: (the parameters' indices, a function giving the part's f32
    gradient, the part's state views, whether the part is stacked).  A layer is a part where JAX's
    reductions stay within it (rank of the layer's tensor 2 and above, or
    an unfactored leaf); a factored leaf of one-dimensional layers (norm
    scales, biases) mixes its layers (column means, the denominator) and is
    stacked whole (it is small)."""
    if not leaf.stacked:
        return [([0], lambda: gs[0].to(F32), f, False)]
    if "vr" in f and leaf.params[0].ndim == 1:
        return [(range(len(gs)), lambda: torch.stack([g.to(F32) for g in gs]), f, True)]
    return [([i], (lambda g=g: g.to(F32)), {k: t[i] for k, t in f.items()}, False)
            for i, g in enumerate(gs)]


def _adafactor_step(gf: torch.Tensor, f: dict, eps: float) -> torch.Tensor:
    """The unclipped step of a part from its updated state."""
    if "vr" in f:
        vr, vc = f["vr"], f["vc"]
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
        vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
        return gf * torch.rsqrt(vhat.add_(eps))
    return gf * torch.rsqrt(f["v"] + eps)


@torch.no_grad()
def adafactor_update(leaves, grads, state: dict, *, lr, eps: float = 1e-30, clip: float = 1.0,
                     wd: float = 0.0) -> None:
    """One Adafactor step in place (`grads` and `lr` as in `adamw_update`).
    A leaf's step is computed twice, once for its RMS and once to apply
    it, so that no more than a layer's step exists at a time."""
    for leaf, gs in zip(leaves, grads):
        adafactor_leaf_update(leaf, gs, state, lr=lr, eps=eps, clip=clip, wd=wd)
    state["count"] += 1


@torch.no_grad()
def adafactor_leaf_update(leaf, gs, state: dict, *, lr, eps: float = 1e-30, clip: float = 1.0,
                          wd: float = 0.0) -> None:
    """`adafactor_update`'s step of one leaf, at the state's count + 1."""
    if not _trainable(leaf):
        return
    c = torch.tensor(state["count"] + 1, dtype=F32)
    b2 = 1.0 - c**-0.8
    units = _units(leaf, gs, state["f"][leaf.name])
    sq = torch.zeros((), dtype=F32, device=leaf.params[0].device)
    n = 0
    for _, grad, f, _ in units:
        gf = grad()
        g2 = gf * gf + eps
        if "vr" in f:
            f["vr"].mul_(b2).add_((1 - b2) * torch.mean(g2, dim=-1))
            f["vc"].mul_(b2).add_((1 - b2) * torch.mean(g2, dim=-2))
        else:
            f["v"].mul_(b2).add_((1 - b2) * g2)
        del g2
        step = _adafactor_step(gf, f, eps)
        sq += torch.sum(step * step)
        n += step.numel()
    rms = torch.sqrt(sq / n + eps)
    div = torch.clamp(rms / clip, min=1.0)
    for idx, grad, f, whole in units:
        step = _adafactor_step(grad(), f, eps) / div
        steps = list(step) if whole else [step]
        for i, st in zip(idx, steps):
            if wd and _decay(leaf):
                st = st + wd * leaf.params[i].to(F32)
            _apply(leaf.params[i], st, lr)
