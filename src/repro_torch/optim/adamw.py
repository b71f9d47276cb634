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
write the parameters and the state in place (JAX returns new trees), a
layer at a time, so their f32 scratch is a few copies of the largest
layer tensor (Adafactor's of a piece of it, `pieces`), never of the model.  `torch.optim.AdamW` is not used: it
rounds its update differently.

The leaves are the parameters' local parts and the state lies in ZeRO-1's
layout (``zero=``, `optim.zero.zero_layout`; `sharding.rules.opt_state_specs`):
each rank holds its block of every state tensor, updates its slice of each
parameter and the slices are gathered back (`zero.ZeroLeaf.rebuild`).  Off
a mesh the layout has no axes, so the block is the whole state and the
slice the whole parameter.  AdamW is elementwise, so each element's
arithmetic is the one above.  Adafactor's row and column means sum the
rank's part of g^2 + eps and merge the sums over the mesh axes that split
the reduced dimension, divided by its global length; its factors are
updated in their blocks and gathered over ZeRO's axes to the parameter's
layout, where the denominator's mean over rows merges the same way; a
leaf's update RMS sums each slice's squares once (over the ranks that
update it) and one all-reduce serves every leaf.  No leaf is gathered
whole.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from ..sharding import comm
from . import zero as zero_mod

F32 = torch.float32


def _trainable(leaf) -> bool:
    return "router_bias" not in leaf.name.split(".")  # updated by the balance rule


def _rank(leaf) -> int:
    """The rank of the leaf in JAX's tree (a stacked leaf has the layer axis)."""
    return leaf.params[0].ndim + int(leaf.stacked)


def _decay(leaf) -> bool:
    """JAX's `_decay_mask`: weights of rank 2 and above, never router_bias."""
    return _trainable(leaf) and _rank(leaf) >= 2


def _layout(leaves, zero: dict | None, optimizer: str) -> dict:
    """`zero`, or the layout of `leaves` off a mesh (every leaf whole)."""
    return zero_mod.zero_layout(leaves, None, None, optimizer) if zero is None else zero


def _apply(p: torch.Tensor, step: torch.Tensor, lr) -> None:
    """p <- (p.f32 - lr * step) rounded to p's dtype, as JAX's."""
    p.copy_(p.to(F32) - lr * step)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _zeros(shape, leaf) -> torch.Tensor:
    return torch.zeros(shape, dtype=F32, device=leaf.params[0].device)


def adamw_init(leaves, zero: dict | None = None) -> dict:
    """``{"m": {leaf: f32 zeros}, "v": {leaf: f32 zeros}, "count": 0}``,
    each the rank's block under `zero` (name -> `zero.ZeroLeaf`; None: off
    a mesh, JAX's shapes)."""
    zero = _layout(leaves, zero, "adamw")

    def zeros(leaf, key):
        return _zeros(zero[leaf.name].state[key][1], leaf)

    return {"m": {lf.name: zeros(lf, "m") for lf in leaves},
            "v": {lf.name: zeros(lf, "v") for lf in leaves}, "count": 0}


def _adamw_one(p, g, m, v, *, decay: bool, lr, b1, b2, eps, wd, bc1, bc2) -> None:
    gf = g.to(F32)
    m.mul_(b1).add_((1 - b1) * gf)
    v.mul_(b2).add_((1 - b2) * gf * gf)
    del gf
    step = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
    if decay:
        step.add_(wd * p.to(F32))
    _apply(p, step, lr)


@torch.no_grad()
def adamw_update(leaves, grads, state: dict, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.1, zero: dict | None = None) -> None:
    """One AdamW step in place: `grads` is one list of tensors a leaf,
    parallel to the leaf's parameters (None for ``router_bias``); `lr` a
    0-d f32 tensor (`schedule.cosine_schedule`); each rank's slice of the
    local parts under `zero` (`adamw_init`; module docstring)."""
    zero = _layout(leaves, zero, "adamw")
    state["count"] += 1
    c = torch.tensor(state["count"], dtype=F32)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, bc1=1.0 - b1**c, bc2=1.0 - b2**c)
    for leaf, gs in zip(leaves, grads):
        if not _trainable(leaf):
            continue
        m, v = state["m"][leaf.name], state["v"][leaf.name]
        z = zero[leaf.name]
        units, gu, inner = z.units(leaf.params), z.units(gs), z.inner
        ms, vs = z.state_units(m), z.state_units(v)
        for j, i in enumerate(z.mine(len(units))):
            _adamw_one(zero_mod.part(units[i], inner), zero_mod.part(gu[i], inner), ms[j], vs[j],
                       decay=_decay(leaf), **kw)
        z.rebuild(units)


# ---------------------------------------------------------------------------
# Adafactor: factored v, no momentum
# ---------------------------------------------------------------------------


def adafactor_init(leaves, zero: dict | None = None) -> dict:
    """``{"f": {leaf: {"vr", "vc"} (rank >= 2) or {"v"}}, "count": 0}``,
    f32 zeros, each the rank's block under `zero` (as in `adamw_init`)."""
    zero = _layout(leaves, zero, "adafactor")

    def factored(leaf):
        return {k: _zeros(shape, leaf) for k, (_, shape) in zero[leaf.name].state.items()}

    return {"f": {lf.name: factored(lf) for lf in leaves}, "count": 0}


def _merge(x: torch.Tensor, group) -> torch.Tensor:
    """A partial sum summed over `group` (None: the rank holds it whole)."""
    return x if group is None else comm.all_reduce(x, group)


# the most elements of a piece (`pieces`): 64 MiB of f32 scratch
PIECE = 2**24


def pieces(shape) -> list:
    """Index keys that cut a tensor of `shape` into pieces whose f32 scratch
    stays small: each slice along the first dimension of one of three or
    more dimensions (an expert stack's experts: Adafactor's factored
    reductions stay within each), blocks of whole rows of a matrix, or the
    whole of a vector or a scalar (``...``)."""
    if len(shape) >= 3:
        return list(range(shape[0]))
    if len(shape) < 2:
        return [...]
    rows = max(1, PIECE // max(shape[1], 1))
    return [slice(a, a + rows) for a in range(0, shape[0], rows)]


def _sq_sums(gu: list, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank's sums of g^2 + eps over each gradient unit's last and
    second-to-last dimensions, stacked over the units: the row and column
    means' partial sums, a piece at a time (`pieces`)."""
    rows, cols = [], []
    for g in gu:
        r, c = [], []
        for key in pieces(g.shape):
            g2 = torch.square(g[key].to(F32)).add_(eps)
            r.append(g2.sum(dim=-1))
            c.append(g2.sum(dim=-2))
            del g2
        if g.ndim >= 3:
            rows.append(torch.stack(r))
            cols.append(torch.stack(c))
        else:  # a matrix's row blocks: their column sums added
            rows.append(torch.cat(r))
            cols.append(functools.reduce(torch.add, c))
    return torch.stack(rows), torch.stack(cols)


def _factors(z, gu: list, f: dict, b2, eps: float):
    """A factored leaf's ``vr`` and ``vc`` blocks updated from the rank's
    gradient units -> (vr, vc, denom) in the parameter's layout, with the
    unit axis whole."""
    rows, cols = _sq_sums(gu, eps)
    R, C = z.shape[-2], z.shape[-1]
    means = {"vr": _merge(rows, z.last) / C, "vc": _merge(cols, z.prev) / R}
    full = {}
    for key, mean in means.items():
        cuts = z.state[key][0]
        t = z.state_units(f[key])
        t.mul_(b2).add_((1 - b2) * zero_mod.part(mean, cuts))
        full[key] = zero_mod.gather(t, cuts, z.mesh)
    denom = torch.clamp(_merge(full["vr"].sum(dim=-1), z.prev) / R, min=eps)
    return full["vr"], full["vc"], denom


def _factored_step(g: torch.Tensor, vr, vc, denom, eps: float) -> torch.Tensor:
    vhat = vr[..., None] * vc[..., None, :] / denom[..., None, None]
    return g.to(F32) * torch.rsqrt(vhat.add_(eps))


def _zero_steps(g: torch.Tensor, i: int, z, fac, v, eps: float):
    """The unclipped step of the rank's slice of unit `i`, a piece at a
    time (`pieces`): (the piece's index key into the slice, its step)
    each."""
    inner = z.inner
    gs = zero_mod.part(g, inner)
    if fac is None:
        yield ..., gs.to(F32) * torch.rsqrt(v[i] + eps)
        return
    vr, vc, denom = fac
    nd = gs.ndim
    vr_s = zero_mod.part(vr[i], [s for s in inner if s.dim < nd - 1])
    vc_s = zero_mod.part(vc[i], [s._replace(dim=nd - 2) if s.dim == nd - 1 else s
                                 for s in inner if s.dim != nd - 2])
    d_s = zero_mod.part(denom[i], [s for s in inner if s.dim < nd - 2])
    for key in pieces(gs.shape):
        if nd >= 3:
            yield key, _factored_step(gs[key], vr_s[key], vc_s[key], d_s[key], eps)
        else:  # a block of the matrix's rows
            yield key, _factored_step(gs[key], vr_s[key], vc_s, d_s, eps)


@torch.no_grad()
def adafactor_update(leaves, grads, state: dict, *, lr, eps: float = 1e-30, clip: float = 1.0,
                     wd: float = 0.0, zero: dict | None = None) -> None:
    """One Adafactor step in place (`grads`, `lr` and `zero` as in
    `adamw_update`): every leaf's state and squared step first, one
    all-reduce of the squares on a mesh, then every leaf's slices applied
    and rebuilt.  A slice's step is computed twice, once for the RMS and
    once to apply it, so that no more than a piece of it exists at a time."""
    zero = _layout(leaves, zero, "adafactor")
    c = torch.tensor(state["count"] + 1, dtype=F32)
    b2 = 1.0 - c**-0.8
    work, sqs = [], []
    for leaf, gs in zip(leaves, grads):
        if not _trainable(leaf):
            continue
        z, f = zero[leaf.name], state["f"][leaf.name]
        gu = z.units(gs)
        fac, v = None, None
        if "vr" in f:
            fac = _factors(z, gu, f, b2, eps)
        else:
            v = z.state_units(f["v"])
            for j, g in enumerate(gu):
                v[j].mul_(b2).add_((1 - b2) * torch.square(g.to(F32)).add_(eps))
        sq = torch.zeros((), dtype=F32, device=leaf.params[0].device)
        for i in z.mine(len(gu)):
            for _, st in _zero_steps(gu[i], i, z, fac, v, eps):
                sq += torch.sum(torch.square(st))
        sqs.append(sq / z.replicas)
        work.append((leaf, gs, z, fac, v))
    state["count"] += 1
    if not work:
        return
    total = torch.stack(sqs)
    if work[0][2].mesh is not None:
        total = comm.all_reduce(total, dist.group.WORLD)
    for (leaf, gs, z, fac, v), sq in zip(work, total):
        rms = torch.sqrt(sq / math.prod(z.shape) + eps)
        div = torch.clamp(rms / clip, min=1.0)
        units, gu = z.units(leaf.params), z.units(gs)
        for i in z.mine(len(units)):
            p = zero_mod.part(units[i], z.inner)
            for key, st in _zero_steps(gu[i], i, z, fac, v, eps):
                pj = p[key]
                st = st / div
                if wd and _decay(leaf):
                    st = st + wd * pj.to(F32)
                _apply(pj, st, lr)
        z.rebuild(units)
        if units[0] is not leaf.params[0]:  # a stacked copy: its layers back
            for p, row in zip(leaf.params, units[0]):
                p.copy_(row)
