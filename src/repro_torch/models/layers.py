"""Shared neural-net primitives: norms, activations, RoPE, initializers, MLPs
(the counterpart of `repro.models.layers`).

Parameters live in `nn.ParameterDict`s named as the JAX package's pytree
leaves (``w_q``, ``scale``, ...), so a JAX parameter tree maps onto a
module's ``state_dict`` name by name (`convert.from_jax_lm_params`).
Weights keep the JAX layout ``(in, out)`` and are applied as ``x @ w``.
Parameters are made frozen (``requires_grad=False``), so that serving
builds no graph; `lm.make_trainable` turns them on for training.
`softmax_cross_entropy` is the training loss, `softmax_cross_entropy_vp`
the same function over logits split over the vocabulary.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import comm

# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, gemma_style: bool = False
) -> torch.Tensor:
    """RMSNorm, computed in f32.  gemma_style applies (1 + w) scaling."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(
    x: torch.Tensor, p, *, eps: float, kind: str = "rms", gemma_style: bool = False
) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], eps=eps)
    return rms_norm(x, p["scale"], eps=eps, gemma_style=gemma_style)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_norm(
    d: int, *, kind: str = "rms", gemma_style: bool = False, device=None
) -> nn.ParameterDict:
    # gemma stores w with effective scale (1 + w): init 0; plain RMS init 1
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "layernorm":
        return nn.ParameterDict(
            {"scale": _param(torch.ones(d, **f32)), "bias": _param(torch.zeros(d, **f32))}
        )
    scale = torch.zeros(d, **f32) if gemma_style else torch.ones(d, **f32)
    return nn.ParameterDict({"scale": _param(scale)})


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation layout)
# ---------------------------------------------------------------------------


def rope_frequencies(rotary_dim: int, *, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (rotary_dim // 2,) in f32."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    return 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float, rotary_dim: int | None = None
) -> torch.Tensor:
    """x (..., S, H, head_dim): rotates the first `rotary_dim` channels.
    positions: broadcastable to (..., S); absolute token positions.  The
    angles and the rotation are f32; the result is cast back to x's dtype."""
    head_dim = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else head_dim
    inv_freq = rope_frequencies(rd, theta=theta, device=x.device)
    ang = positions.to(torch.float32)[..., None, None] * inv_freq  # (..., S, 1, rd//2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < head_dim else out


# ---------------------------------------------------------------------------
# Linear / embedding initializers
# ---------------------------------------------------------------------------


def _trunc_normal(shape, *, device, generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)


def dense_init(
    shape: tuple[int, ...], *, dtype, device=None, generator=None, scale: float | None = None
) -> nn.Parameter:
    """Truncated-normal (at +-3 std) fan-in init, drawn in f32 and then cast.
    A stack of matrices (the MoE experts, (E, D, F)) is drawn a matrix at a
    time, so that its f32 draw never exists whole: arctic-480b's 128 experts
    are 8.9 GB a stack in bf16, 17.8 GB in f32."""
    if device is not None and torch.device(device).type == "meta":  # shapes only
        return _param(torch.empty(shape, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if len(shape) <= 2:
        return _param((_trunc_normal(shape, device=device, generator=generator) * std).to(dtype))
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _trunc_normal(shape[1:], device=device, generator=generator) * std
    return _param(out)


def embed_init(vocab: int, d: int, *, dtype, device=None, generator=None) -> nn.Parameter:
    t = _trunc_normal((vocab, d), device=device, generator=generator) * 0.02
    return _param(t.to(dtype))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(
    d: int, f: int, *, style: str, dtype, device=None, generator=None
) -> nn.ParameterDict:
    """style: 'glu' (gate + up + down) or 'plain' (up + down, with biases)."""
    init = dict(dtype=dtype, device=device, generator=generator)
    if style == "glu":
        return nn.ParameterDict(
            {
                "w_gate": dense_init((d, f), **init),
                "w_up": dense_init((d, f), **init),
                "w_down": dense_init((f, d), **init),
            }
        )
    f32 = dict(dtype=torch.float32, device=device)
    return nn.ParameterDict(
        {
            "w_up": dense_init((d, f), **init),
            "b_up": _param(torch.zeros(f, **f32)),
            "w_down": dense_init((f, d), **init),
            "b_down": _param(torch.zeros(d, **f32)),
        }
    )


def tp_rows(x: torch.Tensor, hint) -> torch.Tensor:
    """The input rows of a tensor-parallel product under `hint`'s "tp"
    layout: the sequence gathered (JAX's ``"act"`` slices); in decode
    (``hint.decode``) every rank of the model axis holds them whole."""
    return x if hint.decode else comm.gather_dim(x, 1, hint.seq_group)


def tp_sum(y: torch.Tensor, hint) -> torch.Tensor:
    """A row-parallel product's partial sums under `hint`'s "tp" layout:
    reduce-scattered back to the sequence slices; in decode summed over the
    model axis in f32 and rounded once (S = 1: nothing to scatter, and the
    rows are few)."""
    if hint.decode:
        return comm.sum_over(y.float(), hint.seq_group).to(y.dtype)
    return comm.scatter_dim(y, 1, hint.seq_group)


def apply_mlp(p, x: torch.Tensor, *, act: str, style: str, hint=None) -> torch.Tensor:
    """The MLP of `x` (..., D).  Under the tensor-parallel layout of `hint`
    (`sharding.rules.model_layout`) `x` is the rank's slice of the sequence
    (B, S / m, D) and `p` holds the rank's slice of the FFN hidden (JAX's
    ``"ffn"``): the column-parallel ``w_gate`` / ``w_up`` run on the
    sequence gathered, the row-parallel ``w_down``'s partial sums are
    reduce-scattered back to the slices, and ``b_down`` is added once,
    after (in decode the rows are whole and the partial sums summed over
    the axis: `tp_rows`, `tp_sum`).  Under "sp" and "splitk" the rows run
    through the whole MLP."""
    a = ACTIVATIONS[act]
    tp = getattr(hint, "layout", None) == "tp"
    if tp:
        x = tp_rows(x, hint)
    if style == "glu":
        y = (a(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
        return tp_sum(y, hint) if tp else y
    h = a(linear(x, p["w_up"], p["b_up"]))
    if not tp:
        return linear(h, p["w_down"], p["b_down"])
    y = tp_sum(h @ p["w_down"], hint)
    return y + p["b_down"].to(y.dtype)


# ---------------------------------------------------------------------------
# Cross-entropy loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0
) -> tuple[torch.Tensor, dict]:
    """Mean cross-entropy, as JAX's: logits (..., V) of any float dtype,
    labels (...) of any integer dtype -> (loss, metrics).  The reduction is
    f32 with the row max detached (JAX's ``stop_gradient``); ``nll`` is the
    mean negative log-likelihood and, when `z_loss` is set, ``z_loss`` is
    ``z_loss * mean(lse ** 2)``, added to the loss."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    sum_exp = torch.sum(torch.exp(lf - m), dim=-1)
    lse = torch.log(sum_exp) + m[..., 0]
    ll = torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    loss = torch.mean(lse - ll)
    metrics = {"nll": loss}
    if z_loss:
        zl = z_loss * torch.mean(torch.square(lse))
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def softmax_cross_entropy_vp(
    logits: torch.Tensor, labels: torch.Tensor, group, *, z_loss: float = 0.0
) -> tuple[torch.Tensor, dict]:
    """`softmax_cross_entropy` over logits split over the vocabulary: this
    rank's shard (..., V / m) of the ranks of `group` in rank order (JAX's
    ``"logits"`` layout), labels (...) whole.  The same function, the
    (B, S, V) logits never gathered: the detached row max is the ranks'
    maximum (`comm.max_over`), the sum of exponentials and the label's
    logit (picked by the rank whose shard holds it, 0 elsewhere) are summed
    over the ranks (`comm.sum_over`), and every rank of `group` returns the
    same loss and metrics."""
    import torch.distributed as dist

    lf = logits.to(torch.float32)
    rows = lf.shape[-1]
    m = comm.max_over(torch.amax(lf, dim=-1, keepdim=True), group)
    sum_exp = comm.sum_over(torch.sum(torch.exp(lf - m), dim=-1), group)
    lse = torch.log(sum_exp) + m[..., 0]
    idx = labels.to(torch.int64) - dist.get_rank(group) * rows
    ok = (idx >= 0) & (idx < rows)
    ll = torch.gather(lf, -1, idx.clamp(0, rows - 1)[..., None])[..., 0]
    ll = comm.sum_over(torch.where(ok, ll, torch.zeros((), dtype=ll.dtype, device=ll.device)),
                       group)
    loss = torch.mean(lse - ll)
    metrics = {"nll": loss}
    if z_loss:
        zl = z_loss * torch.mean(torch.square(lse))
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
