"""Mamba2 mixer (SSD, state-space duality, arXiv:2405.21060), the
counterpart of `repro.models.ssm`.

Chunked semiseparable algorithm: a quadratic, attention-like term inside
each chunk of ``cfg.ssm.chunk`` positions plus the recurrent state carried
from chunk to chunk, O(S * L) time for chunk length L and O(H * N * P)
state.  The JAX package computes it in plain `jnp` (no Pallas kernel), and
so does the port, in plain PyTorch, with JAX's casts at every point: the
scan is f32 inside whatever the model's dtype, and the decode state
(``ssm`` (B, H, N, P), ``conv`` (B, K - 1, C)) is f32.

One departure from JAX: `mamba2_mixer` hands decode the conv input's last
K - 1 rows left-padded with zeros, where JAX slices fewer rows from a
prompt shorter than K - 1 tokens and its `_adopt_prefill` then keeps a
zeroed conv state, so that its decode forgets the prompt's conv inputs.

On a mesh, JAX's ``"ssm_heads"`` hint splits the SSD heads over the model
axis (`sharding.rules.ssm_heads`): `mamba2_mixer(group=)` computes the
rank's H / m heads on the whole sequence, reading ``in_proj``'s columns of
its heads (and the groups' B and C whole), its channels of the depthwise
conv, its slices of ``dt_bias``, ``A_log``, ``D`` and the norm's scale,
the norm's mean of squares merged over the axis, and ``out_proj`` as its
rows; it returns its partial sums of the output and its heads' part of
the state, which `gather_state` makes whole for decode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import comm
from .layers import _param, dense_init, init_norm, rms_norm


def init_mamba2(cfg, *, device=None, generator=None) -> nn.ParameterDict:
    """JAX's initializers: ``dt_bias`` the inverse softplus of a log-uniform
    draw in [1e-3, 0.1], ``A_log = log(1..H)``; ``D``, ``dt_bias``,
    ``conv_b``, ``A_log`` and ``norm.scale`` in f32, the rest in the
    parameter dtype."""
    s = cfg.ssm
    d = cfg.d_model
    conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads
    init = dict(dtype=cfg.param_dtype, device=device, generator=generator)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand(s.n_heads, generator=generator, **f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return nn.ParameterDict(
        {
            "in_proj": dense_init((d, d_in_proj), **init),
            "conv_w": dense_init((s.d_conv, conv_dim), **init, scale=1.0 / math.sqrt(s.d_conv)),
            "conv_b": _param(torch.zeros(conv_dim, **f32)),
            "A_log": _param(torch.log(torch.arange(1, s.n_heads + 1, **f32))),
            "D": _param(torch.ones(s.n_heads, **f32)),
            "dt_bias": _param(dt_bias),
            "norm": init_norm(s.d_inner, device=device),
            "out_proj": dense_init(
                (s.d_inner, d), **init, scale=1.0 / math.sqrt(s.d_inner * 2 * cfg.n_layers)
            ),
        }
    )


def _split_in_proj(p, x: torch.Tensor, s):
    """x @ in_proj split into z, x, B, C, dt."""
    gn = s.n_groups * s.d_state
    return torch.split(x @ p["in_proj"], [s.d_inner, s.d_inner, gn, gn, s.n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (K, C): the K taps
    summed in the activation dtype in index order, then silu(out + b)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, :S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i : i + S] * w[i]
    return F.silu(out + b.to(out.dtype))


def conv_tail(xbc: torch.Tensor, K: int) -> torch.Tensor:
    """The conv input's last K - 1 rows in f32, the decode handoff; a
    sequence shorter than K - 1 is left-padded with zeros, the rows the
    causal conv reads before it (the module docstring's departure)."""
    S = xbc.shape[1]
    tail = xbc[:, max(S - (K - 1), 0) :].to(torch.float32)
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """SSD chunked scan.

    x (B, S, H, P); dt (B, S, H) positive; A (H,) negative; Bm / Cm
    (B, S, G, N).  Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, N, P) in f32.  S is padded to a multiple of the chunk; the
    (B, nc, L, L, H) f32 tensors are built in place, one at a time.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))

    xc = x.reshape(Bsz, nc, L, H, P).to(torch.float32)
    dtc = dt.reshape(Bsz, nc, L, H).to(torch.float32)
    Bc = Bm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3).to(torch.float32)
    Cc = Cm.reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3).to(torch.float32)

    dA = dtc * A  # (B, nc, L, H) log-decay
    cum = torch.cumsum(dA, dim=2)  # inclusive
    # intra-chunk: scores[b, c, i, j, h] = exp(cum_i - cum_j) (C_i . B_j) dt_j, j <= i;
    # masked before the exp, where cum_i - cum_j > 0 may overflow.  Without
    # grad the (B, nc, L, L, H) f32 tensors are built in place, one at a
    # time (the serving prefill's memory); autograd refuses the in-place exp
    # and products (the exp's gradient reads its output), so with grad they
    # are built out of place.
    scores = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, L, L, H)
    above = ~torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    cb = torch.einsum("bclhn,bcjhn->bcljh", Cc, Bc)
    if torch.is_grad_enabled():
        scores = scores.masked_fill(above[None, None, :, :, None], -math.inf).exp()
        scores = scores * cb * dtc[:, :, None, :, :]
    else:
        scores.masked_fill_(above[None, None, :, :, None], -math.inf)
        scores.exp_()
        scores.mul_(cb)
        scores.mul_(dtc[:, :, None, :, :])
    del cb
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
    del scores

    # each chunk's end state: sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    rdec = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, L, H)
    st = torch.einsum("bclhn,bclhp->bchnp", (rdec * dtc)[..., None] * Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    state = (
        torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
        if init_state is None
        else init_state.to(torch.float32)
    )
    prev = []  # the state entering each chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + st[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    # inter-chunk: y_i += exp(cum_i) C_i . S_prev
    y += torch.einsum("bclhn,bchnp->bclhp", Cc * torch.exp(cum)[..., None], prev_states)
    return y.reshape(Bsz, nc * L, H, P)[:, :S].to(x.dtype), state


def _heads(s, group) -> tuple[int, int]:
    """(first head, heads) of this rank's SSD heads; all of them without
    `group`."""
    if group is None:
        return 0, s.n_heads
    hl = s.n_heads // comm.group_size(group)
    return comm.group_rank(group) * hl, hl


def _cols(w: torch.Tensor, spans, dim: int) -> torch.Tensor:
    """`w`'s ranges `spans` ((start, stop) each) along `dim`, concatenated."""
    return torch.cat([w.narrow(dim, a, b - a) for a, b in spans], dim=dim)


def mamba2_mixer(p, x: torch.Tensor, cfg, *, group=None):
    """Full-sequence Mamba2 mixer: x (B, S, D) -> (y (B, S, D), final state
    ``{"ssm", "conv"}``).  With `group` (the model axis's process group;
    JAX's ``"ssm_heads"`` split, module docstring) the rank's heads h0 ..
    h0 + H / m only: y is its partial sums of the output, which the ranks'
    reduce-scatter completes, and the state its heads' ``ssm`` (B, H / m,
    N, P) and ``conv`` its channels, (B, K - 1, d_inner / m + 2 G N)."""
    s = cfg.ssm
    B, S, _ = x.shape
    gn = s.n_groups * s.d_state
    H, P, N = s.n_heads, s.head_dim, s.d_state
    h0, hl = _heads(s, group)
    di, dl = s.d_inner, hl * P
    own = (h0 * P, (h0 + hl) * P)  # the rank's channels of z, of xs, of y
    if group is None:
        z, xs, Bm, Cm, dt = _split_in_proj(p, x, s)
        conv_w, conv_b, scale = p["conv_w"], p["conv_b"], p["norm"]["scale"]
    else:  # in_proj column-parallel: the rank's heads' columns, B and C whole
        w = _cols(p["in_proj"], [own, (di + own[0], di + own[1]), (2 * di, 2 * di + 2 * gn),
                                 (2 * di + 2 * gn + h0, 2 * di + 2 * gn + h0 + hl)], 1)
        z, xs, Bm, Cm, dt = torch.split(x @ w, [dl, dl, gn, gn, hl], dim=-1)
        conv_w = _cols(p["conv_w"], [own, (di, di + 2 * gn)], 1)
        conv_b = _cols(p["conv_b"], [own, (di, di + 2 * gn)], 0)
        scale = p["norm"]["scale"][own[0]:own[1]]
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    tail = conv_tail(xbc, s.d_conv)
    xbc = _causal_conv(xbc, conv_w, conv_b).to(x.dtype)
    xs, Bm, Cm = torch.split(xbc, [dl, gn, gn], dim=-1)
    xh = xs.reshape(B, S, hl, P)
    dtp = F.softplus(dt.to(torch.float32) + p["dt_bias"][h0:h0 + hl])
    A = -torch.exp(p["A_log"][h0:h0 + hl])
    y, fin = ssd_scan(
        xh, dtp, A, Bm.reshape(B, S, s.n_groups, N), Cm.reshape(B, S, s.n_groups, N),
        chunk=s.chunk,
    )
    y = y + p["D"][h0:h0 + hl].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, dl)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if group is None:
        y = rms_norm(y, scale, eps=cfg.norm_eps)
    else:  # the mean of squares over d_inner: the ranks' f32 partial sums merged
        yf = y.to(torch.float32)
        var = comm.sum_over(torch.sum(yf * yf, dim=-1, keepdim=True), group) / di
        y = (yf * torch.rsqrt(var + cfg.norm_eps) * scale.to(torch.float32)).to(y.dtype)
    return y @ p["out_proj"], {"ssm": fin, "conv": tail}


def gather_state(state: dict, cfg, group) -> dict:
    """The whole final state from each rank's part of it under the SSD
    heads' split (`mamba2_mixer(group=)`): ``ssm`` gathered over the heads
    and the conv tail's x channels over the ranks, B and C as they are."""
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    conv = state["conv"]
    xs = comm.all_gather(conv[..., : conv.shape[-1] - 2 * gn], 2, group)
    return {"ssm": comm.all_gather(state["ssm"], 1, group),
            "conv": torch.cat([xs, conv[..., conv.shape[-1] - 2 * gn:]], dim=-1)}


def init_mamba2_state(cfg, batch: int, *, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
    z = dict(dtype=dtype, device=device)
    return {
        "ssm": torch.zeros((batch, s.n_heads, s.d_state, s.head_dim), **z),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), **z),
    }


def conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One position of the causal conv, as JAX's decode einsum: the window
    (B, K, C) dotted with the taps (K, C) in f32, rounded once to the
    window's dtype, then silu(out + b).  A product and a sum over K, where
    an einsum would run C matrix products of (B, K) x (K, 1)."""
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1, keepdim=True)
    out = out.to(window.dtype)
    return F.silu(out + b.to(out.dtype))


def mamba2_decode(p, x: torch.Tensor, cfg, *, state: dict):
    """Single-token decode.  x (B, 1, D); state ``{"ssm": (B, H, N, P),
    "conv": (B, K - 1, C)}`` -> (y (B, 1, D), the new state)."""
    s = cfg.ssm
    B = x.shape[0]
    gn = s.n_groups * s.d_state
    z, xs, Bm, Cm, dt = _split_in_proj(p, x, s)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)  # (B, 1, C)
    window = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)  # (B, K, C)
    xbc_c = conv_step(window, p["conv_w"], p["conv_b"]).to(x.dtype)
    new_conv = window[:, 1:, :].to(state["conv"].dtype)
    xs_c, Bm_c, Cm_c = torch.split(xbc_c, [s.d_inner, gn, gn], dim=-1)
    H, P, N = s.n_heads, s.head_dim, s.d_state
    rep = H // s.n_groups
    xh = xs_c.reshape(B, H, P).to(torch.float32)
    dtp = F.softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"])
    Bv = Bm_c.reshape(B, s.n_groups, N).repeat_interleave(rep, dim=1).to(torch.float32)
    Cv = Cm_c.reshape(B, s.n_groups, N).repeat_interleave(rep, dim=1).to(torch.float32)
    decay = torch.exp(dtp * A[None, :])  # (B, H)
    new_ssm = state["ssm"].to(torch.float32) * decay[:, :, None, None] + (
        dtp[:, :, None, None] * Bv[..., None] * xh[:, :, None, :]
    )
    y = torch.einsum("bhn,bhnp->bhp", Cv, new_ssm) + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, s.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"]["scale"], eps=cfg.norm_eps)
    return y @ p["out_proj"], {"ssm": new_ssm.to(state["ssm"].dtype), "conv": new_conv}
