"""Flash attention on the card (the counterpart of `repro.kernels.attention`).

`flash_attention` replaces `repro.kernels.attention._flash_kernel` (TPU,
Pallas).  Bound on an H100: operations.  At gemma-7b's prefill (B = 8,
S = T = 1024, 16 heads of 256, causal, bf16) the causal half of q.k and
p.v is 34.4 GFLOP each, against ~268 MB (~0.08 ms at 3.35 TB/s).  k and v
may hold fewer heads than q (GQA): query head h reads KV head
h // (H // Hkv), in the kernel and in the plain version, and no KV is
repeated.  One hand-written kernel a call, routed by dtype
(``csrc/flash_attn.cu``):

* f16 / bf16, the serving path: tensor cores.  One block of three
  warpgroups per (batch, head, 128-row query tile): a producer thread
  issues TMA loads of q and of a 2-stage ring of 64-row K / V tiles, read
  in place in their (B, S, H, hd) layout; two consumer warpgroups of 64
  rows run q.k as `wgmma` (16-bit products are exact in f32), the online
  softmax in registers while the previous tile's p.v runs, and p.v as two
  `wgmma`s on p_hi = T(p) and p_lo = T(p - p_hi), staged in shared memory
  and summed in f32 (within ~2^-16 of f32 p.v).  Tensor work: q.k plus two
  p.v passes, 103.2 GFLOP at the gemma shape, ~0.104 ms at 989 TFLOP/s.
* f32: f32 FMAs (`flash_attn_simt_kernel`), one block of 256 threads per
  (batch, head, 64-row query tile), q, k and v staged in shared memory.

`flash_attention_plain` is the same online softmax over 64-key blocks in
PyTorch, with the kernel's guards for rows that are masked so far, in f32
throughout.  It sums dot products in another order, so kernel and plain
version agree to rounding, not bit for bit: within `AGREE`.

With ``lse=True`` both also return each query row's log-sum-exp over the
keys it sees, f32 (B, H, S): ``m_safe + log(l)`` in natural-log units of
the scaled scores (the online softmax's running max, 0 while the row is
masked, and its denominator), -1e30 for a row that sees no key.  A split-K
decode (`models.attention.merge_lse`) merges the normalised outputs of
slices of the keys by these weights; the outputs are the same with it or
without.

Training differentiates `flash_attention` through `FlashAttention`, a
`torch.autograd.Function`: its forward is the wrapper's (the kernel on a
CUDA tensor, the plain version on the CPU or under ``mode="ref"``), so both
routes get one gradient, `flash_attention_backward`.  That gradient is
plain PyTorch in f32, because the JAX package has no backward kernel: its
`_flash_kernel` has no `custom_vjp`, and its LM trains through `jnp`
autodiff of `dense_attention`.  A hand-written backward kernel is speed
work for later (ROADMAP Notes).

A tensor on the meta device (the dry run, `launch.dryrun`) holds no data,
so the wrapper's meta route only shapes the output, ``torch.empty_like(q)``,
and reports the call to the active cost recorders (`counters.record`,
`flash_work`): it launches nothing and counts no launch.  It first holds
the call to the card route's checks of shape and dtype (the block's shared
memory against ``lc.smem_budget`` too), so a dry run refuses what the card
would.  It is a shape
function, not a fallback: a CUDA tensor still launches the kernel or
raises, and reports the same work while a recorder is active, so a traced
step and a real one count alike.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import _build, counters

NEG = -1e30
BQ = 64  # query rows per block of the f32 kernel
BKV = 64  # key / value rows per tile (both kernels and the plain version)
MAX_HEAD_DIM = 256
# the 16-bit kernel: query rows per block, channels per swizzled 128-byte
# row, K / V ring stages, each consumer warpgroup's p_hi and p_lo tiles
# (64 x 64, 16-bit), and the alignment slack and mbarriers of a block
WGMMA_BQ = 128
CHUNK = 64
STAGES = 2
P_TILES = 2 * 2 * 64 * BKV * 2
WGMMA_EXTRA = 1024 + 8 * (1 + 4 * STAGES)

# (rtol, atol) within which the kernel, its plain version and the f32
# oracle agree.  Each computes in f32 and rounds once to the output dtype,
# so in f16 / bf16 two results lie at most one ulp of that dtype apart
# (at most 2^-10 / 2^-7 of the value) plus the f32 rounding near 0 (atol);
# f32 keeps the JAX kernel test's 2e-4 (tests/test_kernels_attention.py:20)
AGREE = {
    torch.float32: (2e-4, 2e-4),
    torch.float16: (2.0**-10, 1e-4),
    torch.bfloat16: (2.0**-7, 1e-4),
}

# The share of f16 / bf16 outputs that may differ from the plain version's
# (f32 p.v, rounded once).  AGREE passes a single 16-bit pass of p, so this
# is what shows the p_hi + p_lo split: on the CPU tests' shapes the replay of
# the split reads 0.04-0.25% and a single pass 33-40%
# (tests/test_torch_attention.py), and 2^-5 lies between them.
OFF_PLAIN_SHARE = 2.0**-5

# dtype code of the C launcher
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# C signature in csrc/flash_attn.cu: pointers and the stream as c_void_p, ints as c_int
# (q, k, v, o, lse, B, S, T, H, Hkv, hd, dtype, causal, q_off, smem_max, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def smem_bytes(head_dim: int, itemsize: int) -> int:
    """Shared memory of one kernel block.  f32: the q and k tiles (rows
    padded by one 32-bit word), the v tile, the 64 x 65 f32 score tile and
    three f32 row vectors.  f16 / bf16: the 128-row q tile and 2 stages of
    64-row K and V tiles, each of `chunks` 64-channel chunks of 128 bytes a
    row (head dims below 256 padded to 64 or 128 channels), the p_hi and
    p_lo tiles of both consumer warpgroups, the 1024-byte alignment slack
    and 9 mbarriers.  The library's ``flash_attn_smem_bytes`` gives the same
    figures (a card test holds the two together)."""
    if itemsize == 4:
        w = head_dim
        return 4 * ((BQ + BKV) * (w + 1) + BKV * w + BQ * (BKV + 1) + 3 * BQ)
    ring = chunks(head_dim) * (WGMMA_BQ + 2 * STAGES * BKV) * 2 * CHUNK
    return ring + P_TILES + WGMMA_EXTRA


def chunks(head_dim: int) -> int:
    """64-channel chunks the 16-bit kernel pads `head_dim` to: 1, 2 or 4."""
    return 1 if head_dim <= CHUNK else 2 if head_dim <= 2 * CHUNK else 4


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(
            f"flash_attention: expected q (B, S, H, hd) and k, v (B, T, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: {q.shape[2]} query heads over {k.shape[2]} KV heads; the KV "
            "head count must divide the query head count"
        )
    if k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: head dims {q.shape[3]} and {k.shape[3]} differ")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one of {list(DTYPES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    hd = q.shape[3]
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {hd} must be a multiple of 8 in [8, {MAX_HEAD_DIM}]"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_off: int = 0,
    lse: bool = False,
):
    """Plain version of the kernel: an online softmax over 64-key blocks in
    f32, with the kernel's guards; the result in q's dtype.  Query heads are
    taken in groups of H // Hkv, each group against its KV head (no repeat).
    Query row i stands at position ``q_off + i`` for the causal mask.  With
    `lse`, -> (out, each row's log-sum-exp (B, H, S) f32; module
    docstring)."""
    counters.PLAIN_CALLS["flash_attention"] += 1
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    # (B, G, R, S, hd) against (B, G, 1, T, hd): query head g * R + r reads KV head g
    qf = q.to(torch.float32).transpose(1, 2).reshape(B, G, H // G, S, hd)
    kf = k.to(torch.float32).transpose(1, 2)[:, :, None]
    vf = v.to(torch.float32).transpose(1, 2)[:, :, None]
    m = torch.full(qf.shape[:4], NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(qf.shape[:4], dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    qi = torch.arange(q_off, q_off + S, device=q.device)[:, None]
    # under causal, keys past the last query row are masked for every row
    kv_end = min(T, S + q_off) if causal else T
    for k0 in range(0, kv_end, BKV):
        kb, vb = kf[:, :, :, k0 : k0 + BKV], vf[:, :, :, k0 : k0 + BKV]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            ki = torch.arange(k0, k0 + kb.shape[3], device=q.device)[None, :]
            s = torch.where(ki <= qi, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new <= NEG / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(m <= NEG / 2, 0.0, torch.exp(m - m_safe))
        l = l * corr + torch.sum(p, dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, H, S, hd)
    out = out.transpose(1, 2).to(q.dtype)
    if not lse:
        return out
    m_safe = torch.where(m <= NEG / 2, 0.0, m)
    return out, torch.where(l > 0, m_safe + torch.log(l), NEG).reshape(B, H, S)


@functools.cache
def _launcher():
    fn = _build.library("flash_attn").flash_attn_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    q_off: int = 0,
    lse: bool = False,
):
    """q (B, S, H, hd), k / v (B, T, Hkv, hd) of one dtype (f32, f16 or
    bf16), Hkv dividing H (query head h reads KV head h // (H // Hkv)) ->
    (B, S, H, hd) in q's dtype.  causal masks
    key index ki > query position qi, where query row i stands at position
    ``q_off + i`` (`q_off` >= 0: a slice of the queries of a longer
    sequence, each row seeing the keys its position sees; 0 by default,
    and the offset changes nothing but the mask).  A CPU tensor, or ``mode="ref"``, runs the
    plain version; a CUDA tensor launches the kernel once or raises (also
    when a block's shared memory would exceed ``lc.smem_budget``); a meta
    tensor gets its output's shape and launches nothing (module docstring).
    When grad is enabled and q, k or v requires it, the call goes through
    `FlashAttention`, whose backward is `flash_attention_backward`.  With
    `lse`, -> (out, each query row's log-sum-exp (B, H, S) f32; module
    docstring), which has no gradient: asked under autograd it raises."""
    if mode not in (None, "ref"):
        raise ValueError(f"flash_attention: unknown mode {mode!r} (expected None or 'ref')")
    if isinstance(q_off, bool) or not isinstance(q_off, int) or q_off < 0:
        raise ValueError(f"flash_attention: q_off must be an int >= 0, got {q_off!r}")
    _check_inputs(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if lse:
            raise ValueError("flash_attention: the log-sum-exp output has no gradient")
        return FlashAttention.apply(q, k, v, causal, mode, lc, q_off)
    return _forward(q, k, v, causal=causal, mode=mode, lc=lc, q_off=q_off, lse=lse)


def causal_pairs(S: int, T: int, causal: bool, q_off: int = 0) -> int:
    """(query, key) pairs the function computes: with causal, key ki <= query
    position qi = q_off + i, i.e. min(qi + 1, T) keys for query row i; else
    S x T."""
    if not causal:
        return S * T

    def upto(rows):  # the pairs of query positions 0 .. rows - 1
        n = min(rows, T)
        return n * (n + 1) // 2 + (rows - n) * T

    return upto(q_off + S) - upto(q_off)


def flash_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, q_off: int = 0, lse: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one `flash_attention` call: the q.k and p.v
    products over the computed pairs (`causal_pairs`), 2 x 2 B H hd a pair,
    and q, k, v and the output each once (with `lse`, the f32 log-sum-exp
    too).  This is the function's work, not the kernel's (its two 16-bit
    p.v passes), so a redesign of the kernel leaves it unchanged."""
    B, S, H, hd = q.shape
    flops = 4.0 * B * H * hd * causal_pairs(S, k.shape[1], causal, q_off)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return flops, float(nbytes + (4 * B * H * S if lse else 0))


def _forward(q, k, v, *, causal: bool, mode: str | None, lc: LaunchConfig,
             q_off: int = 0, lse: bool = False):
    """The wrapper's body, its inputs checked: the plain version, one launch,
    or on the meta device the output's shape (module docstring)."""
    if mode == "ref" or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off, lse=lse)
    B, S, H, hd = q.shape
    smem = smem_bytes(hd, q.element_size())
    if smem > lc.smem_budget:
        raise ValueError(
            f"flash_attention: a block at head dim {hd} in {q.dtype} needs {smem} bytes of "
            f"shared memory, over the budget of {lc.smem_budget}"
        )
    if q.device.type == "meta":
        if k.device.type != "meta" or v.device.type != "meta":
            raise ValueError(f"flash_attention: q on meta, k on {k.device}, v on {v.device}")
        if counters.RECORDERS:
            counters.record("flash_attention", *flash_work(q, k, v, causal, q_off, lse))
        out = torch.empty_like(q)
        return (out, q.new_empty((B, H, S), dtype=torch.float32)) if lse else out
    launch = _launcher()
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, expected {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse_t = q.new_empty((B, H, S), dtype=torch.float32) if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            lse_t.data_ptr() if lse else None,
            B,
            S,
            k.shape[1],
            H,
            k.shape[2],
            hd,
            DTYPES[q.dtype],
            int(causal),
            q_off,
            lc.smem_budget,
            _build.cuda_stream(dev),
        )
    _build.check(err, "flash_attention")
    counters.LAUNCHES["flash_attention"] += 1
    if counters.RECORDERS:
        counters.record("flash_attention", *flash_work(q, k, v, causal, q_off, lse))
    return (out, lse_t) if lse else out


# f32 scratch of one score-sized tensor (B, H, rows, T) of the backward; its
# query rows are cut to fit (deepseek-v3's (8, 128, 1024, 1024) scores would
# be 4.3 GB whole)
BWD_SCRATCH_BYTES = 1 << 28


def backward_rows(B: int, H: int, S: int, T: int) -> int:
    """Query rows a block of `flash_attention_backward` takes: as many as
    keep one (B, H, rows, T) f32 tensor within `BWD_SCRATCH_BYTES`, a
    multiple of 64 when over 64, at least 1 and at most S."""
    rows = max(1, BWD_SCRATCH_BYTES // max(1, B * H * T * 4))
    if rows > 64:
        rows -= rows % 64
    return min(rows, max(S, 1))


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    q_off: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `flash_attention` (query row i at position ``q_off +
    i``) in plain PyTorch, in f32: for each
    block of query rows (`backward_rows`) it recomputes the masked, scaled
    scores and P = softmax, then dV += P^T dO, dP = dO V^T, dS = P (dP -
    rowsum(dO O)), dQ = dS K scale and dK += dS^T Q scale.  dK and dV sum
    over each group of H // Hkv query heads (no KV is repeated, as in the
    forward).  Under causal a block reads only the keys up to its last row.
    -> (dq, dk, dv), each rounded once to its input's dtype."""
    counters.BACKWARD_CALLS["flash_attention"] += 1
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    R = H // G
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32

    def heads(t, s0, s1):  # (B, S, H, hd) rows s0:s1 -> (B, G, R, rows, hd) f32
        return t[:, s0:s1].to(f32).transpose(1, 2).reshape(B, G, R, s1 - s0, hd)

    kf = k.to(f32).transpose(1, 2)[:, :, None]  # (B, G, 1, T, hd)
    vf = v.to(f32).transpose(1, 2)[:, :, None]
    dq = torch.empty((B, G, R, S, hd), dtype=f32, device=q.device)
    dk = torch.zeros((B, G, T, hd), dtype=f32, device=q.device)
    dv = torch.zeros((B, G, T, hd), dtype=f32, device=q.device)
    rows = backward_rows(B, H, S, T)
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        t1 = min(T, s1 + q_off) if causal else T
        qb, ob, dob = heads(q, s0, s1), heads(out, s0, s1), heads(dout, s0, s1)
        kb, vb = kf[:, :, :, :t1], vf[:, :, :, :t1]
        s = (qb @ kb.transpose(-1, -2)) * scale  # (B, G, R, rows, t1)
        if causal:
            qi = torch.arange(q_off + s0, q_off + s1, device=q.device)[:, None]
            ki = torch.arange(t1, device=q.device)[None, :]
            s = torch.where(ki <= qi, s, NEG)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(m <= NEG / 2, 0.0, m))  # a masked row: p = 0
        del s
        p /= torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
        dv[:, :, :t1] += torch.einsum("bgrst,bgrsd->bgtd", p, dob)
        ds = dob @ vb.transpose(-1, -2)  # dP
        ds -= torch.sum(dob * ob, dim=-1, keepdim=True)
        ds *= p
        del p
        dq[:, :, :, s0:s1] = (ds @ kb) * scale
        dk[:, :, :t1] += torch.einsum("bgrst,bgrsd->bgtd", ds, qb) * scale
        del ds
    dq = dq.reshape(B, H, S, hd).transpose(1, 2).to(q.dtype)
    return dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd (module docstring): the forward is
    the wrapper's route, the backward `flash_attention_backward`.  Under
    `torch.utils.checkpoint` the forward runs again when the layer is
    recomputed, and launches the kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, mode: str | None, lc: LaunchConfig, q_off: int = 0):
        out = _forward(q, k, v, causal=causal, mode=mode, lc=lc, q_off=q_off)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.q_off = causal, q_off
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        # a named range, so that a profile of a train step can attribute its time
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward(q, k, v, out, dout, causal=ctx.causal,
                                                  q_off=ctx.q_off)
        return dq, dk, dv, None, None, None, None
