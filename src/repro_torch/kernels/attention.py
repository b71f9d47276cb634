"""Flash attention on the card (the counterpart of `repro.kernels.attention`).

`flash_attention` replaces `repro.kernels.attention._flash_kernel` (TPU,
Pallas).  Bound on an H100: operations.  At gemma-7b's prefill (B = 8,
S = T = 1024, 16 heads of 256, causal, bf16) the causal half of q.k and
p.v is 34.4 GFLOP each.  q.k multiplies bf16 operands, exact in f32, so
the card could run it on its tensor cores (989 TFLOP/s, ~0.035 ms); p.v
takes f32 probabilities, so it needs f32 arithmetic (67 TFLOP/s, ~0.51
ms): ~0.55 ms in all, against ~0.08 ms for its ~268 MB.  This kernel uses
no tensor cores yet.  Design (``csrc/flash_attn.cu``):
one block per (batch, head, 64-row query tile) loops over 64-row KV tiles
with the running max, sum and accumulator in registers and shared memory;
q, k and v are read in place in their (B, S, H, hd) layout and staged in
their own dtype, f32 arithmetic throughout, no tensor cores yet.

`flash_attention_plain` is the same online softmax over 64-key blocks in
PyTorch, with the kernel's guards for rows that are masked so far.  It
sums dot products in another order, so the two agree to rounding, not bit
for bit: within `AGREE`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import _build, counters

NEG = -1e30
BQ = 64  # query rows per block of the kernel
BKV = 64  # key / value rows per tile (kernel and plain version)
MAX_HEAD_DIM = 256

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

# dtype code of the C launcher
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# C signature in csrc/flash_attn.cu: pointers and the stream as c_void_p, ints as c_int
# (q, k, v, o, B, S, T, H, hd, dtype, causal, smem_max, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def smem_bytes(head_dim: int, itemsize: int) -> int:
    """Shared memory of one kernel block: the q and k tiles (rows padded by
    one 32-bit word), the v tile, the 64 x 65 f32 score tile and three f32
    row vectors."""
    w = head_dim * itemsize // 4
    return 4 * ((BQ + BKV) * (w + 1) + BKV * w + BQ * (BKV + 1) + 3 * BQ)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(
            f"flash_attention: expected q (B, S, H, hd) and k, v (B, T, H, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            f"flash_attention: {q.shape[2]} query heads over {k.shape[2]} KV heads; the kernel "
            "takes one KV head per query head (GQA: ROADMAP Queue 2 item 8, step 1)"
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Plain version of the kernel: an online softmax over 64-key blocks in
    f32, with the kernel's guards; the result in q's dtype."""
    counters.PLAIN_CALLS["flash_attention"] += 1
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32).transpose(1, 2)  # (B, H, S, hd)
    kf = k.to(torch.float32).transpose(1, 2)
    vf = v.to(torch.float32).transpose(1, 2)
    m = torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    qi = torch.arange(S, device=q.device)[:, None]
    # under causal, keys past the last query row are masked for every row
    kv_end = min(T, S) if causal else T
    for k0 in range(0, kv_end, BKV):
        kb, vb = kf[:, :, k0 : k0 + BKV], vf[:, :, k0 : k0 + BKV]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            ki = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            s = torch.where(ki <= qi, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new <= NEG / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(m <= NEG / 2, 0.0, torch.exp(m - m_safe))
        l = l * corr + torch.sum(p, dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


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
) -> torch.Tensor:
    """q (B, S, H, hd), k / v (B, T, H, hd) of one dtype (f32, f16 or bf16),
    one KV head per query head -> (B, S, H, hd) in q's dtype.  causal masks
    key index ki > query index qi.  A CPU tensor, or ``mode="ref"``, runs the
    plain version; a CUDA tensor launches the kernel once or raises (also
    when a block's shared memory would exceed ``lc.smem_budget``)."""
    if mode not in (None, "ref"):
        raise ValueError(f"flash_attention: unknown mode {mode!r} (expected None or 'ref')")
    _check_inputs(q, k, v)
    if mode == "ref" or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    launch = _launcher()
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, expected {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    B, S, H, hd = q.shape
    smem = smem_bytes(hd, q.element_size())
    if smem > lc.smem_budget:
        raise ValueError(
            f"flash_attention: a block at head dim {hd} in {q.dtype} needs {smem} bytes of "
            f"shared memory, over the budget of {lc.smem_budget}"
        )
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            B,
            S,
            k.shape[1],
            H,
            hd,
            DTYPES[q.dtype],
            int(causal),
            lc.smem_budget,
            _build.cuda_stream(dev),
        )
    _build.check(err, "flash_attention")
    counters.LAUNCHES["flash_attention"] += 1
    return out
