"""int8 error-feedback gradient compression (the counterpart of
`repro.optim.compression`): per-tensor symmetric int8 with a f32 scale,
and the quantization residual kept for the next step (error feedback).

The JAX module's all-reduce forms, `compressed_psum`, `bf16_psum` and
`make_compressed_allreduce`, run inside a mesh's collectives and wait for
sharding (ROADMAP Queue 1 item 8 step 9).
"""

from __future__ import annotations

import torch


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 -> (q int8, scale f32): round half to even,
    as ``jnp.round``."""
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(
    g: torch.Tensor, residual: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, scale, new_residual): quantize g + residual, keep the error."""
    corrected = g + residual
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)
