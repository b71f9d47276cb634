"""int8 error-feedback gradient compression (the counterpart of
`repro.optim.compression`): per-tensor symmetric int8 with a f32 scale,
and the quantization residual kept for the next step (error feedback).

The all-reduce forms take a `torch.distributed` group where JAX's take an
axis name inside `shard_map`: `compressed_psum` (a shared scale, the max of
the ranks' scales, so that the int8 payloads sum; summed as int32, as
JAX's XLA lowers it; the mean and the new local residual), `bf16_psum`
(the mean summed in bfloat16) and `make_compressed_allreduce` (a mean over
a mesh axis, leaf by leaf).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..sharding import comm


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


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce of `g` over `group` (None: the world)
    -> (the f32 mean, the new local residual), as JAX's: the scale is the
    group's max of the local ones, the int8 payload is summed as int32."""
    group = group if group is not None else dist.group.WORLD
    corrected = g + residual
    local_amax = torch.clamp(torch.amax(torch.abs(corrected)), min=1e-12)
    scale = comm.all_reduce(local_amax.to(torch.float32), group, op=dist.ReduceOp.MAX) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_res = corrected - q.to(torch.float32) * scale
    total = comm.all_reduce(q.to(torch.int32), group).to(torch.float32) * scale
    return total / comm.group_size(group), new_res


def bf16_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `g` over `group` (None: the world), summed in bfloat16
    (a 2x smaller payload), as JAX's."""
    group = group if group is not None else dist.group.WORLD
    total = comm.all_reduce(g.to(torch.bfloat16), group).to(torch.float32)
    return total / comm.group_size(group)


def make_compressed_allreduce(mesh, axis_name: str = "data"):
    """-> allreduce(tree, residuals) -> (means, new residuals): a drop-in
    for a DP gradient mean over `mesh`'s axis `axis_name`, each leaf (a
    rank's own gradient) through `compressed_psum`.  The trees are dicts
    (nested) or lists of tensors."""
    group = comm.axes_group(mesh, (axis_name,))

    def walk(tree, residuals):
        if isinstance(tree, dict):
            out = {k: walk(tree[k], residuals[k]) for k in tree}
            return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(t, r) for t, r in zip(tree, residuals)]
            return [m for m, _ in out], [r for _, r in out]
        return compressed_psum(tree, residuals, group)

    return walk
