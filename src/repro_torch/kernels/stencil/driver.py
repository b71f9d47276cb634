"""Chain driver: `fused_chain`, the public entry point of the stencil engine
(the counterpart of `repro.kernels.stencil.driver`).

Modes, and the kernel each names:

  ===========  ===========================================================
  mode         what runs
  ===========  ===========================================================
  "window"     `stencil_chain`: one block per (plane, 32x32 tile), each
               recomputing the chain over its own overlapping window
  "streaming"  `stencil_stream` with one full-width column tile; a chain
               whose rings do not fit shared memory raises `ValueError`
  "tiled2d"    `stencil_stream` with column tiles (`tile_w=`, else
               `LaunchConfig.tile2d_cols`, else the planner's width)
  "ref"        the plain PyTorch version, on any device
  None         "window" for planes no larger than the chain's accumulated
               halo (the port's stand-in for JAX's no-launch fallback) and
               for chains without row halo; else "streaming", or "tiled2d"
               when one full-width tile's rings do not fit
  ===========  ===========================================================

A CPU tensor runs the plain version of the kernel its mode names; a CUDA
tensor launches that kernel or raises.  There is no fallback to another
kernel or to the plain version.
"""

from __future__ import annotations

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import ref
from . import exec_streaming, exec_window, plan

MODES = ("window", "streaming", "tiled2d", "ref")


def resolve_mode(stages, shape, dtype, lc: LaunchConfig = DEFAULT) -> str:
    """The mode `mode=None` takes for (N, H, W) planes of `dtype`."""
    _, H, W = shape
    ph, pw = plan.chain_accumulated_halo(stages)
    if H <= ph or W <= pw or ph == 0:
        return "window"
    prog, _ = exec_streaming.program(stages, lc.stream_rows, dtype, torch.device("cpu"))
    fits = prog.layout.smem_bytes(W) + exec_streaming.PROGRAM_BYTES <= lc.smem_budget
    return "streaming" if fits else "tiled2d"


def fused_chain(
    img: torch.Tensor,
    stages,
    *,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    tile_w: int | None = None,
):
    """Run a stage chain over an image in one launch.

    img: (H, W), (H, W, C) or (B, H, W, C), u8 or f32, on the device it
    runs on.  tile_w: the column-tile width of mode "tiled2d" only.
    Returns one array when the chain ends with one live band, else a tuple
    (one per band, e.g. a Gaussian ladder's scales).  A band a pyrDown made
    is (ceil(H/2), ceil(W/2)) where the input is (H, W); a pyrDown stage
    must be the chain's last on the kernels (`plan.kernel_walk`)."""
    stages = tuple(stages)
    if not stages:
        return img
    if img.ndim not in (2, 3, 4):
        raise ValueError(f"fused_chain: unsupported rank {img.ndim}")
    if mode is not None and mode not in MODES:
        raise ValueError(f"fused_chain: unknown mode {mode!r} (expected one of {MODES} or None)")
    if tile_w is not None and mode != "tiled2d":
        raise ValueError(f"fused_chain: tile_w= only applies to mode='tiled2d', not {mode!r}")
    planes = ref.to_planes(img)
    if mode is None:
        mode = resolve_mode(stages, planes.shape, planes.dtype, lc)
    if mode == "ref":
        outs = exec_window.stencil_chain_plain(planes, stages)
    elif mode == "window":
        outs = exec_window.stencil_chain(planes, stages, lc)
    else:
        outs = exec_streaming.stencil_stream(
            planes, stages, lc, tiled=mode == "tiled2d", tile_w=tile_w
        )
    outs = tuple(ref.from_planes(o, img.shape) for o in outs)
    return outs[0] if len(outs) == 1 else outs
