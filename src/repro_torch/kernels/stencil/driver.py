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
kernel or to the plain version.  `chained_launches` runs a pyramid: one
`fused_chain` launch per link, each link's next-base band the next one's
input.
"""

from __future__ import annotations

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import ref
from . import exec_streaming, exec_window, ir, plan

MODES = ("window", "streaming", "tiled2d", "ref")


def resolve_mode(stages, shape, dtype, lc: LaunchConfig = DEFAULT) -> str:
    """The mode `mode=None` takes for (N, H, W) planes of `dtype`."""
    _, H, W = shape
    ph, pw = exec_window.by_stages(stages, ("halo",),
                                   lambda: plan.chain_accumulated_halo(stages))
    if H <= ph or W <= pw or ph == 0:
        return "window"
    prog, _ = exec_streaming.program(stages, lc.stream_rows, dtype, torch.device("cpu"))
    fits = prog.layout.smem_bytes(W) + prog.table_smem <= lc.smem_budget
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
    (one per band, e.g. a Gaussian ladder's scales or a Sobel pair).  A
    band a pyrDown made is (ceil(H/2), ceil(W/2)) where the input is (H,
    W), one a resize2 made (H//2, W//2), one a pyrUp made (2H, 2W), in the
    order of the chain's resolution changes; a strided or upsampling map
    stage may sit anywhere in the chain (`plan.chain_levels`).  A band has
    the input's dtype, but a Sobel pair is f32.  A remap stage's map planes
    go to the kernel as they lie: on the image's device."""
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


def chained_launches(
    img: torch.Tensor, chains, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> tuple[list, list]:
    """A pyramid of chains, one `fused_chain` launch per link over the whole
    batch: link k+1 takes link k's last output band (its next base, the
    strided terminal tap `ir.validate_next_base` requires of every link but
    the last) as its input.  `mode=None` resolves each link's mode for its
    own, shrinking planes; a link whose planes are no larger than its halo
    launches `stencil_chain` like any other (the port has no plain-version
    tail on the card), so the launches are the links.

    Returns ``(outs, scales)``: ``outs[k]`` is link k's output bands
    without the carry band, ``scales[k]`` the (row, col) factor that maps
    link k's pixel (y, x) to base-image (y * sy, x * sx), exact because
    strided taps decimate on image-even coordinates."""
    chains = tuple(tuple(c) for c in chains)
    if not chains:
        raise ValueError("chained_launches: need at least one chain")
    outs_all, scales = [], []
    base = img
    sy = sx = 1
    for k, stages in enumerate(chains):
        last = k == len(chains) - 1
        if not last:
            ir.validate_next_base(stages)
        outs = fused_chain(base, stages, mode=mode, lc=lc)
        outs = outs if isinstance(outs, tuple) else (outs,)
        scales.append((sy, sx))
        if last:
            outs_all.append(outs)
        else:
            outs_all.append(outs[:-1])
            base = outs[-1]
            st = tuple(stages[-1].stride)
            sy, sx = sy * st[0], sx * st[1]
    return outs_all, scales
