"""Chain driver: `fused_chain`, the public entry point of the stencil engine
(the counterpart of `repro.kernels.stencil.driver`).

Mode resolution:

  ====================  ======  =====================================
  mode                  device  what runs
  ====================  ======  =====================================
  None or "window"      CUDA    the `stencil_chain` kernel
  None or "window"      CPU     the kernel's plain PyTorch version
  "ref"                 either  the plain PyTorch version
  "streaming"/"tiled2d" any     `NotImplementedError` (queued)
  ====================  ======  =====================================

There is no fallback: a kernel that fails on the card raises.  Unlike the
JAX driver, planes no larger than the chain's halo launch the kernel too;
only the CPU runs the plain version for them.
"""

from __future__ import annotations

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import ref
from . import exec_window

MODES = ("window", "ref")
QUEUED_MODES = ("streaming", "tiled2d")


def fused_chain(
    img: torch.Tensor, stages, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
):
    """Run a stage chain over an image in one launch.

    img: (H, W), (H, W, C) or (B, H, W, C), f32, on the device it runs on.
    Returns one array when the chain ends with one live band, else a tuple
    (one per band, e.g. a Gaussian ladder's scales)."""
    stages = tuple(stages)
    if not stages:
        return img
    if img.ndim not in (2, 3, 4):
        raise ValueError(f"fused_chain: unsupported rank {img.ndim}")
    if mode in QUEUED_MODES:
        raise NotImplementedError(
            f"fused_chain: mode {mode!r} (row-carry redesign) is queued in ROADMAP"
        )
    if mode is not None and mode not in MODES:
        raise ValueError(f"fused_chain: unknown mode {mode!r} (expected one of {MODES} or None)")
    planes = ref.to_planes(img)
    if mode == "ref":
        outs = exec_window.stencil_chain_plain(planes, stages)
    else:
        outs = exec_window.stencil_chain(planes, stages, lc)
    outs = tuple(ref.from_planes(o, img.shape) for o in outs)
    return outs[0] if len(outs) == 1 else outs
