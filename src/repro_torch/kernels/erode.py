"""Morphological erosion / dilation (OpenCV erode / dilate): single-stage
chains of the fused stencil engine (the counterpart of
`repro.kernels.erode`).  min and max are exact on every carrier."""

from __future__ import annotations

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import stencil


def erode(
    img: torch.Tensor, ksize: int, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """OpenCV erode with a (2*ksize+1)^2 rectangle, BORDER_REPLICATE."""
    return stencil.fused_chain(img, (stencil.erode_stage(ksize),), mode=mode, lc=lc)


def dilate(
    img: torch.Tensor, ksize: int, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    return stencil.fused_chain(img, (stencil.dilate_stage(ksize),), mode=mode, lc=lc)
