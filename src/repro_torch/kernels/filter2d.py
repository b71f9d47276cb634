"""2D image filtering (OpenCV filter2D / GaussianBlur): single-stage chains
of the fused stencil engine (the counterpart of `repro.kernels.filter2d`).

  filter2d     — kh*kw products per pixel (the paper's filter2D);
  sep_filter2d — a row pass then a column pass in one launch (kh + kw).

u8 images accumulate in f32 and pack back once; f32 stays f32.
"""

from __future__ import annotations

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import stencil


def filter2d(
    img: torch.Tensor, kernel, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """OpenCV filter2D (correlation, BORDER_REPLICATE) of an (H, W),
    (H, W, C) or (B, H, W, C) image with an odd (kh, kw) kernel."""
    return stencil.fused_chain(img, (stencil.filter_stage(kernel),), mode=mode, lc=lc)


def sep_filter2d(
    img: torch.Tensor, kx, ky, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """Separable filter: row taps kx, then column taps ky, in one launch."""
    return stencil.fused_chain(img, (stencil.sep_filter_stage(kx, ky),), mode=mode, lc=lc)
