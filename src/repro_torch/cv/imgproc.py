"""Image processing ops (the counterpart of `repro.cv.imgproc`): the
paper's filter2D / erode family, and the BoW preprocess chain."""

from __future__ import annotations

import torch

from ..core.device import DEFAULT, LaunchConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels import stencil

filter2d = kops.filter2d
sep_filter2d = kops.sep_filter2d
gaussian_blur = kops.gaussian_blur
gaussian_filter2d = kops.gaussian_filter2d
erode = kops.erode
dilate = kops.dilate
threshold = kops.threshold
box_blur = kops.box_blur
gaussian_kernel1d = kref.gaussian_kernel1d
fused_chain = stencil.fused_chain

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # OpenCV BT.601


def preprocess_bow(
    imgs: torch.Tensor,
    *,
    blur_ksize: int = 5,
    sigma: float | None = None,
    erode_r: int = 1,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
) -> torch.Tensor:
    """BoW preprocessing (blur -> erode -> gradient magnitude) as one fused
    launch over the whole (B, H, W, C) f32 batch."""
    chain = (
        stencil.gaussian_stage(blur_ksize, sigma),
        stencil.erode_stage(erode_r),
        stencil.grad_stage(),
    )
    return stencil.fused_chain(imgs, chain, mode=mode, lc=lc)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8/float -> (...) same dtype (OpenCV BT.601 weights).  The
    weighted sum is taken left to right with a rounding after each product
    and sum, so it is the same on every device."""
    x = img.to(torch.float32)
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=img.device)
    g = x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]
    if img.dtype == torch.uint8:
        return torch.clamp(torch.round(g), 0, 255).to(torch.uint8)
    return g.to(img.dtype)
