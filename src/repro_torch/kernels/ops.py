"""Public ops (the counterpart of `repro.kernels.ops`): the image ops, each
one launch of the fused stencil engine, the BoW and GBDT kernels, and
`flash_attention`.  `pyr_up` and `sobel` are queued with their slices
(ROADMAP)."""

from __future__ import annotations

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import ref
from .attention import flash_attention  # noqa: F401
from .bow import bow_assign, bow_quantize_hist, linear_score  # noqa: F401
from .erode import dilate, erode  # noqa: F401
from .filter2d import filter2d, sep_filter2d
from .gbdt import gbdt_score  # noqa: F401
from .stencil import (  # noqa: F401
    Stage,
    affine_stage,
    box_stage,
    dilate_stage,
    erode_stage,
    filter_stage,
    fused_chain,
    gaussian_stage,
    grad_stage,
    pyr_down_stage,
    sep_filter_stage,
    threshold_stage,
)


def threshold(
    img: torch.Tensor,
    thresh: float,
    maxval: float = 255.0,
    *,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
) -> torch.Tensor:
    """OpenCV THRESH_BINARY: maxval where img > thresh else 0 (an f32
    compare, so a fractional threshold binds on u8)."""
    return fused_chain(img, (threshold_stage(thresh, maxval),), mode=mode, lc=lc)


def pyr_down(
    img: torch.Tensor, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """OpenCV pyrDown: the 5x5 [1,4,6,4,1]/16 Gaussian, then 2x decimation on
    even image coordinates; out = ceil(size/2), dtype preserved."""
    return fused_chain(img, (pyr_down_stage(),), mode=mode, lc=lc)


def box_blur(
    img: torch.Tensor, r: int, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """OpenCV blur(): normalised (2r+1)^2 box filter."""
    return fused_chain(img, (box_stage(r),), mode=mode, lc=lc)


def gaussian_blur(
    img: torch.Tensor,
    ksize: int,
    sigma: float | None = None,
    *,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
) -> torch.Tensor:
    """OpenCV GaussianBlur through the separable stage."""
    k1 = ref.gaussian_kernel1d(ksize, sigma)
    return sep_filter2d(img, k1, k1, mode=mode, lc=lc)


def gaussian_filter2d(
    img: torch.Tensor,
    ksize: int,
    sigma: float | None = None,
    *,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
) -> torch.Tensor:
    """The paper's filter2D benchmark: the full 2D Gaussian kernel, direct."""
    k1 = ref.gaussian_kernel1d(ksize, sigma)
    return filter2d(img, torch.outer(k1, k1), mode=mode, lc=lc)
