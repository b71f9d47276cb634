"""Image processing ops (the counterpart of `repro.cv.imgproc`): the
paper's filter2D / erode family, pyrDown and pyrUp, the geometric ops (warpAffine,
remap, the 2x2-mean resize, Sobel), and the BoW preprocess chain."""

from __future__ import annotations

import functools

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
pyr_down = kops.pyr_down
pyr_up = kops.pyr_up
sobel = kops.sobel
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
    ladder=None,
) -> torch.Tensor:
    """BoW preprocessing (blur -> erode -> gradient magnitude) as one fused
    launch over the whole (B, H, W, C) f32 batch; `mode` and `ladder` go
    to `stencil.fused_chain`."""
    return stencil.fused_chain(imgs, preprocess_chain(blur_ksize, sigma, erode_r), mode=mode,
                               lc=lc, ladder=ladder)


@functools.lru_cache(maxsize=32)
def preprocess_chain(blur_ksize: int = 5, sigma: float | None = None, erode_r: int = 1) -> tuple:
    """The preprocess chain's stages, built once per setting (the kernels'
    planners find a chain they saw by its stage objects)."""
    return (
        stencil.gaussian_stage(blur_ksize, sigma),
        stencil.erode_stage(erode_r),
        stencil.grad_stage(),
    )


def _hw(img: torch.Tensor) -> tuple[int, int]:
    return tuple(img.shape[-2:]) if img.ndim == 2 else tuple(img.shape[-3:-1])


def warp_affine(
    img: torch.Tensor, M, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """OpenCV warpAffine with WARP_INVERSE_MAP (dst -> src matrix M,
    bilinear, replicate border) as one gather-stage launch: dst(x, y)
    samples src at (M00 x + M01 y + M02, M10 x + M11 y + M12).  The
    displacement bound, and so the gather halo, comes from M over the image
    rectangle; to fuse a warp into a longer chain, build
    `stencil.warp_affine_stage` with extend=<the later stages' halo> (see
    `features.align_and_detect`)."""
    stage = stencil.warp_affine_stage(M, shape=_hw(img))
    return stencil.fused_chain(img, (stage,), mode=mode, lc=lc)


def remap(
    img: torch.Tensor,
    map_x,
    map_y,
    *,
    bound=None,
    extend=(0, 0),
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
) -> torch.Tensor:
    """OpenCV remap (bilinear, replicate border) as one gather-stage launch:
    dst(x, y) samples src at (map_x[y, x], map_y[y, x]).  The (H, W) f32
    map planes go to the kernel as they are (on the image's device); the
    gather halo comes from their largest displacement |map - identity|
    unless `bound=` gives it."""
    stage = stencil.remap_stage(map_x, map_y, bound=bound, extend=extend)
    return stencil.fused_chain(img, (stage,), mode=mode, lc=lc)


def resize_half(
    img: torch.Tensor, *, mode: str | None = None, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """2x downsample by 2x2 mean as one launch (out = floor(size/2)).  The
    input dtype is kept: u8 is rounded and saturated (OpenCV
    saturate_cast), not promoted to f32."""
    return stencil.fused_chain(img, (stencil.resize2_stage(),), mode=mode, lc=lc)


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


# -- van Herk-Gil-Werman morphology: 3 min-ops a pixel whatever the kernel size --------------
# JAX writes it in jnp (no Pallas kernel), so the port writes it in plain PyTorch.


def _vanherk_1d(x: torch.Tensor, w: int, axis: int, op: str) -> torch.Tensor:
    """Running min / max with window `w` along `axis` (centred, edge-padded):
    prefix and suffix scans over segments of `w`, then one min / max of a
    suffix and a prefix per output."""
    r = w // 2
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    pad = (-(n + 2 * r)) % w
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], r), x,
                    x[..., -1:].expand(*x.shape[:-1], r + pad)], dim=-1)
    m = xp.shape[-1] // w
    seg = xp.reshape(*xp.shape[:-1], m, w)
    scan, red = (torch.cummin, torch.minimum) if op == "min" else (torch.cummax, torch.maximum)
    pre = scan(seg, dim=-1).values.reshape(*xp.shape[:-1], m * w)
    suf = scan(seg.flip(-1), dim=-1).values.flip(-1).reshape(*xp.shape[:-1], m * w)
    # the window starting at i (length w): red(suffix[i], prefix[i + w - 1])
    out = red(suf[..., :n], pre[..., w - 1 : w - 1 + n])
    return torch.movedim(out, -1, axis)


def morph_vanherk(img: torch.Tensor, ksize: int, op: str = "min") -> torch.Tensor:
    """Separable rectangular erosion / dilation, (2*ksize+1)^2, edge
    borders, over axes 0 and 1 (an (H, W) or (H, W, C) image), in O(1)
    min-ops a pixel; the output in the input's dtype, on its device."""
    w = 2 * ksize + 1
    out = _vanherk_1d(img, w, 0, op)
    out = _vanherk_1d(out, w, 1, op)
    return out.to(img.dtype)


def erode_vanherk(img: torch.Tensor, ksize: int) -> torch.Tensor:
    return morph_vanherk(img, ksize, "min")


def dilate_vanherk(img: torch.Tensor, ksize: int) -> torch.Tensor:
    return morph_vanherk(img, ksize, "max")
