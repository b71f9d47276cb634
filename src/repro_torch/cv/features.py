"""SIFT-lite: DoG keypoints + 128-d gradient-histogram descriptors (the
counterpart of `repro.cv.features`): the single-octave detector, the
multi-octave pyramid (`sift_pyramid`: one launch per octave, chained
through the next-base band), and `align_and_detect`: an affine warp fused
into the octave's launch.

The JAX package runs these per image under `jax.lax.map`; here every
function takes a batch, (B, H, W) gray or (B, H, W, 3) RGB, and keeps the
per-image semantics explicitly: gray normalisation divides by each image's
own maximum, top-k keeps equal scores in index order (as `lax.top_k`
does), and the orientation and descriptor histograms add their samples in
pixel order (as XLA's scatter does), so two runs give identical bits.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core.device import DEFAULT, LaunchConfig
from ..kernels import ref, stencil
from . import imgproc
from .config import PipelineConfig


def _ksz(s: float) -> int:
    """Full-width Gaussian support for sigma s: 2*round(3*sigma)+1, >= 3."""
    return max(3, 2 * int(round(3 * s)) + 1)


def ladder_taps(n_scales: int, sigma0: float, max_ksize: int | None = None) -> list:
    """Per-stage (ksize, sigma) of the incremental blur ladder: the base blur
    capped at max_ksize, each incremental tap sized from its own
    sigma_delta = sqrt(s_i^2 - s_{i-1}^2) at full width."""
    sigmas = [sigma0 * 2 ** (i / n_scales) for i in range(n_scales + 3)]
    k0 = _ksz(sigmas[0])
    taps = [(min(k0, max_ksize) if max_ksize else k0, sigmas[0])]
    prev = sigmas[0]
    for s in sigmas[1:]:
        delta = math.sqrt(max(s * s - prev * prev, 1e-12))
        taps.append((_ksz(delta), delta))
        prev = s
    return taps


@functools.lru_cache(maxsize=64)
def octave_chain(
    n_scales: int = 4, sigma0: float = 1.6, max_ksize: int = 15, with_next_base: bool = True
) -> tuple:
    """The stage chain of one octave: base blur -> incremental tap ladder ->
    optional terminal pyrDown tap of scale `n_scales` (the 2x-sigma image),
    emitting the next octave's base.  Built once per setting (the kernels'
    planners find a chain they saw by its stage objects)."""
    taps = ladder_taps(n_scales, sigma0, max_ksize)
    stages = [stencil.gaussian_stage(*taps[0])]
    stages += [stencil.gaussian_stage(k, s, tap=-1) for k, s in taps[1:]]
    if with_next_base:
        stages.append(stencil.pyr_down_stage(tap=n_scales))
    return tuple(stages)


def gaussian_octave(
    g: torch.Tensor,
    *,
    n_scales: int = 4,
    sigma0: float = 1.6,
    max_ksize: int = 15,
    with_next_base: bool = True,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    ladder=None,
) -> tuple:
    """One SIFT octave over an (H, W) gray plane or a (B, H, W) batch as one
    launch.  Returns (pyr, next_base): pyr the (n_scales + 3, H, W) scale
    stack (with a leading B for a batch), next_base the pyrDown of scale
    `n_scales`, (ceil(H/2), ceil(W/2)) (with a leading B), or None when
    `with_next_base` is False (single-octave callers skip its work and its
    +2 rows of halo).  `mode` and `ladder` go to `stencil.fused_chain`, as
    in every detector here."""
    stages = octave_chain(n_scales, sigma0, max_ksize, with_next_base)
    outs = stencil.fused_chain(g[..., None], stages, mode=mode, lc=lc, ladder=ladder)
    outs = [o[..., 0] for o in outs]
    axis = g.ndim - 2  # the scale axis: after the batch axis, if any
    if with_next_base:
        return torch.stack(outs[:-1], dim=axis), outs[-1]
    return torch.stack(outs, dim=axis), None


def pyramid_chains(
    n_octaves: int, n_scales: int = 4, sigma0: float = 1.6, max_ksize: int = 15
) -> tuple:
    """Per-octave stage chains of the multi-octave SIFT pyramid.  Octave 0
    is `octave_chain` (base blur + incremental ladder); every later
    octave's base arrives already blurred to sigma0 in its own coordinates
    (the pyrDown of the previous octave's 2x-sigma scale, Lowe's
    construction), so its chain is the tap ladder alone, the carried base
    staying live as scale 0.  Every octave but the last ends with the
    next-base pyrDown tap (`stencil.validate_next_base`)."""
    taps = ladder_taps(n_scales, sigma0, max_ksize)
    chains = []
    for k in range(n_octaves):
        carry = k < n_octaves - 1
        if k == 0:
            chains.append(octave_chain(n_scales, sigma0, max_ksize, with_next_base=carry))
            continue
        stages = [stencil.gaussian_stage(kz, s, tap=-1) for kz, s in taps[1:]]
        if carry:
            stages.append(stencil.pyr_down_stage(tap=n_scales))
        chains.append(tuple(stages))
    return tuple(chains)


def _shift2(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Edge-clamped shift of the last two axes (never wraps)."""
    H, W = a.shape[-2:]
    ap = ref.pad_replicate(a, 1, 1)
    return ap[..., 1 - di : 1 - di + H, 1 - dj : 1 - dj + W]


def _keypoints_from_pyr(
    pyr: torch.Tensor,
    g: torch.Tensor,
    *,
    max_kp: int,
    contrast_thresh: float = 0.02,
    edge_thresh: float = 10.0,
    border: int = 8,
) -> dict:
    """3x3x3 DoG extrema + edge rejection on a (B, S+3, H, W) scale stack."""
    B, _, H, W = pyr.shape
    dogs = pyr[:, 1:] - pyr[:, :-1]
    mid = dogs[:, 1:-1]
    neigh_max = torch.full_like(mid, -math.inf)
    neigh_min = torch.full_like(mid, math.inf)
    for ds in (-1, 0, 1):
        lvl = dogs[:, 1 + ds : dogs.shape[1] - 1 + ds]
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds == 0 and di == 0 and dj == 0:
                    continue
                v = _shift2(lvl, di, dj)
                neigh_max = torch.maximum(neigh_max, v)
                neigh_min = torch.minimum(neigh_min, v)
    is_ext = ((mid > neigh_max) & (mid > contrast_thresh)) | (
        (mid < neigh_min) & (mid < -contrast_thresh)
    )
    dxx = _shift2(mid, 0, 1) + _shift2(mid, 0, -1) - 2 * mid
    dyy = _shift2(mid, 1, 0) + _shift2(mid, -1, 0) - 2 * mid
    dxy = 0.25 * (
        _shift2(mid, 1, 1) + _shift2(mid, -1, -1) - _shift2(mid, 1, -1) - _shift2(mid, -1, 1)
    )
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    ii = torch.arange(H, device=pyr.device)[None, None, :, None]
    jj = torch.arange(W, device=pyr.device)[None, None, None, :]
    in_border = (ii >= border) & (ii < H - border) & (jj >= border) & (jj < W - border)
    score = torch.where(is_ext & edge_ok & in_border, torch.abs(mid), 0.0)

    # top-k with equal scores in index order: a stable descending sort
    resp, idx = torch.sort(score.reshape(B, -1), dim=1, descending=True, stable=True)
    resp, idx = resp[:, :max_kp], idx[:, :max_kp]
    s_idx = idx // (H * W)
    rem = idx % (H * W)
    yy, xx = rem // W, rem % W
    return {
        "xy": torch.stack([xx, yy], dim=-1).to(torch.float32),
        "scale": s_idx.to(torch.int32),
        "resp": resp,
        "valid": resp > 0.0,
        "gray": g,
    }


def _normalize_gray(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, 3]) -> (B, H, W) f32 gray, each image divided by its own max."""
    g = imgs.to(torch.float32)
    if g.ndim == 4:
        g = imgproc.rgb_to_gray(g)
    return g / torch.clamp(torch.amax(g, dim=(1, 2), keepdim=True), min=1e-6)


def detect_keypoints(
    imgs: torch.Tensor,
    *,
    n_scales: int = 4,
    max_kp: int = 64,
    contrast_thresh: float = 0.02,
    edge_thresh: float = 10.0,
    border: int = 8,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    ladder=None,
) -> dict:
    """Single-octave DoG detector over a batch.  Returns dict: xy (B, max_kp,
    2) f32, scale (B, max_kp) i32, resp, valid (B, max_kp) bool, gray."""
    g = _normalize_gray(imgs)
    pyr, _ = gaussian_octave(g, n_scales=n_scales, with_next_base=False, mode=mode, lc=lc,
                             ladder=ladder)
    return _keypoints_from_pyr(
        pyr,
        g,
        max_kp=max_kp,
        contrast_thresh=contrast_thresh,
        edge_thresh=edge_thresh,
        border=border,
    )


def _merge_octave_keypoints(dets: list, scales: list, g: torch.Tensor, *, max_kp: int) -> dict:
    """Merge per-octave detections into one fixed-capacity set per image:
    each octave's (y, x) mapped to base-image coordinates by its scale
    (exact: strided taps decimate on image-even coordinates), then the
    top `max_kp` responses across octaves, equal responses in index order
    (octave-major, as `lax.top_k` keeps them), padded with zeros (invalid)
    when the octaves hold fewer candidates."""
    xs = torch.cat([d["xy"][..., 0] * float(s[1]) for d, s in zip(dets, scales)], dim=1)
    ys = torch.cat([d["xy"][..., 1] * float(s[0]) for d, s in zip(dets, scales)], dim=1)
    resp = torch.cat([d["resp"] for d in dets], dim=1)
    scale = torch.cat([d["scale"] for d in dets], dim=1)
    octave = torch.cat([torch.full_like(d["scale"], k) for k, d in enumerate(dets)], dim=1)
    k_take = min(max_kp, resp.shape[1])
    top, idx = torch.sort(resp, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_take], idx[:, :k_take]
    out = {
        "xy": torch.stack([xs.gather(1, idx), ys.gather(1, idx)], dim=-1).to(torch.float32),
        "octave": octave.gather(1, idx),
        "scale": scale.gather(1, idx),
        "resp": top,
    }
    pad = max_kp - k_take
    if pad:
        out = {k: torch.cat([v, v.new_zeros((v.shape[0], pad, *v.shape[2:]))], dim=1)
               for k, v in out.items()}
    out["valid"] = out["resp"] > 0.0
    out["gray"] = g
    return out


def pyramid_keypoints(
    octaves,
    scales,
    g: torch.Tensor,
    *,
    max_kp: int = 64,
    kp_per_octave: int | None = None,
    contrast_thresh: float = 0.02,
    edge_thresh: float = 10.0,
    border: int = 8,
) -> dict:
    """Octave-aware DoG keypoints from the per-octave scale bands of
    `stencil.chained_launches` (or `ref.pyramid_ref`): each octave's bands
    (B, h, w) stacked, the 3x3x3 extremum and edge tests per octave, then
    the merge into base-image coordinates.  Returns dict: xy (B, max_kp, 2)
    f32 in base-image coordinates, octave and scale (B, max_kp) i32 (the
    scale is the ladder index within the octave), resp, valid, gray (the
    base-resolution gray, which `describe_keypoints` samples)."""
    kp_per_octave = kp_per_octave or max_kp
    dets = [
        _keypoints_from_pyr(
            torch.stack(tuple(bands), dim=1),
            bands[0],
            max_kp=kp_per_octave,
            contrast_thresh=contrast_thresh,
            edge_thresh=edge_thresh,
            border=border,
        )
        for bands in octaves
    ]
    return _merge_octave_keypoints(dets, scales, g, max_kp=max_kp)


def sift_pyramid(
    imgs: torch.Tensor,
    *,
    n_octaves: int = 4,
    n_scales: int = 4,
    sigma0: float = 1.6,
    max_ksize: int = 15,
    max_kp: int = 64,
    kp_per_octave: int | None = None,
    contrast_thresh: float = 0.02,
    edge_thresh: float = 10.0,
    border: int = 8,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    ladder=None,
) -> dict:
    """Multi-octave SIFT detector over a (B, H, W) gray or (B, H, W, 3) RGB
    batch: one launch per octave for the whole batch, octave k+1's chain
    taking octave k's next-base band (`stencil.chained_launches`), each
    launch's mode resolved for its own planes.  Returns
    `pyramid_keypoints`' dict."""
    g = _normalize_gray(imgs)
    chains = pyramid_chains(n_octaves, n_scales, sigma0, max_ksize)
    outs, scales = stencil.chained_launches(g[..., None], chains, mode=mode, lc=lc,
                                            ladder=ladder)
    octaves = [tuple(b[..., 0] for b in bands) for bands in outs]
    return pyramid_keypoints(
        octaves,
        scales,
        g,
        max_kp=max_kp,
        kp_per_octave=kp_per_octave,
        contrast_thresh=contrast_thresh,
        edge_thresh=edge_thresh,
        border=border,
    )


def aligned_octave_chain(M, shape, *, n_scales: int = 4, sigma0: float = 1.6) -> tuple:
    """The warp -> incremental Gaussian ladder chain of `align_and_detect`:
    the inverse-map affine is a gather stage whose displacement bound is
    extended by the ladder's accumulated halo, and every Gaussian is a tap
    stage, so the warped gray stays live as band 0 and every scale is an
    output band of the one launch."""
    taps = ladder_taps(n_scales, sigma0)
    ladder = tuple(stencil.gaussian_stage(k, s, tap=-1) for k, s in taps)
    ey, ex = stencil.chain_halo(ladder)
    warp = stencil.warp_affine_stage(M, shape=shape, extend=(ey, ex))
    return (warp,) + ladder


def align_and_detect(
    imgs: torch.Tensor,
    M,
    *,
    n_scales: int = 4,
    max_kp: int = 64,
    contrast_thresh: float = 0.02,
    edge_thresh: float = 10.0,
    border: int = 8,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    ladder=None,
) -> dict:
    """Warp -> Gaussian ladder -> DoG keypoints on the aligned images, the
    warp fused into the octave: one launch for the whole aligned scale
    stack of a (B, H, W) gray or (B, H, W, 3) RGB batch.  M is the 2x3 dst
    -> src matrix (OpenCV WARP_INVERSE_MAP), the same for every image.
    Returns `detect_keypoints`' dict, with "gray" the warped gray."""
    g = _normalize_gray(imgs)
    chain = aligned_octave_chain(M, tuple(g.shape[-2:]), n_scales=n_scales)
    outs = stencil.fused_chain(g[..., None], chain, mode=mode, lc=lc, ladder=ladder)
    outs = [o[..., 0] for o in outs]
    return _keypoints_from_pyr(
        torch.stack(outs[1:], dim=1),  # band 0 is the warped gray
        outs[0],
        max_kp=max_kp,
        contrast_thresh=contrast_thresh,
        edge_thresh=edge_thresh,
        border=border,
    )


def gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference magnitude / orientation of (..., H, W) f32."""
    x = img.to(torch.float32)
    dx = torch.nn.functional.pad(x[..., :, 2:] - x[..., :, :-2], (1, 1)) * 0.5
    dy = torch.nn.functional.pad(x[..., 2:, :] - x[..., :-2, :], (0, 0, 1, 1)) * 0.5
    # f32 sqrt and atan2 as XLA takes them on the CPU: symmetric patches put
    # exact ties in the orientation histogram, which the last ulp decides
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    return mag, ang


def _ordered_hist(bins: torch.Tensor, vals: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., P) bin indices and values -> (..., n_bins) sums, adding the P
    samples in order (each call adds one sample per row, so there is no
    race and no reordering on any device)."""
    h = torch.zeros((*bins.shape[:-1], n_bins), dtype=torch.float32, device=vals.device)
    for p in range(bins.shape[-1]):
        h.scatter_add_(-1, bins[..., p : p + 1], vals[..., p : p + 1])
    return h


def _l2norm(d: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis by pairwise halving (the same order on
    every device); the axis length must be a power of two."""
    s = d * d
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return ref.sqrt_rn(s)


def _bin_scale(n_bins: int, device) -> torch.Tensor:
    """f32 factor that maps an angle span of 2*pi onto `n_bins` bins, as the
    JAX reference computes x / (2*pi) * n under jit: XLA turns the division
    into a product with the f32 reciprocal and folds the two constants in
    f32.  Angles on a bin edge (+-pi/2 is common) land by this constant."""
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32)
    return ((1.0 / two_pi) * n_bins).to(device)


def describe_keypoints(det: dict, *, patch: int = 16) -> dict:
    """4x4 spatial cells x 8 orientation bins = 128-d descriptors per
    keypoint, orientation-normalised by the dominant gradient bin."""
    g = det["gray"]
    B, H, W = g.shape
    mag, ang = gradients(g)
    half = patch // 2
    xy, valid = det["xy"], det["valid"]
    x0 = torch.clamp(xy[..., 0].to(torch.int64) - half, 0, W - patch)
    y0 = torch.clamp(xy[..., 1].to(torch.int64) - half, 0, H - patch)
    off = torch.arange(patch, device=g.device)
    rows = (y0[..., None] + off)[..., :, None]
    cols = (x0[..., None] + off)[..., None, :]
    bidx = torch.arange(B, device=g.device)[:, None, None, None]
    m = mag[bidx, rows, cols].reshape(*xy.shape[:2], patch * patch)
    a = ang[bidx, rows, cols].reshape(*xy.shape[:2], patch * patch)

    ob = torch.floor((a + math.pi) * _bin_scale(36, a.device)).to(torch.int64) % 36
    ohist = _ordered_hist(ob, m, 36)
    dom = torch.argmax(ohist, dim=-1).to(torch.float32) * (2 * math.pi / 36) - math.pi
    rel = torch.fmod(a - dom[..., None] + 3 * math.pi, 2 * math.pi)  # > 0: fmod == remainder
    bins = torch.floor(rel * _bin_scale(8, a.device)).to(torch.int64) % 8
    cell = off // (patch // 4)
    ci = (cell[:, None] * 4 + cell[None, :]).reshape(-1)
    d = _ordered_hist(ci * 8 + bins, m, 128)
    d = d / torch.clamp(_l2norm(d), min=1e-6)
    d = torch.clamp(d, max=0.2)
    d = d / torch.clamp(_l2norm(d), min=1e-6)
    return {"desc": torch.where(valid[..., None], d, 0.0), "valid": valid}


def sift(imgs: torch.Tensor, config: PipelineConfig | None = None) -> dict:
    """SIFT keypoints + descriptors for a batch.  ``config.n_octaves`` 1 is
    the single-octave detector; more route through `sift_pyramid` (one
    launch per octave), with keypoints in base-image coordinates and
    descriptors sampled from the base-resolution gray there.  Standalone
    calls keep the JAX package's max_kp=64 default; a passed config
    carries its own."""
    cfg = config if config is not None else PipelineConfig(max_kp=64)
    if cfg.n_octaves <= 1:
        det = detect_keypoints(imgs, max_kp=cfg.max_kp, mode=cfg.mode, lc=cfg.lc,
                               ladder=cfg.ladder)
    else:
        det = sift_pyramid(imgs, n_octaves=cfg.n_octaves, max_kp=cfg.max_kp, mode=cfg.mode,
                           lc=cfg.lc, ladder=cfg.ladder)
    d = describe_keypoints(det)
    return {"xy": det["xy"], "desc": d["desc"], "valid": det["valid"], "resp": det["resp"]}
