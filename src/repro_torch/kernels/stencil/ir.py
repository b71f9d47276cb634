"""Stage IR of the fused stencil chain: the counterpart of
`repro.kernels.stencil.ir`.

One `Stage` is one pipeline op: a name, hashable static params, tap arrays
(filter weights, f32 on the CPU; remap's (H, W) map planes, on the device
the image lies on) and an optional ``tap`` band index that switches the
stage from mapping over the band state to appending its result.
`resolve_chain` is the static band-arity walk every executor consumes.

Every op of the JAX IR is ported: ``filter2d``, ``sep_filter`` (and its
Gaussian builder), ``box``, ``erode``, ``dilate``, ``threshold``,
``affine``, ``grad_mag`` (and its pair reduction), ``sobel``, the strided
``pyr_down`` and ``resize2``, the 2x upsample ``pyr_up``, and the gathers
``warp_affine`` and ``remap`` with the displacement-bound helpers they
share with the planner.  `validate_next_base` is the cross-launch contract
of a pyramid link.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .. import ref

# tap arrays each ported op carries (remap's two are its map planes)
_N_WEIGHTS = {
    "filter2d": 1,
    "sep_filter": 2,
    "box": 0,
    "erode": 0,
    "dilate": 0,
    "threshold": 0,
    "affine": 0,
    "grad_mag": 0,
    "pyr_down": 1,
    "resize2": 0,
    "sobel": 0,
    "warp_affine": 0,
    "remap": 2,
    "pyr_up": 0,
}
# (row, col) output decimation of the strided ops
STRIDES = {"pyr_down": (2, 2), "resize2": (2, 2)}
# (row, col) output upsample factor (a fractional stride)
UPSAMPLES = {"pyr_up": (2, 2)}
# gather stages: they read data-dependent (statically bounded) offsets at
# the band's absolute image coordinates
GATHER_OPS = frozenset({"warp_affine", "remap"})


def _gather_halo(by: float, bx: float) -> tuple[int, int]:
    """Halo a gather stage consumes per side for a (row, col) displacement
    bound: floor(b) rows of reach + 1 for the far bilinear tap."""
    return int(math.floor(by)) + 1, int(math.floor(bx)) + 1


@dataclass(frozen=True, eq=False)
class Stage:
    """One pipeline stage: `op` + hashable static params + tap arrays.

    `tap` (a band index, negatives allowed) makes the stage read band
    `tap` and append its result to the band state instead of mapping over
    every band.
    """

    op: str
    static: tuple = ()
    weights: tuple = field(default_factory=tuple)
    tap: int | None = None

    def __post_init__(self):
        if self.op not in _N_WEIGHTS:
            raise ValueError(f"unknown stage op {self.op!r}")
        if len(self.weights) != _N_WEIGHTS[self.op]:
            raise ValueError(
                f"{self.op} takes {_N_WEIGHTS[self.op]} weight arrays, got {len(self.weights)}"
            )

    @property
    def halo(self) -> tuple[int, int]:
        """(row, col) halo this stage consumes per side (single-band form)."""
        if self.op == "filter2d":
            kh, kw = self.weights[0].shape
            return kh // 2, kw // 2
        if self.op == "sep_filter":
            kx, ky = self.weights
            return ky.shape[0] // 2, kx.shape[0] // 2
        if self.op in ("erode", "dilate", "box"):
            return self.static[0], self.static[0]
        if self.op in ("grad_mag", "sobel", "pyr_up"):
            return 1, 1
        if self.op == "pyr_down":
            return 2, 2
        if self.op == "warp_affine":
            return _gather_halo(self.static[6], self.static[7])
        if self.op == "remap":
            by, bx, ey, ex = self.static
            return _gather_halo(by + ey, bx + ex)
        return 0, 0

    @property
    def stride(self) -> tuple[int, int]:
        """(row, col) output decimation factor."""
        return STRIDES.get(self.op, (1, 1))

    @property
    def upsample(self) -> tuple[int, int]:
        """(row, col) output upsample factor: 2 for pyrUp, else 1."""
        return UPSAMPLES.get(self.op, (1, 1))


def filter_stage(kernel, *, tap: int | None = None) -> Stage:
    """Direct 2D correlation with an odd (kh, kw) tap matrix."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32).cpu()
    return Stage("filter2d", weights=(kernel,), tap=tap)


def sep_filter_stage(kx, ky, *, tap: int | None = None) -> Stage:
    """Separable filter: row taps kx (kw,), then column taps ky (kh,)."""
    kx = torch.as_tensor(kx, dtype=torch.float32).cpu()
    ky = torch.as_tensor(ky, dtype=torch.float32).cpu()
    return Stage("sep_filter", weights=(kx, ky), tap=tap)


def gaussian_stage(ksize: int, sigma: float | None = None, *, tap: int | None = None) -> Stage:
    """OpenCV GaussianBlur as a separable stage."""
    k1 = ref.gaussian_kernel1d(ksize, sigma)
    return sep_filter_stage(k1, k1, tap=tap)


def erode_stage(r: int) -> Stage:
    """Rectangular (2r+1)^2 erosion."""
    return Stage("erode", static=(int(r),))


def dilate_stage(r: int) -> Stage:
    return Stage("dilate", static=(int(r),))


def box_stage(r: int, *, tap: int | None = None) -> Stage:
    """OpenCV blur(): normalised (2r+1)^2 box filter."""
    return Stage("box", static=(int(r),), tap=tap)


def threshold_stage(thresh: float, maxval: float = 255.0) -> Stage:
    """Binary threshold: maxval where x > thresh else 0 (OpenCV
    THRESH_BINARY), compared in f32 so a fractional threshold binds on a u8
    carrier (127.5 means x >= 128)."""
    return Stage("threshold", static=(float(thresh), float(maxval)))


def affine_stage(scale: float, offset: float = 0.0) -> Stage:
    """Pointwise saturating scale*x + offset (OpenCV convertScaleAbs-style)."""
    return Stage("affine", static=(float(scale), float(offset)))


def grad_stage() -> Stage:
    """Gradient magnitude sqrt(dx^2 + dy^2).  On a single-band state:
    central differences (halo 1); after a `sobel_stage()` (or any >= 2-band
    state): the last two bands as the dx / dy pair (halo 0), packed to the
    chain's carrier."""
    return Stage("grad_mag")


def sobel_stage() -> Stage:
    """OpenCV Sobel ksize=3 pair: replaces the last band with widened f32
    dx = [1,2,1]^T (x) [-1,0,1] and dy = dx^T bands."""
    return Stage("sobel")


def pyr_down_stage(*, tap: int | None = None) -> Stage:
    """OpenCV pyrDown: the 5-tap [1,4,6,4,1]/16 separable Gaussian, then 2x
    decimation on even image coordinates; out = ceil(size/2).  As a map
    stage it downsamples the whole state; as a terminal tap it appends the
    next pyramid octave's base beside the full-resolution bands."""
    k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32) / 16.0
    return Stage("pyr_down", weights=(k1,), tap=tap)


def resize2_stage(*, tap: int | None = None) -> Stage:
    """2x downsample by 2x2 mean (`cv.imgproc.resize_half`); out =
    floor(size/2)."""
    return Stage("resize2", tap=tap)


def pyr_up_stage() -> Stage:
    """OpenCV pyrUp: the 2x zero-insert upsample convolved with 4x the 5-tap
    [1,4,6,4,1]/16 Gaussian; per axis the even output phase is [1,6,1]/8
    and the odd one [4,4]/8; out = 2*size.  Map-only: an upsampled tap
    would leave the band state at two resolutions mid-chain."""
    return Stage("pyr_up")


def _affine_disp_over(m, min_y, max_y, min_x, max_x) -> tuple[float, float]:
    """Max (row, col) |dst -> src displacement| of the 2x3 affine m over a
    coordinate rectangle.  The displacement is affine in (x, y), so the max
    sits at the corners.  Shared by `affine_disp_bound` (the declaration)
    and the planner's check (`plan.gather_metas`), so the two agree."""
    by = bx = 0.0
    for yc in (float(min_y), float(max_y)):
        for xc in (float(min_x), float(max_x)):
            bx = max(bx, abs(m[0][0] * xc + m[0][1] * yc + m[0][2] - xc))
            by = max(by, abs(m[1][0] * xc + m[1][1] * yc + m[1][2] - yc))
    return by, bx


def _matrix(M) -> list:
    """A 2x3 matrix as two rows of Python floats (f64)."""
    m = torch.as_tensor(M, dtype=torch.float64).cpu().reshape(2, 3).tolist()
    return [[float(v) for v in row] for row in m]


def affine_disp_bound(M, shape, *, extend=(0, 0)) -> tuple[float, float]:
    """Max (row, col) |dst -> src displacement| of the inverse-map affine M
    over the (h, w) image rectangle extended by `extend` per side (the halo
    ring a fused chain's later stages evaluate the warp at)."""
    h, w = int(shape[0]), int(shape[1])
    ey, ex = extend
    return _affine_disp_over(_matrix(M), -float(ey), h - 1.0 + ey, -float(ex), w - 1.0 + ex)


def warp_affine_stage(M, *, bound=None, shape=None, extend=(0, 0), tap: int | None = None) -> Stage:
    """Inverse-map affine warp (OpenCV warpAffine with WARP_INVERSE_MAP):
    dst(x, y) = the bilinear src sample at (M00*x + M01*y + M02, M10*x +
    M11*y + M12), replicate border.  M is held static (f64 here, rounded to
    f32 where it is applied); its displacement bound sizes the gather halo:
    pass `bound=(rows, cols)`, or `shape=(h, w)` (+ `extend=(rows, cols)`
    when later stages consume a halo ring) to compute it.  The planner
    re-checks it against what the chain evaluates and raises when it is
    too small."""
    m = _matrix(M)
    if bound is None:
        if shape is None:
            raise ValueError(
                "warp_affine_stage: pass bound=(rows, cols) or shape=(h, w) to size the gather halo"
            )
        bound = affine_disp_bound(m, shape, extend=extend)
    static = tuple(v for row in m for v in row) + (float(bound[0]), float(bound[1]))
    return Stage("warp_affine", static=static, tap=tap)


def remap_stage(map_x, map_y, *, bound=None, extend=(0, 0), tap: int | None = None) -> Stage:
    """OpenCV remap: dst(x, y) = the bilinear src sample at (map_x[y, x],
    map_y[y, x]), replicate border.  The (H, W) f32 map planes stay on the
    device they are given on (the image's, for a launch).  `bound` is the
    largest in-image (row, col) displacement |map - identity|, computed
    from the maps when omitted; `extend` budgets the extra displacement of
    a downstream halo ring, where out-of-image lookups clamp to the map
    edge, so the displacement grows 1:1 with the overhang."""
    mx = torch.as_tensor(map_x, dtype=torch.float32).contiguous()
    my = torch.as_tensor(map_y, dtype=torch.float32, device=mx.device).contiguous()
    if mx.ndim != 2 or mx.shape != my.shape:
        raise ValueError(
            f"remap_stage: map planes must share one (H, W) shape, got "
            f"{tuple(mx.shape)} and {tuple(my.shape)}"
        )
    if bound is None:
        hm, wm = my.shape
        rows = torch.arange(hm, dtype=torch.float64, device=my.device)[:, None]
        cols = torch.arange(wm, dtype=torch.float64, device=mx.device)[None, :]
        bound = (
            float((my.double() - rows).abs().max()),
            float((mx.double() - cols).abs().max()),
        )
    static = (float(bound[0]), float(bound[1]), float(extend[0]), float(extend[1]))
    return Stage("remap", static=static, weights=(mx, my), tap=tap)


def resolve_chain(stages) -> list:
    """Static chain walk.  Returns per-stage records ``(op, mode, halo,
    stride, up, bands_in, bands_out, tap)``; mode is map, tap, emit or
    reduce, and ``tap`` is the normalised source band of a tap stage.  A
    Sobel emits (replaces the last band with its dx / dy pair), grad_mag
    over two or more live bands reduces the last two, an upsampling stage
    is map-only, and a strided stage that is not a map must be the chain's
    last (JAX's contract); a strided map stage may sit anywhere."""
    n = 1
    out = []
    for s in stages:
        op = s.op
        tap = getattr(s, "tap", None)
        halo = tuple(s.halo)
        if op == "sobel":
            if tap is not None:
                raise ValueError("sobel stage does not support tap=")
            mode, n2 = "emit", n + 1
        elif op == "grad_mag" and n >= 2:
            mode, halo, n2 = "reduce", (0, 0), n - 1
        elif tap is not None:
            if tuple(s.upsample) != (1, 1):
                raise ValueError(
                    f"upsampling stage {op!r} does not support tap= (mixed-resolution states "
                    "are map-only)"
                )
            if not -n <= tap < n:
                raise ValueError(f"stage {op!r}: tap={tap} out of range for {n} live band(s)")
            tap = tap % n
            mode, n2 = "tap", n + 1
        else:
            mode, n2 = "map", n
        out.append((op, mode, halo, tuple(s.stride), tuple(s.upsample), n, n2, tap))
        n = n2
    for i, (op, mode, _h, stride, *_rest) in enumerate(out):
        if stride != (1, 1) and mode != "map" and i != len(out) - 1:
            raise ValueError(
                f"strided {mode} stage {op!r} must be the final stage of the chain "
                "(geometry-changing taps are terminal)"
            )
    return out


def validate_next_base(stages) -> int:
    """The next-base contract of a pyramid link: a chain whose last output
    band feeds the next launch must end with a strided terminal tap (e.g.
    `pyr_down_stage(tap=...)`), so that band is the downsampled base of the
    next link while the full-resolution bands stay products.  Returns the
    carry band's index in the chain's output tuple (always the last)."""
    op, mode, _halo, stride, _up, _n_in, n_out, _tap = resolve_chain(stages)[-1]
    if mode != "tap" or stride == (1, 1):
        raise ValueError(
            f"next_base contract: the final stage ({op!r}, mode {mode!r}, stride {stride}) is "
            "not a strided terminal tap; a pyramid link must end with e.g. "
            "pyr_down_stage(tap=...) so its last output band is the next launch's base"
        )
    return n_out - 1
