"""Stage IR of the fused stencil chain: the counterpart of
`repro.kernels.stencil.ir`.

One `Stage` is one pipeline op: a name, hashable static params, tap arrays
(filter weights, f32 on the CPU) and an optional ``tap`` band index that
switches the stage from mapping over the band state to appending its
result.  `resolve_chain` is the static band-arity walk every executor
consumes.

Ported so far: ``filter2d``, ``sep_filter`` (and its Gaussian builder),
``box``, ``erode``, ``dilate``, ``threshold``, ``affine``, ``grad_mag``
and the strided ``pyr_down``.  The JAX IR's other ops are queued
(ROADMAP, the chain kernel's stage bodies (c)-(e)) and raise
`NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import ref

# tap arrays each ported op carries
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
}
# (row, col) output decimation of the strided ops
STRIDES = {"pyr_down": (2, 2)}
# ops of the JAX IR whose port is queued
QUEUED_OPS = frozenset(
    {
        "resize2",
        "sobel",
        "warp_affine",
        "remap",
        "pyr_up",
    }
)


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
        if self.op in QUEUED_OPS:
            raise NotImplementedError(f"stage op {self.op!r} is not ported yet")
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
        if self.op == "grad_mag":
            return 1, 1
        if self.op == "pyr_down":
            return 2, 2
        return 0, 0

    @property
    def stride(self) -> tuple[int, int]:
        """(row, col) output decimation factor."""
        return STRIDES.get(self.op, (1, 1))

    @property
    def upsample(self) -> tuple[int, int]:
        return 1, 1


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
    """Gradient magnitude sqrt(dx^2 + dy^2) by central differences (halo 1)
    on a single-band state; after a >= 2-band state it is the pair
    reduction, which is not ported yet."""
    return Stage("grad_mag")


def pyr_down_stage(*, tap: int | None = None) -> Stage:
    """OpenCV pyrDown: the 5-tap [1,4,6,4,1]/16 separable Gaussian, then 2x
    decimation on even image coordinates; out = ceil(size/2).  As a map
    stage it downsamples the whole state; as a terminal tap it appends the
    next pyramid octave's base beside the full-resolution bands."""
    k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32) / 16.0
    return Stage("pyr_down", weights=(k1,), tap=tap)


def resolve_chain(stages) -> list:
    """Static chain walk.  Returns per-stage records ``(op, mode, halo,
    stride, up, bands_in, bands_out, tap)``; mode is map, tap, emit or
    reduce, and ``tap`` is the normalised source band of a tap stage."""
    n = 1
    out = []
    for s in stages:
        op = s.op
        tap = getattr(s, "tap", None)
        halo = tuple(s.halo)
        if op == "grad_mag" and n >= 2:
            mode, halo, n2 = "reduce", (0, 0), n - 1
        elif tap is not None:
            if not -n <= tap < n:
                raise ValueError(f"stage {op!r}: tap={tap} out of range for {n} live band(s)")
            tap = tap % n
            mode, n2 = "tap", n + 1
        else:
            mode, n2 = "map", n
        out.append((op, mode, halo, tuple(s.stride), tuple(s.upsample), n, n2, tap))
        n = n2
    return out
