"""The seed (pre-fusion) kernels: one launch per op, per channel, per image
(the counterpart of `benchmarks/unfused_baseline.py`).

The baseline rung of the fused-vs-staged pipeline benchmark
(`scripts/torch_pipeline_bench.py`): what the per-op path cost before the
fused stencil engine, every intermediate plane through device memory.

`seed_gaussian_blur_2d`, `seed_erode_2d` and `seed_threshold_2d` replace
`_sep_kernel`, `_morph_kernel` and `_thresh_kernel` (TPU, Pallas) with the
hand-written CUDA kernels of ``csrc/unfused.cu``.  Bound on an H100: bytes
(one (H, W) u8 plane read and written once, 0.16 us for 512x512 at 3.35
TB/s, below a launch's latency), so the rung measures launches and per-op
traffic, which is what fusion removes.  The blur is latency-bound: a block
of `BLUR_THREADS` takes a `BLUR_ROWS` x `BLUR_COLS` tile (a 512x512 plane in
one wave), copies its window (`BLUR_PAD` columns either side) in 16-byte
segments, clamping only at the plane's edges, runs the row pass in register
strips of 4 outputs and the column pass from shared memory, one barrier
between them; the kernel is compiled per odd ksize and takes its taps by
value (`_host_taps`).  Each wrapper takes one (H, W) u8
plane: the benchmark uses u8 only, and any other dtype raises `ValueError`
(the JAX seed's other carriers are left to port, ROADMAP).

Beside each kernel is its plain PyTorch version with the same arithmetic in
the same order, so the two agree bit for bit.  A CPU tensor, or
``mode="ref"``, runs the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, counters, ref

# C signatures in csrc/unfused.cu: pointers and the stream as c_void_p, ints as c_int
LAUNCH_ARGTYPES = {
    # (in, out, taps (host f32), h, w, k, stream)
    "seed_gaussian_blur_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    # (in, out, h, w, r, stream)
    "seed_erode_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    # (in, out, h, w, t8, maxval8, stream)
    "seed_threshold_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
MODES = (None, "ref")
# seed_gaussian_blur's block (csrc/unfused.cu kBlurRows, kBlurCols,
# kBlurPad, kBlurThreads): output tile, window columns either side, threads
BLUR_ROWS = 16
BLUR_COLS = 128
BLUR_PAD = 16
BLUR_THREADS = 256


@functools.cache
def _launchers():
    lib = _build.library("unfused")
    fns = {}
    for name, argtypes in LAUNCH_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def to_u8(v: float) -> int:
    """A Python number cast to u8 as JAX casts it on the CPU: rounded to f32
    (`jnp.asarray`), truncated toward zero, then wrapped modulo 256 (-1 ->
    255, 300 -> 44, 255.99999999 -> 256.0f -> 0)."""
    return int(torch.tensor(v, dtype=torch.float32).item()) % 256


def _check_plane(name: str, img: torch.Tensor, mode) -> bool:
    """Validate one (H, W) u8 plane; True when the plain version runs."""
    if mode not in MODES:
        raise ValueError(f"{name}: unknown mode {mode!r} (expected None or 'ref')")
    if img.dtype != torch.uint8 or img.ndim != 2:
        raise ValueError(f"{name}: expected one (H, W) uint8 plane, got {img.dtype} {tuple(img.shape)}")
    return mode == "ref" or img.device.type == "cpu"


def _launcher(name: str, img: torch.Tensor):
    """The kernel's launcher (built first if needed); raise unless `img`
    lies on a CUDA device."""
    fn = _launchers()[name]
    if not img.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {img.device}")
    return fn


def _pad(img: torch.Tensor, p: int) -> torch.Tensor:
    return ref.pad_replicate(img, p, p)


# -- seed_gaussian_blur -------------------------------------------------------

@functools.cache
def _taps(ksize: int, device: str) -> torch.Tensor:
    """The Gaussian taps on the device, copied once per (ksize, device)."""
    return ref.gaussian_kernel1d(ksize).to(device)


@functools.cache
def _host_taps(ksize: int) -> ctypes.Array:
    """The Gaussian taps as a host f32 array, which the launcher passes to
    the kernel by value."""
    return (ctypes.c_float * ksize)(*ref.gaussian_kernel1d(ksize).tolist())


def seed_gaussian_blur_2d_plain(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Widened to f32, the row pass (taps left to right), then the column
    pass (top to bottom), each product and sum rounded on its own; round
    half to even and saturate to u8.  Edge-replicate border."""
    counters.PLAIN_CALLS["seed_gaussian_blur"] += 1
    k1 = _taps(ksize, str(img.device))
    h, w = img.shape
    p = ksize // 2
    x = _pad(img, p).to(torch.float32)
    row = k1[0] * x[:, 0:w]
    for j in range(1, ksize):
        row = row + k1[j] * x[:, j : j + w]
    acc = k1[0] * row[0:h]
    for i in range(1, ksize):
        acc = acc + k1[i] * row[i : i + h]
    return ref.pack(acc, torch.uint8).to(torch.uint8)


def seed_gaussian_blur_2d(img: torch.Tensor, ksize: int, *, mode: str | None = None) -> torch.Tensor:
    """OpenCV GaussianBlur (default sigma) of one (H, W) u8 plane, odd
    `ksize` up to 31, in one launch."""
    if ksize % 2 != 1 or not 1 <= ksize <= 31:
        raise ValueError(f"seed_gaussian_blur_2d: ksize must be odd in [1, 31], got {ksize}")
    if _check_plane("seed_gaussian_blur_2d", img, mode):
        return seed_gaussian_blur_2d_plain(img, ksize)
    fn = _launcher("seed_gaussian_blur_launch", img)
    img = img.contiguous()
    out = torch.empty_like(img)
    h, w = img.shape
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), out.data_ptr(), ctypes.addressof(_host_taps(ksize)), h, w, ksize,
                 _build.cuda_stream(img.device))
    _build.check(err, "seed_gaussian_blur")
    counters.LAUNCHES["seed_gaussian_blur"] += 1
    return out


# -- seed_erode ---------------------------------------------------------------

def seed_erode_2d_plain(img: torch.Tensor, r: int) -> torch.Tensor:
    """Min over 2r+1 rows, then over 2r+1 columns; edge-replicate border."""
    counters.PLAIN_CALLS["seed_erode"] += 1
    h, w = img.shape
    x = _pad(img, r)
    acc = x[0:h]
    for i in range(1, 2 * r + 1):
        acc = torch.minimum(acc, x[i : i + h])
    out = acc[:, 0:w]
    for j in range(1, 2 * r + 1):
        out = torch.minimum(out, acc[:, j : j + w])
    return out


def seed_erode_2d(img: torch.Tensor, r: int, *, mode: str | None = None) -> torch.Tensor:
    """Erosion of one (H, W) u8 plane by a (2r+1)^2 rectangle, 0 <= r <= 32,
    in one launch."""
    if not 0 <= r <= 32:
        raise ValueError(f"seed_erode_2d: r must be in [0, 32], got {r}")
    if _check_plane("seed_erode_2d", img, mode):
        return seed_erode_2d_plain(img, r)
    fn = _launcher("seed_erode_launch", img)
    img = img.contiguous()
    out = torch.empty_like(img)
    h, w = img.shape
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), out.data_ptr(), h, w, r, _build.cuda_stream(img.device))
    _build.check(err, "seed_erode")
    counters.LAUNCHES["seed_erode"] += 1
    return out


# -- seed_threshold -----------------------------------------------------------

def seed_threshold_2d_plain(img: torch.Tensor, thresh: float, maxval: float) -> torch.Tensor:
    """maxval where x > thresh else 0, `thresh` and `maxval` first cast to
    u8 (`to_u8`) and compared as integers."""
    counters.PLAIN_CALLS["seed_threshold"] += 1
    return torch.zeros_like(img).masked_fill_(img > to_u8(thresh), to_u8(maxval))


def seed_threshold_2d(
    img: torch.Tensor, thresh: float, maxval: float = 255.0, *, mode: str | None = None
) -> torch.Tensor:
    """OpenCV THRESH_BINARY of one (H, W) u8 plane with the JAX seed's
    semantics: `thresh` is cast to u8 first (so -1 means 255 and 300 means
    44), unlike the fused `threshold_stage`'s f32 compare."""
    if _check_plane("seed_threshold_2d", img, mode):
        return seed_threshold_2d_plain(img, thresh, maxval)
    fn = _launcher("seed_threshold_launch", img)
    img = img.contiguous()
    out = torch.empty_like(img)
    h, w = img.shape
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), out.data_ptr(), h, w, to_u8(thresh), to_u8(maxval),
                 _build.cuda_stream(img.device))
    _build.check(err, "seed_threshold")
    counters.LAUNCHES["seed_threshold"] += 1
    return out


# -- the seed pipeline --------------------------------------------------------

def seed_pipeline(
    batch: torch.Tensor, *, blur_ksize: int, erode_r: int, thresh: float, mode: str | None = None
) -> torch.Tensor:
    """Per op, per channel, per image, as the seed wrappers ran: (B, H, W, C)
    u8 -> (B, H, W, C) u8 in B*C*3 launches, every intermediate plane in
    device memory.  Each channel view is copied to a contiguous plane first,
    as JAX's slice materialises it; the copies are part of the rung's cost."""
    outs = []
    for b in range(batch.shape[0]):
        chans = []
        for c in range(batch.shape[-1]):
            p = batch[b, :, :, c].contiguous()
            p = seed_gaussian_blur_2d(p, blur_ksize, mode=mode)
            p = seed_erode_2d(p, erode_r, mode=mode)
            p = seed_threshold_2d(p, thresh, 255.0, mode=mode)
            chans.append(p)
        outs.append(torch.stack(chans, dim=-1))
    return torch.stack(outs)
