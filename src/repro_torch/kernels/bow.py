"""The BoW kernels on the card: nearest-word assignment for training, then the
classifier tail, quantize + histogram and the linear SVM score (the
counterpart of `repro.kernels.bow`).

`bow_assign` replaces `repro.kernels.bow._bow_kernel` (TPU, Pallas).  Bound
on an H100: operations, 2*N*K*D fp32 dot-product FLOP on CUDA cores (2.05
GFLOP at the training shape, N = 32000), against ~16.8 MB moved; the
products and sums may not be contracted, so the attainable floor is about
twice the 67 TFLOP/s bound.  It writes each row's word index and min +
|d|^2.

`bow_quantize_hist` replaces `repro.kernels.bow._hist_kernel` (TPU,
Pallas).  Bound on an H100: operations, 2*B*N*K*D fp32 dot-product FLOP on
CUDA cores (0.52 GFLOP at the predict request, B = 256 images of N = 32
rows), against ~4.3 MB moved.  Blocks own images, and a thread-block
cluster splits the codebook: a cluster of `hist_ranks(K)` CTAs of
`HIST_THREADS` serves one image, rank r searching word tiles r, r + S, ...
of the image's rows `HIST_ROWS` at a time; the ranks write their rows'
(min, word) pairs into rank 0's shared memory, and rank 0 merges them on
(value, then word), adds each row's weight to its word in ascending n,
sums the image's total weight in ascending n, divides (with
``normalize``) and writes the image's row.  No atomics, memset or cast:
one launch a call, and the same histogram from run to run, also for
fractional weights (`quantize_hist_plain` sums in the same order).

Both run one nearest-word search (``csrc/bow.cu`` `nearest_words`): a block
takes a tile of rows against codebook tiles of words, each thread a
register micro-tile, the operands staged q-major through shared memory a
chunk of q at a time with cp.async double-buffering; a running argmin per
(row, thread) over ascending words, merged across a row's threads with ties
to the lower word; |c|^2 summed once per tile inside the same loop.
`bow_assign`'s block: `SEARCH_THREADS` threads of 4 x 4, `SEARCH_ROWS`
rows, tiles of `SEARCH_WORDS` words, `SEARCH_CHUNK` values of q at a time;
`bow_quantize_hist`'s CTA: `HIST_THREADS` threads of `HIST_MICRO_ROWS` x
`HIST_MICRO_WORDS`, tiles of `HIST_WORDS` words, `HIST_CHUNK` values of q
(`scripts/torch_bow_sweep.py` times other shapes).

`linear_score` replaces `repro.kernels.bow._score_kernel`.  Bound on an
H100: latency (~1.3 MFLOP at the predict batch).  Design: one block per
tile of 16 images and 32 classes (`score_geometry`); the tile's rows of h
and w are staged into shared memory with coalesced loads, and each thread
walks one (image, class) sum over K in ascending order from there.

The kernels compute in fp32 on CUDA cores with every product and sum
rounded on its own, in ascending index order; the plain versions here do
the same arithmetic in PyTorch, so the card's kernels and the plain
versions agree bit for bit (``csrc/bow.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.device import DEFAULT, LaunchConfig
from . import _build, counters

# the nearest-word search's block (csrc/bow.cu kTileN, kTileK, kChunk,
# kThreads): rows a block takes, words of a codebook tile, values of q staged
# at a time, threads (16 x 16, each 4 rows x 4 words)
SEARCH_ROWS = 64
SEARCH_WORDS = 64
SEARCH_CHUNK = 32
SEARCH_THREADS = 256
SEARCH_MICRO = 4
# bow_quantize_hist's CTA (csrc/bow.cu kHistRows, kHistWords, kHistThreads,
# kHistChunk, kHistMicroRows, kHistMicroWords, kHistMinBlocks,
# kHistMaxRanks): rows of an image a CTA walks at a time, words of a codebook
# tile, threads, values of q staged at a time, a thread's micro-tile (rows x
# words), CTAs an SM its launch bounds ask for, CTAs a cluster may hold
HIST_ROWS = 32
HIST_WORDS = 128
HIST_THREADS = 128
HIST_CHUNK = 16
HIST_MICRO_ROWS = 4
HIST_MICRO_WORDS = 8
HIST_MIN_BLOCKS = 4
HIST_MAX_RANKS = 8
# linear_score: images and classes a block scores (csrc/bow.cu kScoreRows,
# kScoreClasses), and the shared memory a block stays within
SCORE_ROWS = 16
SCORE_CLASSES = 32
SCORE_SMEM = 48 * 1024


def normalize_hist(h: torch.Tensor) -> torch.Tensor:
    """Word counts (B, K) -> per-image frequencies, each row divided by its
    sum over K (JAX's normalisation)."""
    return h / torch.clamp(torch.sum(h, dim=1, keepdim=True), min=1e-6)


def _sequential_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, D) . b (K, D)^T -> (M, K), summed over D in ascending order with
    a rounding after every product and every sum (the kernels' order)."""
    acc = a[:, 0:1] * b[:, 0][None, :]
    for q in range(1, a.shape[1]):
        acc = acc + a[:, q : q + 1] * b[:, q][None, :]
    return acc


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x_m|^2 of every row of x (M, D), summed in the kernels' order."""
    acc = x[:, 0] * x[:, 0]
    for q in range(1, x.shape[1]):
        acc = acc + x[:, q] * x[:, q]
    return acc


def _word_scores(d: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """s = -2 d.c + |c|^2: d (M, D), centroids (K, D) -> (M, K), in the
    kernels' order and rounding."""
    c = centroids.to(torch.float32)
    return -2.0 * _sequential_dot(d.to(torch.float32), c) + _sq_norms(c)[None, :]


def bow_assign_plain(desc: torch.Tensor, centroids: torch.Tensor):
    """Plain version of the assignment kernel: desc (N, D), centroids (K, D)
    -> (word index (N,) i32, min s + |d|^2 (N,) f32), ties to the lowest
    word."""
    counters.PLAIN_CALLS["bow_assign"] += 1
    d = desc.to(torch.float32)
    s = _word_scores(d, centroids)
    idx = torch.argmin(s, dim=1)
    return idx.to(torch.int32), torch.gather(s, 1, idx[:, None])[:, 0] + _sq_norms(d)


def quantize_hist_plain(
    descs: torch.Tensor, valids: torch.Tensor, centroids: torch.Tensor, *, normalize: bool = False
):
    """Plain version of the quantize + histogram kernel: descs (B, N, D),
    valids (B, N) weights, centroids (K, D) -> word histograms (B, K): each
    row's weight added to its nearest word in ascending n; with
    ``normalize``, divided by max(total, 1e-6), the image's weights summed
    in ascending n (with {0, 1} weights bit-equal to `normalize_hist`)."""
    counters.PLAIN_CALLS["bow_quantize_hist"] += 1
    B, N, D = descs.shape
    K = centroids.shape[0]
    h = torch.zeros((B, K), dtype=torch.float32, device=descs.device)
    if B * N == 0 or K == 0:
        return h
    idx = torch.argmin(_word_scores(descs.reshape(B * N, D), centroids), dim=1).reshape(B, N)
    w = valids.to(torch.float32)
    total = torch.zeros((B,), dtype=torch.float32, device=descs.device)
    for n in range(N):  # one add a row of h, in ascending n
        h.scatter_add_(1, idx[:, n : n + 1], w[:, n : n + 1])
        total = total + w[:, n]
    return h / torch.clamp(total, min=1e-6)[:, None] if normalize else h


def linear_score_plain(hists: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the score kernel: hists (B, K), w (C, K), b (C,) ->
    (B, C) = hists . w^T + b."""
    counters.PLAIN_CALLS["linear_score"] += 1
    h, w = hists.to(torch.float32), w.to(torch.float32)
    if h.shape[1] == 0:
        acc = torch.zeros((h.shape[0], w.shape[0]), dtype=torch.float32, device=h.device)
    else:
        acc = _sequential_dot(h, w)
    return acc + b.to(torch.float32)[None, :]


def score_geometry(B: int, K: int, C: int) -> dict:
    """One `linear_score` launch: ``blocks`` (image tiles, class tiles),
    ``kc`` the columns of K a block stages at a time (the widest whose rows
    of h and w fit `SCORE_SMEM`), and ``smem`` its bytes of shared memory:
    the tile's running sums, then `SCORE_ROWS` rows of h and min(C,
    `SCORE_CLASSES`) rows of w at row stride ``kc | 1``."""
    kc, smem = _score_chunk(K, C)
    return {"blocks": (-(-B // SCORE_ROWS), -(-C // SCORE_CLASSES)), "kc": kc, "smem": smem}


@functools.cache
def _score_chunk(K: int, C: int) -> tuple[int, int]:
    nc = min(C, SCORE_CLASSES)
    room = SCORE_SMEM // 4 - SCORE_ROWS * SCORE_CLASSES
    kc = max(1, min(K, room // (SCORE_ROWS + nc) - 1))
    return kc, 4 * (SCORE_ROWS * SCORE_CLASSES + (SCORE_ROWS + nc) * (kc | 1))


# C signatures in csrc/bow.cu: pointers and the stream as c_void_p, ints as c_int
LAUNCH_ARGTYPES = {
    # (descs, cents, idx, d2, N, D, K, stream)
    "bow_assign_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    # (descs, valids, vbytes, cents, hist, B, N, D, K, normalize, stream)
    "quantize_hist_launch": [ctypes.c_void_p] * 2
    + [ctypes.c_int]
    + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    # (h, w, bias, out, B, K, C, kc, threads, stream)
    "linear_score_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


@functools.cache
def _launchers():
    lib = _build.library("bow")
    fns = {}
    for name, argtypes in LAUNCH_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def bow_assign(desc: torch.Tensor, centroids: torch.Tensor):
    """Nearest word of every descriptor: desc (N, D) or (B, N, D), centroids
    (K, D) f32 -> (word index i32, min s + |d|^2 f32) with the input's
    leading shape, in one launch.  N = 0 returns empty tensors and launches
    nothing.  A CPU tensor runs the plain version; any other tensor launches
    the kernel or raises."""
    if desc.ndim == 3:  # flattened into one (B*N, D) launch, as JAX does
        B, N, D = desc.shape
        idx, d2 = bow_assign(desc.reshape(B * N, D), centroids)
        return idx.reshape(B, N), d2.reshape(B, N)
    if desc.ndim != 2 or centroids.ndim != 2 or desc.shape[1] != centroids.shape[1]:
        raise ValueError(f"bow_assign: shapes {tuple(desc.shape)} / {tuple(centroids.shape)}")
    N, D = desc.shape
    K = centroids.shape[0]
    if K == 0 or D == 0:
        raise ValueError(f"bow_assign: needs K >= 1 words of D >= 1, got ({K}, {D})")
    if N == 0:
        return (
            torch.zeros((0,), dtype=torch.int32, device=desc.device),
            torch.zeros((0,), dtype=torch.float32, device=desc.device),
        )
    if desc.device.type == "cpu":
        return bow_assign_plain(desc, centroids)
    launch = _launchers()["bow_assign_launch"]
    dev = _build.check_cuda("bow_assign", desc, centroids)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    d2 = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            desc.data_ptr(),
            centroids.data_ptr(),
            idx.data_ptr(),
            d2.data_ptr(),
            N,
            D,
            K,
            _build.cuda_stream(dev),
        )
    _build.check(err, "bow_assign")
    counters.LAUNCHES["bow_assign"] += 1
    return idx, d2


def hist_ranks(K: int) -> int:
    """CTAs of one image's `bow_quantize_hist` cluster: one a codebook tile
    of `HIST_WORDS` words, at most `HIST_MAX_RANKS` (csrc/bow.cu
    `quantize_hist_ranks`)."""
    return min(-(-K // HIST_WORDS), HIST_MAX_RANKS)


def hist_smem_bytes() -> int:
    """Shared memory of a `bow_quantize_hist` CTA (csrc/bow.cu
    `quantize_hist_smem_bytes`): two q-major chunks of its rows and of a
    word tile (row strides + 4 floats), the tile's |c|^2 and the rows'
    |d|^2 slots, rank 0's weights and merged words, and the ranks' (min,
    word) pairs for two row tiles."""
    search = 2 * HIST_CHUNK * (HIST_ROWS + 4) + 2 * HIST_CHUNK * (HIST_WORDS + 4)
    search += HIST_WORDS + HIST_ROWS
    return 4 * (search + 2 * HIST_ROWS + 2 * 2 * HIST_MAX_RANKS * HIST_ROWS)


def bow_quantize_hist(
    descs: torch.Tensor,
    valids: torch.Tensor,
    centroids: torch.Tensor,
    *,
    normalize: bool = True,
) -> torch.Tensor:
    """Fused quantize -> histogram: descs (B, N, D) f32, valids (B, N)
    weights (bool, u8 or f32 read as they are; another dtype is cast to f32
    first), centroids (K, D) f32 -> word histograms (B, K) in one launch,
    normalised by each image's total weight with ``normalize``.  B, N or
    K = 0 returns zeros and launches nothing.  A CPU tensor runs the plain
    version; any other tensor launches the kernel or raises."""
    if descs.device.type == "cpu":
        return quantize_hist_plain(descs, valids, centroids, normalize=normalize)
    qh = _launchers()["quantize_hist_launch"]
    if descs.ndim != 3 or centroids.ndim != 2 or descs.shape[2] != centroids.shape[1]:
        raise ValueError(
            f"bow_quantize_hist: shapes {tuple(descs.shape)} / {tuple(centroids.shape)}"
        )
    B, N, D = descs.shape
    K = centroids.shape[0]
    if valids.shape != (B, N) or D == 0:
        raise ValueError(f"bow_quantize_hist: valids {tuple(valids.shape)} for descs ({B}, {N})")
    dev = _build.check_cuda("bow_quantize_hist", descs, centroids)
    if valids.device != dev:
        raise ValueError(f"bow_quantize_hist: valids on {valids.device}, descs on {dev}")
    if valids.dtype not in (torch.bool, torch.uint8, torch.float32):
        valids = valids.to(torch.float32)
    valids = valids.contiguous()
    if B * N * K == 0:
        return torch.zeros((B, K), dtype=torch.float32, device=dev)
    h = torch.empty((B, K), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = qh(
            descs.data_ptr(),
            valids.data_ptr(),
            valids.element_size(),
            centroids.data_ptr(),
            h.data_ptr(),
            B,
            N,
            D,
            K,
            int(normalize),
            _build.cuda_stream(dev),
        )
    _build.check(err, "bow_quantize_hist")
    counters.LAUNCHES["bow_quantize_hist"] += 1
    return h


def linear_score(
    hists: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, lc: LaunchConfig = DEFAULT
) -> torch.Tensor:
    """One-vs-rest decision scores: hists (B, K), w (C, K), b (C,) -> (B, C)
    in one launch.  A CPU tensor runs the plain version; any other tensor
    launches the kernel or raises."""
    if hists.device.type == "cpu":
        return linear_score_plain(hists, w, b)
    ls = _launchers()["linear_score_launch"]
    if hists.ndim != 2 or w.ndim != 2 or w.shape[1] != hists.shape[1] or b.shape != w.shape[:1]:
        raise ValueError(
            f"linear_score: shapes {tuple(hists.shape)} / {tuple(w.shape)} / {tuple(b.shape)}"
        )
    dev = _build.check_cuda("linear_score", hists, w, b)
    B, K = hists.shape
    C = w.shape[0]
    kc = _score_chunk(K, C)[0]
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    with _build.on_device(dev):
        err = ls(
            hists.data_ptr(),
            w.data_ptr(),
            b.data_ptr(),
            out.data_ptr(),
            B,
            K,
            C,
            kc,
            lc.threads,
            _build.cuda_stream(dev),
        )
    _build.check(err, "linear_score")
    counters.LAUNCHES["linear_score"] += 1
    return out
