"""The oblivious-tree GBDT head on the card (the counterpart of
`repro.kernels.gbdt`).

`gbdt_score` replaces `repro.kernels.gbdt._gbdt_kernel` (TPU, Pallas).
Bound on an H100: bytes, ~0.26 MB at the predict request (B = 256, F = 250),
under 0.1 us at 3.35 TB/s and so below a launch's latency.  Design: the TPU
kernel's four one-hot matmuls stand in for gathers the TPU lacks; here one
warp takes a row (`ROWS_PER_BLOCK` rows a block, no shared memory, so any
model size launches): lane t packs tree t's leaf index from strict `>`
compares, and lane c sums the picked leaf values over ascending trees,
each tree's index shuffled from its lane, then adds the base; trees and
classes past 32 go in chunks of 32 (``csrc/gbdt.cu``).
`gbdt_score_plain` does the same arithmetic in PyTorch, so the two agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, counters
from . import ref as kref

ROWS_PER_BLOCK = 4  # rows a gbdt_score block, one warp each (kWarps in csrc/gbdt.cu)

# C signature in csrc/gbdt.cu: pointers and the stream as c_void_p, ints as c_int
# (x, feat, thr, leaf, base, scores, lidx, B, F, T, depth, C, stream)
LAUNCH_ARGTYPES = {
    "gbdt_score_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def _check_shapes(x, feat, thr, leaf, base) -> None:
    if x.ndim != 2 or feat.ndim != 2 or thr.shape != feat.shape or leaf.ndim != 3:
        raise ValueError(
            f"gbdt_score: shapes x {tuple(x.shape)}, feat {tuple(feat.shape)}, "
            f"thr {tuple(thr.shape)}, leaf {tuple(leaf.shape)}"
        )
    T, depth = feat.shape
    if leaf.shape[1] != 2**depth:
        raise ValueError(
            f"gbdt_score: leaf table has {leaf.shape[1]} leaves for depth {depth} "
            f"(expected {2**depth})"
        )
    if leaf.shape[0] != T or base.shape != leaf.shape[2:]:
        raise ValueError(
            f"gbdt_score: leaf {tuple(leaf.shape)} / base {tuple(base.shape)} for {T} trees"
        )


def gbdt_score_plain(x, feat, thr, leaf, base):
    """Plain version of the GBDT kernel: (scores (B, C) f32, leaf indices
    (B, T) i32), the leaf values summed over ascending trees, then the base."""
    counters.PLAIN_CALLS["gbdt_score"] += 1
    li = kref.gbdt_leaf_ref(x, feat, thr)
    T = feat.shape[0]
    picked = leaf.to(torch.float32)[torch.arange(T, device=x.device)[None, :], li.long()]
    acc = torch.zeros((x.shape[0], leaf.shape[2]), dtype=torch.float32, device=x.device)
    if T:
        acc = picked[:, 0]
        for t in range(1, T):
            acc = acc + picked[:, t]
    return acc + base.to(torch.float32)[None, :], li


@functools.cache
def _launcher():
    fn = _build.library("gbdt").gbdt_score_launch
    fn.argtypes = LAUNCH_ARGTYPES["gbdt_score_launch"]
    fn.restype = ctypes.c_int
    return fn


def gbdt_score(x, feat, thr, leaf, base):
    """Oblivious-tree ensemble: x (B, F) f32, feat (T, depth) i32, thr
    (T, depth) f32, leaf (T, 2^depth, C) f32, base (C,) f32 -> (scores
    (B, C) f32, leaf indices (B, T) i32) in one launch, for a model of any
    size.  A CPU tensor runs the plain version; any other tensor launches
    the kernel or raises."""
    _check_shapes(x, feat, thr, leaf, base)
    if x.device.type == "cpu":
        return gbdt_score_plain(x, feat, thr, leaf, base)
    if x.shape[0] == 0:
        return (
            torch.zeros((0, leaf.shape[2]), dtype=torch.float32, device=x.device),
            torch.zeros((0, feat.shape[0]), dtype=torch.int32, device=x.device),
        )
    launch = _launcher()
    dev = _build.check_cuda("gbdt_score", x, thr, leaf, base)
    if feat.device != dev or feat.dtype != torch.int32 or not feat.is_contiguous():
        raise ValueError(f"gbdt_score: feat must be contiguous int32 on {dev}")
    B, F = x.shape
    T, depth = feat.shape
    C = leaf.shape[2]
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    lidx = torch.empty((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            x.data_ptr(),
            feat.data_ptr(),
            thr.data_ptr(),
            leaf.data_ptr(),
            base.data_ptr(),
            scores.data_ptr(),
            lidx.data_ptr(),
            B,
            F,
            T,
            depth,
            C,
            _build.cuda_stream(dev),
        )
    _build.check(err, "gbdt_score")
    counters.LAUNCHES["gbdt_score"] += 1
    return scores, lidx
