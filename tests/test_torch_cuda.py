"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc, and skips
elsewhere (the decision is taken in a fixture, never at import).  Run them
on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.

Tolerances: the plain versions repeat the kernels' arithmetic (every
product and sum rounded on its own, in the same order), so the bow and
gbdt kernels must match exactly, `stencil_stream` exactly on u8 and f32,
and `stencil_chain` within the repo's f32 oracle tolerance (rtol 2e-5,
atol 2e-3) in its older test and exactly in the mode-agreement test and
on the geometric chains (Sobel, the pair reduction, resize2, the
gathers), whose every band must equal the plain version's in dtype, shape
and bits.
`flash_attention` sums its dot products in another order than its plain
version and the f32 oracle, and each rounds once to the output dtype, so
it is held to `kernels.attention.AGREE`: one rounding apart in f16 / bf16
(rtol 2^-10 / 2^-7, atol 1e-4), rtol = atol = 2e-4 in f32 (the JAX kernel
test's, tests/test_kernels_attention.py:20).
"""

import ctypes
import math
import shutil
import subprocess

import pytest
import torch

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features, pipeline
from repro_torch.cv.config import PipelineConfig
from repro_torch.data.synthetic import ImageStream
from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import bow as kbow
from repro_torch.kernels import counters
from repro_torch.kernels import gbdt as kgbdt
from repro_torch.kernels import ops, ref, stencil, unfused
from repro_torch.kernels.stencil import exec_streaming
from repro_torch.models.lm import LM
from repro_torch.serve import cv_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _chains():
    return {
        "preprocess": (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage()),
        "octave": features.octave_chain(4, with_next_base=False),
        "octave_nb": features.octave_chain(4),
        "pyr_down": (stencil.pyr_down_stage(),),
        "taps_only": (stencil.gaussian_stage(3, tap=0), stencil.gaussian_stage(5, tap=-1)),
    }


@pytest.mark.parametrize("name", ["preprocess", "octave", "taps_only", "octave_nb", "pyr_down"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 70, 45, 2), (3, 7, 9, 1)])
@pytest.mark.parametrize("tile", [32, 8])
def test_stencil_chain_matches_plain(dev, name, shape, tile):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.rand(shape, generator=g, device=dev) * 255.0
    chain = _chains()[name]
    lc = LaunchConfig(tile_rows=tile, tile_cols=tile)
    counters.reset()
    got = stencil.fused_chain(x, chain, mode="window", lc=lc)
    want = stencil.fused_chain(x, chain, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_chain"] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-3)


def _slice_chains():
    k1 = stencil.filter_stage(torch.outer(*(2 * (ref.gaussian_kernel1d(13),))))
    return {
        **_chains(),
        "filter2d_k13": (k1,),
        "erode_r3": (stencil.erode_stage(3),),
        "acceptance": (stencil.gaussian_stage(5), stencil.erode_stage(1),
                       stencil.threshold_stage(100.0)),
        "mixed": (stencil.box_stage(1), stencil.gaussian_stage(3, tap=0), stencil.dilate_stage(1),
                  stencil.affine_stage(0.5, 3.25), stencil.gaussian_stage(5, tap=-1)),
    }


def _image(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    return torch.rand(shape, generator=g, device=dev) * 255.0


@pytest.mark.parametrize("name", ["preprocess", "octave", "taps_only", "filter2d_k13",
                                  "erode_r3", "acceptance", "mixed", "octave_nb", "pyr_down"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,lc", [
    ((2, 37, 53, 3), LaunchConfig()),
    ((1, 300, 211, 1), LaunchConfig(row_segments=5, stream_rows=4)),
    ((1, 77, 640, 1), LaunchConfig(tile2d_cols=96, row_segments=3)),
])
@pytest.mark.parametrize("mode", ["streaming", "tiled2d"])
def test_stencil_stream_matches_plain(dev, name, dtype, shape, lc, mode):
    """Bit for bit against the plain version, in one launch, on ragged
    tiles, several row segments and heights that are not whole steps."""
    x = _image(dev, shape, dtype, seed=sum(shape))
    chain = _slice_chains()[name]
    counters.reset()
    if mode == "streaming" and stencil.resolve_mode(chain, shape[:0] + (1,) + shape[1:3], dtype,
                                                    lc) == "tiled2d":
        # full-width rings over the budget: the explicit plan refuses
        with pytest.raises(ValueError, match="bytes"):
            stencil.fused_chain(x, chain, mode=mode, lc=lc)
        assert sum(counters.LAUNCHES.values()) == 0
        return
    got = stencil.fused_chain(x, chain, mode=mode, lc=lc)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_stream"] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = stencil.fused_chain(x, chain, mode="ref")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["acceptance", "filter2d_k13", "mixed", "octave", "octave_nb",
                                  "pyr_down"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_window_streaming_and_tiled2d_are_bit_identical(dev, name, dtype):
    x = _image(dev, (2, 96, 130, 1), dtype, seed=3)
    chain = _slice_chains()[name]
    outs = {}
    for mode in ("window", "streaming", "tiled2d"):
        lc = LaunchConfig(tile2d_cols=64) if mode == "tiled2d" else LaunchConfig()
        o = stencil.fused_chain(x, chain, mode=mode, lc=lc)
        outs[mode] = o if isinstance(o, tuple) else (o,)
    for mode in ("streaming", "tiled2d"):
        for a, b in zip(outs[mode], outs["window"], strict=True):
            assert torch.equal(a, b), mode


def test_streaming_over_the_budget_raises_on_the_card(dev):
    # f32 rings: a 4K k=13 input ring of 20 rows takes ~300 KB
    x = torch.zeros((2160, 3840), dtype=torch.float32, device=dev)
    counters.reset()
    with pytest.raises(ValueError, match="bytes"):
        stencil.fused_chain(x, _slice_chains()["filter2d_k13"], mode="streaming")
    assert counters.snapshot()["launches"]["stencil_stream"] == 0


@pytest.mark.parametrize("name", ["filter2d_k13", "erode_r3", "acceptance", "preprocess",
                                  "mixed"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", [(1, 37, 33, 1), (1, 301, 1919, 1), (1, 45, 3841, 1),
                                   (2, 19, 1920, 1)])
@pytest.mark.parametrize("mode", ["streaming", "tiled2d"])
def test_stencil_stream_odd_sizes_match_plain(dev, name, dtype, shape, mode):
    """Widths that are not a multiple of 16 (so rows of the plane do not
    align with the rings' 16-byte rows), odd heights and row segments that
    start mid-plane: the kernel's copies and edge columns, bit for bit."""
    x = _image(dev, shape, dtype, seed=sum(shape))
    chain = _slice_chains()[name]
    lc = LaunchConfig(row_segments=3)
    counters.reset()
    planes = (shape[0] * shape[3], shape[1], shape[2])
    if mode == "streaming" and stencil.resolve_mode(chain, planes, dtype, lc) == "tiled2d":
        with pytest.raises(ValueError, match="bytes"):
            stencil.fused_chain(x, chain, mode=mode, lc=lc)
        return
    got = stencil.fused_chain(x, chain, mode=mode, lc=lc)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_stream"] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = stencil.fused_chain(x, chain, mode="ref")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_stencil_stream_static_smem_is_the_planners(dev):
    """No static shared memory: the program's table is dynamic, sized per
    chain (`StreamProgram.table_smem`), and laid out as the planner packs
    it."""
    lib = _build.library("stencil_stream")
    assert [lib.stencil_stream_static_bytes(u8) for u8 in (0, 1)] == [0, 0]
    sizes = (ctypes.c_int * 3)()
    lib.stencil_stream_layout(sizes)
    assert list(sizes) == [4 * exec_streaming.HEADER_INTS, 4 * len(exec_streaming._STEP_FIELDS),
                           4 * len(exec_streaming._STREAM_FIELDS)]


@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", [(1081, 1919), (37, 53), (5, 5), (2, 64, 48, 3)])
def test_pyr_down_matches_plain(dev, mode, dtype, shape):
    """`ops.pyr_down` in one launch, bit for bit, at odd and even sizes."""
    x = _image(dev, shape, dtype, seed=sum(shape))
    lc = LaunchConfig(tile2d_cols=64, row_segments=3) if mode == "tiled2d" else LaunchConfig()
    counters.reset()
    got = ops.pyr_down(x, mode=mode, lc=lc)
    torch.cuda.synchronize()
    kernel = "stencil_chain" if mode == "window" else "stencil_stream"
    assert counters.LAUNCHES[kernel] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = ops.pyr_down(x, mode="ref")
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("shape", [(37, 53), (512, 512), (1081, 1919)])
def test_seed_gaussian_blur_matches_plain(dev, ksize, shape):
    x = _image(dev, shape, torch.uint8, seed=ksize + shape[0])
    counters.reset()
    got = unfused.seed_gaussian_blur_2d(x, ksize)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_gaussian_blur"] == 1
    assert torch.equal(got, unfused.seed_gaussian_blur_2d(x, ksize, mode="ref"))


# one pixel, one row, one column, odd sizes, a width that is a multiple of
# 16, the benchmark's plane and an odd 1080p
SEED_SHAPES = [(1, 1), (1, 300), (300, 1), (37, 53), (511, 513), (48, 512), (512, 512),
               (1081, 1919)]
SEED_THRESHOLDS = [0, 100.5, 254.5, 255.9, 255.99999999, 256, -0.5, -1, -5, 300, 511.7, -256]


@pytest.mark.parametrize("r", [0, 1, 2, 3, 7, 12, 32])
@pytest.mark.parametrize("shape", SEED_SHAPES)
def test_seed_erode_matches_plain(dev, r, shape):
    """r = 0..3 (a kernel each) and the generic bodies at 7, 12 and 32, bit for bit."""
    x = _image(dev, shape, torch.uint8, seed=r + shape[1])
    counters.reset()
    got = unfused.seed_erode_2d(x, r)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_erode"] == 1
    assert torch.equal(got, unfused.seed_erode_2d(x, r, mode="ref"))


@pytest.mark.parametrize("thresh", SEED_THRESHOLDS)
@pytest.mark.parametrize("shape", SEED_SHAPES)
def test_seed_threshold_matches_plain(dev, thresh, shape):
    """Every threshold of the table on every shape, every u8 value present
    where the plane has room for it."""
    x = _image(dev, shape, torch.uint8, seed=shape[0] + shape[1])
    n = min(256, x.numel())
    x.view(-1)[:n] = torch.arange(n, device=dev).to(torch.uint8)
    counters.reset()
    got = unfused.seed_threshold_2d(x, thresh)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_threshold"] == 1
    assert torch.equal(got, unfused.seed_threshold_2d(x, thresh, mode="ref"))


@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("shape", [(1, 300), (37, 53), (48, 512), (512, 512)])
def test_seed_erode_and_threshold_on_unaligned_views(dev, offset, shape):
    """A contiguous plane at an odd (or 8-byte) address, as a slice of a
    larger buffer at an element offset is, and a column slice made
    contiguous: both kernels bit-equal to their plain versions."""
    h, w = shape
    flat = _image(dev, (h * w + 16,), torch.uint8, seed=offset + w)
    views = [flat[offset:offset + h * w].view(h, w),
             _image(dev, (h, w + 8), torch.uint8, seed=offset)[:, 3:3 + w].contiguous()]
    assert views[0].is_contiguous() and views[0].data_ptr() % 16 == (flat.data_ptr() + offset) % 16 != 0
    for x in views:
        for r in (0, 1, 3, 7):
            assert torch.equal(unfused.seed_erode_2d(x, r), unfused.seed_erode_2d(x, r, mode="ref"))
        for t in (0, 100.5, -1, 255.9):
            assert torch.equal(unfused.seed_threshold_2d(x, t),
                               unfused.seed_threshold_2d(x, t, mode="ref"))
    torch.cuda.synchronize()


def test_seed_erode_and_threshold_are_deterministic(dev):
    """100 runs of each kernel on one 512x512 plane give one result."""
    x = _image(dev, (512, 512), torch.uint8, seed=5)
    for fn in (lambda: unfused.seed_erode_2d(x, 1), lambda: unfused.seed_erode_2d(x, 7),
               lambda: unfused.seed_threshold_2d(x, 100.0)):
        first = fn()
        assert all(torch.equal(fn(), first) for _ in range(100))


def test_seed_pipeline_launches_per_plane_and_equals_staged(dev):
    """B*C launches of each seed kernel, no plain call; equal to its plain
    version and to the staged per-op path through the fused engine."""
    batch = _image(dev, (2, 40, 72, 3), torch.uint8, seed=9)
    counters.reset()
    got = unfused.seed_pipeline(batch, blur_ksize=5, erode_r=1, thresh=100.0)
    torch.cuda.synchronize()
    snap = counters.snapshot()
    assert {k: snap["launches"][k] for k in ("seed_gaussian_blur", "seed_erode",
                                             "seed_threshold")} == dict.fromkeys(
        ("seed_gaussian_blur", "seed_erode", "seed_threshold"), 6)
    assert sum(snap["plain_calls"].values()) == 0
    want = unfused.seed_pipeline(batch, blur_ksize=5, erode_r=1, thresh=100.0, mode="ref")
    assert torch.equal(got, want)
    staged = torch.stack([torch.stack([
        ops.threshold(ops.erode(ops.gaussian_blur(batch[b, :, :, c], 5), 1), 100.0)
        for c in range(3)], -1) for b in range(2)])
    assert torch.equal(got, staged)


@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (2, 45, 128, 5), (1, 1, 16, 33)])
def test_bow_quantize_hist_matches_plain(dev, B, N, D, K):
    g = torch.Generator(device=dev).manual_seed(B * N + K)
    descs = torch.randn((B, N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    valids = torch.rand((B, N), generator=g, device=dev) < 0.8
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
    want = kbow.quantize_hist_plain(descs, valids, cents)
    assert torch.equal(got, want)


def test_bow_quantize_hist_ties_and_pad_words(dev):
    """Eight words, four of them duplicates (bit-identical s: the lower index
    wins), in a 32-row codebook tile whose 24 pad rows must never win.  The
    descriptors point away from every word, so each real s is > 0 and an
    unmasked zero pad row (s = 0) would take every descriptor."""
    base = torch.rand((4, 32), device=dev) + 1.0
    cents = torch.cat([base, base.flip(0)])
    descs = (-base)[None].repeat(2, 1, 1)
    valids = torch.ones((2, 4), dtype=torch.bool, device=dev)
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
    assert torch.equal(got, kbow.quantize_hist_plain(descs, valids, cents))
    assert torch.equal(got.sum(1), torch.full((2,), 4.0, device=dev))
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


@pytest.mark.parametrize("N,D,K", [(32768, 128, 250), (45, 16, 33), (1, 8, 1)])
def test_bow_assign_matches_plain(dev, N, D, K):
    """Random descriptors, then two rows that tie exactly (a duplicated word)
    and a codebook whose last tile is mostly pad rows (K % 32 != 0)."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    desc = torch.randn((N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    if K > 2:
        cents[K - 1] = cents[1]  # a duplicate: ties go to word 1
        desc[0] = cents[1] + 1e-3
    counters.reset()
    got_i, got_d2 = kbow.bow_assign(desc, cents)
    want_i, want_d2 = kbow.bow_assign_plain(desc, cents)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["bow_assign"] == 1
    assert torch.equal(got_i, want_i) and torch.equal(got_d2, want_d2)
    if K > 2:
        assert int(got_i[0]) == 1


def test_bow_assign_ties_and_pad_words(dev):
    """The quantize test's codebook: duplicate words (the lower index wins)
    in a tile whose pad rows must never win; batched input keeps its shape."""
    base = torch.rand((4, 32), device=dev) + 1.0
    cents = torch.cat([base, base.flip(0)])
    descs = (-base)[None].repeat(2, 1, 1)
    got_i, got_d2 = kbow.bow_assign(descs, cents)
    want_i, want_d2 = kbow.bow_assign_plain(descs.reshape(8, 32), cents)
    assert got_i.shape == (2, 4)
    assert torch.equal(got_i.reshape(8), want_i) and torch.equal(got_d2.reshape(8), want_d2)
    assert bool((got_i < 4).all())
    empty_i, _ = kbow.bow_assign(torch.zeros((0, 32), device=dev), cents)
    assert empty_i.shape == (0,)


@pytest.mark.parametrize(
    "B,F,T,depth,C",
    [
        (1024, 250, 16, 3, 10),
        (5, 7, 3, 2, 1),
        (256, 250, 40, 3, 10),  # more trees than a warp's lanes
        (256, 250, 16, 3, 33),  # more classes than a warp's lanes
        (1, 250, 16, 3, 10),
        (7, 250, 16, 3, 10),  # B not a multiple of the block's 4 rows
        (256, 250, 64, 8, 10),  # a 655,360-byte leaf table, over one block's shared memory
    ],
)
def test_gbdt_score_matches_plain(dev, B, F, T, depth, C):
    """Bit-equal to the plain version in scores and leaf indices, one
    launch, at any model size: the kernel stages nothing in shared memory,
    so its launcher has no `cudaFuncSetAttribute` and no size check."""
    assert "cudaFuncSetAttribute" not in (_build.CSRC / "gbdt.cu").read_text()
    g = torch.Generator(device=dev).manual_seed(B + F)
    x = torch.rand((B, F), generator=g, device=dev)
    feat = torch.randint(0, F, (T, depth), generator=g, device=dev, dtype=torch.int32)
    thr = torch.rand((T, depth), generator=g, device=dev)
    leaf = torch.randn((T, 2**depth, C), generator=g, device=dev)
    base = torch.randn((C,), generator=g, device=dev)
    feat[0] = torch.arange(depth, dtype=torch.int32, device=dev)
    x[: min(B, 4), :depth] = thr[0]  # x == thr goes left at every level of tree 0
    counters.reset()
    got_s, got_li = kgbdt.gbdt_score(x, feat, thr, leaf, base)
    want_s, want_li = kgbdt.gbdt_score_plain(x, feat, thr, leaf, base)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["gbdt_score"] == 1
    assert torch.equal(got_li, want_li) and torch.equal(got_s, want_s)
    assert bool((got_li[: min(B, 4), 0] == 0).all())


@pytest.mark.parametrize("head", ["svm", "gbdt"])
def test_train_on_the_card(dev, head):
    """Training on the card runs every assignment through the kernel and no
    plain version: the preprocess chain through `stencil_stream`, the octave
    (32x32 planes under its 34-pixel halo) through `stencil_chain`, and 21
    bow_assign launches (20 k-means iterations + the histograms)."""
    stream = ImageStream(res=32)
    imgs, labels = stream.batch(64, split=31)
    cfg = PipelineConfig(preprocess=True, head=head)
    counters.reset()
    model = pipeline.train(imgs, labels, cfg, dict_size=32, device=dev)
    torch.cuda.synchronize()
    snap = counters.snapshot()
    assert snap["launches"]["stencil_chain"] == 1 and snap["launches"]["stencil_stream"] == 1
    assert snap["launches"]["bow_assign"] == 21
    assert sum(snap["plain_calls"].values()) == 0
    assert model.centroids.device.type == "cuda"
    assert bool(torch.isfinite(model.centroids).all())
    pred = pipeline.predict(model, imgs, cfg, device=dev)
    assert pred.shape == (64,) and pred.device.type == "cuda"


@pytest.mark.parametrize("B", [1, 7, 256, 1000, 3])
@pytest.mark.parametrize("K", [1, 250, 257])
@pytest.mark.parametrize("C", [1, 10, 33, 7])
def test_linear_score_matches_plain(dev, B, K, C):
    g = torch.Generator(device=dev).manual_seed(B + K + C)
    h = torch.rand((B, K), generator=g, device=dev)
    w = torch.randn((C, K), generator=g, device=dev)
    b = torch.randn((C,), generator=g, device=dev)
    assert torch.equal(kbow.linear_score(h, w, b), kbow.linear_score_plain(h, w, b))


@pytest.mark.parametrize("K,C", [(250, 10), (257, 33), (1, 1), (0, 3), (4000, 5)])
def test_linear_score_smem_is_the_planners(dev, K, C):
    fn = _build.library("bow").linear_score_smem_bytes
    geom = kbow.score_geometry(256, K, C)
    assert fn(geom["kc"], C) == geom["smem"] <= kbow.SCORE_SMEM


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        stencil.fused_chain(torch.zeros((8, 8), dtype=torch.float64, device=dev),
                            _chains()["preprocess"])
    with pytest.raises(ValueError):
        kbow.linear_score(torch.zeros((2, 3), device=dev), torch.zeros((3, 4), device=dev).T,
                          torch.zeros(4, device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,S,T,H,hd",
    [(1, 128, 128, 1, 64), (2, 200, 200, 4, 64), (1, 300, 300, 2, 128), (2, 257, 257, 2, 16),
     (1, 130, 130, 2, 256), (1, 100, 160, 2, 64), (2, 150, 70, 3, 32), (1, 1, 65, 1, 8),
     # S and T off the 128-row query tile and the 64-key tile, hd off the 64-channel chunk
     (1, 333, 517, 2, 192), (2, 191, 127, 3, 136), (1, 65, 63, 2, 40), (1, 77, 77, 1, 248),
     # gemma-7b's prefill at a reduced batch and head count
     (2, 1024, 1024, 4, 256)],
)
def test_flash_attention_matches_plain(dev, dtype, causal, B, S, T, H, hd):
    g = torch.Generator(device=dev).manual_seed(S * 7 + T + hd)
    q, k, v = (torch.randn((B, n, H, hd), generator=g, device=dev).to(dtype) for n in (S, T, T))
    counters.reset()
    got = kattn.flash_attention(q, k, v, causal=causal)
    want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    oracle = ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), oracle.float(), rtol=rtol, atol=atol)


def test_flash_attention_library_runs_on_the_tensor_cores(dev):
    """The built library's SASS: each 16-bit body (f16 and bf16 at 1, 2 and 4
    channel chunks, each with and without the log-sum-exp output) issues
    HGMMA and loads by TMA (UTMALDG), and the f32 body runs FMAs without
    either.  Prints each body's ptxas report."""
    kattn.flash_attention(*(3 * (torch.zeros((1, 8, 1, 8), device=dev, dtype=torch.bfloat16),)))
    report = _build.build_log("flash_attn").splitlines()
    for i, line in enumerate(report):
        if "Compiling entry" in line:
            print(line.split("'")[1], *(r.strip() for r in report[i + 1 : i + 4]), sep="\n  ")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path("flash_attn"))],
                          capture_output=True, text=True, check=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        bodies[name] = part
    wgmma = [b for n, b in bodies.items() if "flash_attn_wgmma_kernel" in n]
    simt = [b for n, b in bodies.items() if "flash_attn_simt_kernel" in n]
    assert len(wgmma) == 12 and simt
    for body in wgmma:
        assert "HGMMA" in body and "UTMALDG" in body
    for body in simt:
        assert "FFMA" in body and "HGMMA" not in body and "UTMALDG" not in body


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,S,T,H,hd", [(2, 200, 200, 4, 64), (1, 300, 300, 2, 128), (2, 1024, 1024, 4, 256)]
)
def test_flash_attention_p_split_within_off_plain_share(dev, dtype, causal, B, S, T, H, hd):
    """`AGREE` passes one 16-bit pass of p as well as the p_hi + p_lo split.
    The share of outputs that differ from the plain version's (f32 p.v,
    rounded once) tells the two apart: tests/test_torch_attention.py replays
    both and sets `OFF_PLAIN_SHARE` between them."""
    g = torch.Generator(device=dev).manual_seed(S + hd + causal)
    q, k, v = (torch.randn((B, n, H, hd), generator=g, device=dev).to(dtype) for n in (S, T, T))
    got = kattn.flash_attention(q, k, v, causal=causal)
    want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
    off = float((got != want).float().mean())
    print(f"outputs off the plain version's: {off:.5f} (limit {kattn.OFF_PLAIN_SHARE})")
    assert off <= kattn.OFF_PLAIN_SHARE


def test_flash_attention_smem_bytes_match_the_library(dev):
    """The wrapper's shared-memory figure is the C launcher's: the 16-bit
    body at 1, 2 and 4 channel chunks, and the f32 body."""
    fn = _build.library("flash_attn").flash_attn_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for hd in (8, 64, 72, 128, 136, 192, 256):
        for dtype, code in kattn.DTYPES.items():
            assert fn(hd, code) == kattn.smem_bytes(hd, dtype.itemsize), (hd, dtype)
    # deepseek-v3-671b's MLA head dim: four 64-channel chunks in the 16-bit
    # body, as at 256; the f32 body's tiles at 192 channels
    assert fn(192, kattn.DTYPES[torch.bfloat16]) == kattn.smem_bytes(256, 2) == 230_472
    assert fn(192, kattn.DTYPES[torch.float32]) == 165_376


def test_flash_attention_refuses_gqa_and_an_over_budget_tile(dev):
    """A KV head count that does not divide the query heads (3 over 4) and a
    block over the shared-memory budget are refused before any launch."""
    q = torch.zeros((1, 64, 4, 256), device=dev)
    kv = torch.zeros((1, 64, 3, 256), device=dev)
    counters.reset()
    with pytest.raises(ValueError, match="KV heads"):
        kattn.flash_attention(q, kv, kv)
    # f32 at hd 256 needs 214,528 bytes a block: it fits the card, not a smaller budget
    with pytest.raises(ValueError, match="214528 bytes"):
        kattn.flash_attention(q, q, q, lc=LaunchConfig(smem_budget=150_000))
    assert counters.LAUNCHES["flash_attention"] == 0
    assert counters.PLAIN_CALLS["flash_attention"] == 0
    out = kattn.flash_attention(q, q, q)
    assert counters.LAUNCHES["flash_attention"] == 1 and out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 120, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 1), (8, 2), (36, 4), (64, 8)])
def test_flash_attention_over_kv_head_groups(dev, H, Hkv, hd, causal, dtype):
    """Query head h reads KV head h // (H // Hkv): within `AGREE` of the plain
    version (and, in f16 / bf16, within `OFF_PLAIN_SHARE`), and bit-equal to
    the kernel over K and V repeated to H heads, since each block does the
    same arithmetic on the same tiles.  hd 120 (h2o-danube-3-4b) pads to 128
    channels; S and T lie off the 128-row and 64-key tiles."""
    g = torch.Generator(device=dev).manual_seed(H * 1000 + Hkv * 10 + hd)
    S, T = 257, 257 if causal else 190
    q = torch.randn((2, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, T, Hkv, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    counters.reset()
    got = kattn.flash_attention(q, k, v, causal=causal)
    want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype != torch.float32:
        assert float((got != want).float().mean()) <= kattn.OFF_PLAIN_SHARE
    kr, vr = (x.repeat_interleave(H // Hkv, dim=2) for x in (k, v))
    assert torch.equal(got, kattn.flash_attention(q, kr, vr, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mla", [False, True], ids=["mha", "mla_padded_v"])
def test_flash_attention_at_head_dim_192(dev, mla, causal, dtype):
    """deepseek-v3-671b's MLA head dim: q and k of 192 channels; with `mla`,
    v of 128 channels padded with zeros to 192, as `models.attention.mla_attn`
    pads it.  Within `AGREE` of the plain version (and, in bf16, within
    `OFF_PLAIN_SHARE`); with `mla` the padded output channels exactly zero
    and the first 128 within `AGREE` of the f32 oracle on the unpadded v.
    S and T lie off the 128-row and 64-key tiles."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(192 + causal + 2 * mla)
    S, T, H = 333, 333 if causal else 190, 4
    q, k = (torch.randn((2, n, H, 192), generator=g, device=dev).to(dtype) for n in (S, T))
    v = torch.randn((2, T, H, 128 if mla else 192), generator=g, device=dev).to(dtype)
    vk = F.pad(v, (0, 64)) if mla else v
    counters.reset()
    got = kattn.flash_attention(q, k, vk, causal=causal)
    want = kattn.flash_attention(q, k, vk, causal=causal, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype != torch.float32:
        assert float((got != want).float().mean()) <= kattn.OFF_PLAIN_SHARE
    if mla:
        assert not got[..., 128:].any()
        oracle = ref.attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got[..., :128].float(), oracle.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dim_80(dev, causal, dtype):
    """zamba2-2.7b's shared block: head dim 80, which the 16-bit body pads to
    two 64-channel chunks (TMA zero-fills channels 80-127 of each row, so
    no other head's channels come in) and the f32 body runs at width 80.
    Within `AGREE` of the plain version (and, in f16 / bf16, within
    `OFF_PLAIN_SHARE`), and within `AGREE` of the f32 oracle; the wrapper's
    shared-memory figure is the library's.  S and T lie off the 128-row and
    64-key tiles; 3 heads, so a row's neighbour head lies past channel 80."""
    fn = _build.library("flash_attn").flash_attn_smem_bytes
    fn.restype = ctypes.c_longlong
    assert fn(80, kattn.DTYPES[dtype]) == kattn.smem_bytes(80, torch.tensor([], dtype=dtype).element_size())
    g = torch.Generator(device=dev).manual_seed(80 + causal)
    S, T, H = 333, 333 if causal else 190, 3
    q = torch.randn((2, S, H, 80), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, T, H, 80), generator=g, device=dev).to(dtype) for _ in range(2))
    counters.reset()
    got = kattn.flash_attention(q, k, v, causal=causal)
    want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype != torch.float32:
        assert float((got != want).float().mean()) <= kattn.OFF_PLAIN_SHARE
    oracle = ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), oracle.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("prompt_len", [2, 40])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_reduced_generate_of_each_recurrent_arch(dev, arch, prompt_len):
    """One `generate` of reduced zamba2-2.7b (Mamba2 layers + the shared
    attention block after each run: one kernel launch an application) and
    xlstm-125m (no attention: no launch): no plain version, the same tokens
    twice, the f32 state entries on the card; a 2-token prompt lies under
    the conv's 3 taps (the conv tail left-padded)."""
    cfg = reduced_config(arch)
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == (len(cfg.blocks) if cfg.shared_attn_every else 0)
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,T,H,Hkv,hd", [(1, 1600, 32, 8, 128), (1024, 1600, 32, 8, 128),
                                          (1, 1024, 16, 16, 64), (1024, 1024, 16, 16, 64),
                                          (1, 1601, 4, 2, 128), (130, 70, 4, 4, 64)])
def test_flash_attention_off_the_causal_mask(dev, S, T, H, Hkv, hd, dtype):
    """The cross-attention archs' non-causal calls: llama-3.2-vision-11b's 32
    query heads over 8 KV heads of 128 against its 1600 image tokens,
    seamless-m4t-large-v2's 16 heads of 64 (one 64-channel chunk) against
    its encoder's 1024 rows and in its encoder, each at a decode step's
    single query row (127 rows of the 16-bit body's 128-row tile past S)
    and at a 1024-row prefill; then a key tail of one row past a tile and
    S > T.  Within `AGREE` of the plain version (and, in bf16, within
    `OFF_PLAIN_SHARE`) and of the f32 oracle, one launch each."""
    g = torch.Generator(device=dev).manual_seed(S + T + H + hd)
    q = torch.randn((2, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, T, Hkv, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    counters.reset()
    got = kattn.flash_attention(q, k, v, causal=False)
    want = kattn.flash_attention(q, k, v, causal=False, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype != torch.float32:
        assert float((got != want).float().mean()) <= kattn.OFF_PLAIN_SHARE
    rep = H // Hkv
    oracle = ref.attention_ref(q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2),
                               causal=False)
    torch.testing.assert_close(got.float(), oracle.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("S,T,H,Hkv,hd,causal,q_off", [
    (1, 1600, 32, 8, 128, False, 0), (1, 1024, 16, 16, 64, False, 0),
    (130, 300, 8, 2, 120, True, 0), (64, 1024, 16, 16, 256, True, 512), (5, 0, 4, 4, 64, False, 0)])
def test_flash_attention_log_sum_exp(dev, S, T, H, Hkv, hd, causal, q_off, dtype):
    """The kernel's log-sum-exp output: the outputs bit for bit the launch's
    without it (one launch each), the log-sum-exp within 1e-5 of the plain
    version's (-1e30 for a row without keys), in both bodies."""
    g = torch.Generator(device=dev).manual_seed(S + T + H + hd)
    q = torch.randn((2, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, T, Hkv, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    counters.reset()
    plain = kattn.flash_attention(q, k, v, causal=causal, q_off=q_off)
    got, lse = kattn.flash_attention(q, k, v, causal=causal, q_off=q_off, lse=True)
    _, want = kattn.flash_attention(q, k, v, causal=causal, q_off=q_off, mode="ref", lse=True)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 2
    assert torch.equal(got, plain) and lse.shape == (2, H, S) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_reduced_generate_of_each_cross_attention_arch(dev, arch):
    """One `generate` of reduced llama-3.2-vision-11b (gated cross-attention
    layers over 16 image tokens, the gates set to 0.5) and
    seamless-m4t-large-v2 (the encoder over 40 audio frames, then decoder
    layers of self- and cross-attention): the prefill launches the kernel
    once an attention application (the encoder's included), each decode
    step once a cross-attention layer; no plain version; the same tokens
    twice; other context inputs give other tokens."""
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import lm
    from repro_torch.models.blocks import CONTEXT_ENTRIES

    cfg = reduced_config(arch)
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("gate_attn", "gate_mlp")):
                p.fill_(0.5)
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=torch.Generator().manual_seed(1))
    extras = make_extras(cfg, 3, 40, generator=torch.Generator(dev).manual_seed(2), device=dev)
    n_cross = sum(c for k, c in cfg.blocks if k in CONTEXT_ENTRIES)
    n_self = sum(c for k, c in cfg.blocks if k != "xattn")
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5, extras=extras)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == (
        cfg.n_enc_layers + n_self + n_cross + 4 * n_cross)
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5, extras=extras))
    other = {n: t * 50 for n, t in extras.items()}
    with torch.inference_mode():
        a, _ = lm.prefill(model, prompts.to(dev), extras=extras)
        b, _ = lm.prefill(model, prompts.to(dev), extras=other)
    assert float((a.float() - b.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_reduced_generate_of_each_moe_arch(dev, arch):
    """One `generate` of reduced arctic-480b (GQA + the MoE FFN beside a
    dense one) and deepseek-v3-671b (MLA, v padded from 16 to 24 channels,
    + the MoE FFN with a shared expert): the prefill launches the kernel
    once a layer, calls no plain version, gives the same tokens twice, and
    the MLA kinds' prefill equals a `mode="ref"` prefill's argmax but at a
    counted near-tie."""
    from repro_torch.models import lm

    cfg = reduced_config(arch)
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=torch.Generator().manual_seed(1))
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == cfg.n_layers
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5))
    with torch.inference_mode():
        lk, ck = lm.prefill(model, prompts.to(dev))
        lp, cp = lm.prefill(model, prompts.to(dev), mode="ref")
    assert [set(g) for g in ck["groups"]] == [set(g) for g in cp["groups"]]
    diff = float((lk.float() - lp.float()).abs().max())
    top2 = torch.topk(lp.float(), 2, dim=-1).values
    off = lk.argmax(-1) != lp.argmax(-1)
    assert bool(((top2[:, 0] - top2[:, 1])[off] <= diff).all())


@pytest.mark.parametrize("prompt_len", [24, 40])
@pytest.mark.parametrize("arch", ["qwen2-72b", "starcoder2-7b", "h2o-danube-3-4b"])
def test_reduced_generate_of_each_grouped_arch(dev, arch, prompt_len):
    """One `generate` of each reduced arch: the prefill launches the kernel
    once a layer where `attention` routes it there (reduced starcoder2-7b's
    head dim 12 and danube's prompt of 40 over its window of 32 route to
    `dense_attention`), calls no plain version, and gives the same tokens
    twice; the 40-token danube prompt is adopted into its 32-slot ring."""
    from repro_torch.models.attention import kernel_route

    cfg = reduced_config(arch)
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    kv = torch.zeros((1, prompt_len, cfg.n_kv_heads, cfg.head_dim))
    routed = kernel_route(torch.zeros((1, prompt_len, cfg.n_heads, cfg.head_dim)), kv, kv,
                          window=cfg.window)
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == (cfg.n_layers if routed else 0)
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5))


def test_reduced_generate_launches_flash_once_per_layer(dev):
    cfg = reduced_config("gemma-7b")
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=torch.Generator().manual_seed(1))
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == cfg.n_layers
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5))


def _rot_about_centre(hw, deg: float = 1.0, shift=(4.0, -3.0)) -> list:
    """Inverse map of a rotation about the image centre plus a translation."""
    h, w = hw
    cy, cx = (h - 1) / 2, (w - 1) / 2
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return [[c, -s, cx - c * cx + s * cy + shift[0]], [s, c, cy - s * cx - c * cy + shift[1]]]


def _geometric_chain(dev, name, hw):
    """The geometric path's chains for an (h, w) image; remap's map planes
    on the card."""
    h, w = hw
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    bench = [[math.cos(0.05), -math.sin(0.05), 4.0], [math.sin(0.05), math.cos(0.05), -3.0]]
    return {
        "warp": (stencil.warp_affine_stage(_rot_about_centre(hw, 7.0), shape=hw),),
        "warp_ladder": features.aligned_octave_chain(bench, hw, n_scales=2),
        "gauss_warp_tap": (stencil.gaussian_stage(3),
                           stencil.warp_affine_stage(_rot_about_centre(hw, -4.0), shape=hw,
                                                     extend=(2, 2), tap=0),
                           stencil.box_stage(2)),
        "remap": (stencil.remap_stage(xx + 1.2 * torch.cos(yy / 5.0),
                                      yy + 1.5 * torch.sin(xx / 7.0)),),
        "remap_erode": (stencil.remap_stage(xx + torch.cos(yy / 3.0), yy + torch.sin(xx / 4.0),
                                            extend=(1, 1)), stencil.erode_stage(1)),
        "sobel": (stencil.sobel_stage(),),
        "sobel_grad": (stencil.sobel_stage(), stencil.grad_stage()),
        "tap_sobel_thresh": (stencil.gaussian_stage(3, tap=0), stencil.sobel_stage(),
                             stencil.threshold_stage(20.0, 300.0)),
        "resize2": (stencil.resize2_stage(),),
        "gauss_resize2_tap": (stencil.gaussian_stage(3), stencil.resize2_stage(tap=0)),
        "sobel_resize2": (stencil.sobel_stage(), stencil.resize2_stage()),
    }[name]


GEOMETRIC = ["warp", "warp_ladder", "gauss_warp_tap", "remap", "remap_erode", "sobel", "sobel_grad",
             "tap_sobel_thresh", "resize2", "gauss_resize2_tap", "sobel_resize2"]


@pytest.mark.parametrize("name", GEOMETRIC)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,lc", [
    ((2, 37, 53, 1), LaunchConfig(tile_rows=16, tile_cols=16)),
    ((1, 301, 211, 1), LaunchConfig(row_segments=5, stream_rows=4, tile_rows=8, tile_cols=8)),
    ((1, 77, 640, 2), LaunchConfig(tile2d_cols=96, row_segments=3)),
])
@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d"])
def test_geometric_chains_match_plain(dev, name, dtype, shape, lc, mode):
    """Every band bit for bit against the plain version (dtype and shape
    too), in one launch and no plain call, across several window tiles,
    column tiles and row segments."""
    x = _image(dev, shape, dtype, seed=sum(shape) + len(name))
    chain = _geometric_chain(dev, name, shape[1:3])
    want = stencil.fused_chain(x, chain, mode="ref")
    counters.reset()
    if mode != "window":
        prog, _ = exec_streaming.program(chain, lc.stream_rows, dtype, dev)
        planes = (shape[0] * shape[3], *shape[1:3])
        try:
            exec_streaming.stream_geometry(prog, planes, lc, tiled=mode == "tiled2d")
        except ValueError:  # rings over the budget: the explicit plan refuses
            with pytest.raises(ValueError, match="bytes"):
                stencil.fused_chain(x, chain, mode=mode, lc=lc)
            assert sum(counters.LAUNCHES.values()) == 0
            return
    got = stencil.fused_chain(x, chain, mode=mode, lc=lc)
    torch.cuda.synchronize()
    kernel = "stencil_chain" if mode == "window" else "stencil_stream"
    assert counters.LAUNCHES[kernel] == 1 and sum(counters.LAUNCHES.values()) == 1
    assert counters.PLAIN_CALLS[kernel] == 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


def test_geometric_entry_points_on_the_card(dev):
    """The image ops at an odd size: warp_affine, remap, resize_half and
    sobel in every mode equal their plain versions; sobel's pair is f32 on
    a u8 image."""
    from repro_torch.cv import imgproc

    x = _image(dev, (1081, 1919), torch.uint8, seed=5)
    hw = (1081, 1919)
    yy, xx = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32, device=dev),
                            torch.arange(hw[1], dtype=torch.float32, device=dev), indexing="ij")
    mx, my = xx + 1.2 * torch.cos(yy / 5.0), yy + 1.5 * torch.sin(xx / 7.0)
    calls = {
        "warp": lambda m: imgproc.warp_affine(x, _rot_about_centre(hw), mode=m),
        "remap": lambda m: imgproc.remap(x, mx, my, mode=m),
        "resize_half": lambda m: imgproc.resize_half(x, mode=m),
        "sobel": lambda m: imgproc.sobel(x, mode=m),
    }
    for name, call in calls.items():
        want = call("ref")
        want = want if isinstance(want, tuple) else (want,)
        for mode in (None, "window", "tiled2d"):
            got = call(mode)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(got, want, strict=True):
                assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (name, mode)
    assert imgproc.sobel(x)[0].dtype == torch.float32


def test_align_and_detect_on_the_card(dev):
    """One launch of the warp -> ladder chain; keypoints equal to a
    `mode="ref"` run of the same batch on the card."""
    h, w = 64, 80
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    blob = 0.1 + torch.exp(-((yy - 30) ** 2 + (xx - 40) ** 2) / (2 * 2.3 ** 2))
    imgs = torch.stack([blob, blob.flip(0)])
    m = [[1.0, 0.0, 3.0], [0.0, 1.0, 5.0]]
    counters.reset()
    got = features.align_and_detect(imgs, m, max_kp=8)
    torch.cuda.synchronize()
    assert sum(counters.LAUNCHES.values()) == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = features.align_and_detect(imgs, m, max_kp=8, mode="ref")
    for k in ("xy", "scale", "valid", "resp", "gray"):
        assert torch.equal(got[k], want[k]), k
    assert tuple(int(v) for v in got["xy"][0, 0]) == (37, 25)


def _level_chain(dev, name, hw):
    """Chains with pyrUp or a stride before the last stage; remap's map
    planes on the card at the half-size image a pyrDown makes."""
    h, w = (hw[0] + 1) // 2, (hw[1] + 1) // 2
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    return {
        "pyr_up": (stencil.pyr_up_stage(),),
        "up_gauss": (stencil.pyr_up_stage(), stencil.gaussian_stage(3)),
        "down_up": (stencil.pyr_down_stage(), stencil.pyr_up_stage()),
        "gauss_down_erode": (stencil.gaussian_stage(5), stencil.pyr_down_stage(),
                             stencil.erode_stage(1)),
        "resize_gauss": (stencil.resize2_stage(), stencil.gaussian_stage(3)),
        "up_gauss_down_tap": (stencil.pyr_up_stage(), stencil.gaussian_stage(3),
                              stencil.pyr_down_stage(tap=0)),
        "down_sobel_grad": (stencil.pyr_down_stage(), stencil.sobel_stage(), stencil.grad_stage()),
        "down_remap": (stencil.pyr_down_stage(),
                       stencil.remap_stage(xx + 1.2 * torch.cos(yy / 5.0),
                                           yy + 1.5 * torch.sin(xx / 7.0))),
    }[name]


LEVEL = ["pyr_up", "up_gauss", "down_up", "gauss_down_erode", "resize_gauss", "up_gauss_down_tap",
         "down_sobel_grad", "down_remap"]


@pytest.mark.parametrize("name", LEVEL)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,lc", [
    ((2, 37, 53, 1), LaunchConfig(tile_rows=16, tile_cols=16)),
    ((1, 301, 211, 1), LaunchConfig(row_segments=5, stream_rows=4, tile_rows=8, tile_cols=8)),
    ((1, 77, 640, 2), LaunchConfig(tile2d_cols=96, row_segments=3)),
])
@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d"])
def test_level_chains_match_plain(dev, name, dtype, shape, lc, mode):
    """pyrUp and strides before the last stage: every band bit for bit
    against the plain version, in one launch and no plain call, across
    several window tiles, column tiles and row segments."""
    x = _image(dev, shape, dtype, seed=sum(shape) + len(name))
    chain = _level_chain(dev, name, shape[1:3])
    want = stencil.fused_chain(x, chain, mode="ref")
    counters.reset()
    if mode != "window":
        prog, _ = exec_streaming.program(chain, lc.stream_rows, dtype, dev)
        planes = (shape[0] * shape[3], *shape[1:3])
        try:
            exec_streaming.stream_geometry(prog, planes, lc, tiled=mode == "tiled2d")
        except ValueError:  # rings over the budget: the explicit plan refuses
            with pytest.raises(ValueError, match="bytes"):
                stencil.fused_chain(x, chain, mode=mode, lc=lc)
            assert sum(counters.LAUNCHES.values()) == 0
            return
    got = stencil.fused_chain(x, chain, mode=mode, lc=lc)
    torch.cuda.synchronize()
    kernel = "stencil_chain" if mode == "window" else "stencil_stream"
    assert counters.LAUNCHES[kernel] == 1 and sum(counters.LAUNCHES.values()) == 1
    assert counters.PLAIN_CALLS[kernel] == 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("mode", [None, "window", "streaming", "tiled2d"])
def test_sift_pyramid_on_the_card(dev, mode):
    """Four octaves, one launch each and no plain call; every band of the
    pyramid equal to the plain version's, keypoints equal to a
    `mode="ref"` run of the same batch on the card."""
    # 96 columns: the full-width rings of octave 0 fit, so every mode runs
    g = torch.stack([ImageStream().image((160, 96), channels=1, seed=s).to(dev).float()
                     for s in range(2)])
    chains = features.pyramid_chains(4)
    counters.reset()
    outs, scales = stencil.chained_launches(g[..., None], chains, mode=mode)
    torch.cuda.synchronize()
    assert sum(counters.LAUNCHES.values()) == 4 and sum(counters.PLAIN_CALLS.values()) == 0
    want, _ = stencil.chained_launches(g[..., None], chains, mode="ref")
    assert scales == [(1, 1), (2, 2), (4, 4), (8, 8)]
    for a, b in zip(outs, want, strict=True):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)
    counters.reset()
    got = features.sift_pyramid(g, n_octaves=4, max_kp=32, mode=mode)
    torch.cuda.synchronize()
    assert sum(counters.LAUNCHES.values()) == 4 and sum(counters.PLAIN_CALLS.values()) == 0
    ref_kp = features.sift_pyramid(g, n_octaves=4, max_kp=32, mode="ref")
    for k in ("xy", "octave", "scale", "resp", "valid"):
        assert torch.equal(got[k], ref_kp[k]), k


# ---------------------------------------------------------------------------
# Chains the fixed tables once refused; the cut-frame window; the tiled search
# ---------------------------------------------------------------------------

def _table_chains(dev, hw):
    """chip_smoke.py's `table_chains` (loaded by path: the checkout's root)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_chains", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.table_chains(stencil, hw, dev)


TABLE_NAMES = ["even 2x2", "even 4x4", "even sep 6/6", "odd x even", "even taps beside a map",
               "676 weights", "33 stages", "9 levels", "17 bands", "5 remaps"]


@pytest.mark.parametrize("name", TABLE_NAMES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d"])
@pytest.mark.parametrize("hw", [(96, 160), (37, 53)])
def test_table_chains_match_plain(dev, name, dtype, mode, hw):
    """Even taps and the chains past the old tables (676 weights, 33 stages,
    9 levels, 17 bands, 5 remaps), each in one launch of the kernel its mode
    names, bit for bit against the plain version; a streaming plan over the
    budget raises instead, naming the bytes."""
    x = _image(dev, (2, *hw), dtype, seed=sum(hw))
    chain = _table_chains(dev, hw)[name]
    lc = LaunchConfig(stream_rows={"9 levels": 32, "17 bands": 4}.get(name, 8),
                      tile2d_cols=64 if mode == "tiled2d" else None)
    want = stencil.fused_chain(x[..., None], chain, mode="ref")
    counters.reset()
    try:
        got = stencil.fused_chain(x[..., None], chain, mode=mode, lc=lc)
    except ValueError as e:
        assert mode == "streaming" and "bytes" in str(e)
        return
    torch.cuda.synchronize()
    kernel = "stencil_chain" if mode == "window" else "stencil_stream"
    assert counters.LAUNCHES[kernel] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("shape,tile", [((256, 32, 32), 32), ((3, 45, 39), 16), ((2, 37, 53), 8),
                                        ((1, 512, 512), 32), ((5, 33, 31), 32)])
@pytest.mark.parametrize("name", ["octave", "octave_nb", "preprocess"])
def test_cut_window_is_bit_equal_to_plain(dev, shape, tile, name):
    """The window kernel with cut frames, at the request's 32x32 planes, odd
    sizes with edge and interior tiles, and a 512x512 plane: every band
    equal to the plain version bit for bit."""
    x = _image(dev, shape, torch.float32, seed=sum(shape) + tile)
    chain = _chains()[name]
    counters.reset()
    got = stencil.fused_chain(x[..., None], chain, mode="window",
                              lc=LaunchConfig(tile_rows=tile, tile_cols=tile))
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_chain"] == 1
    want = stencil.fused_chain(x[..., None], chain, mode="ref")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,D,K", [(32000, 128, 250), (8192, 128, 250), (100, 128, 63),
                                   (129, 37, 64), (65, 16, 65), (3, 5, 1)])
def test_tiled_search_matches_plain(dev, N, D, K):
    """bow_assign's 64 x 64 tiles: rows not a multiple of the tile, K at and
    around a tile, D not a multiple of the staged chunk; a word duplicated
    across a tile boundary (ties to the lower word); all-equal rows."""
    g = torch.Generator(device=dev).manual_seed(N + D + K)
    desc = torch.randn((N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    if K > 64:
        cents[K - 1] = cents[63]
        desc[: min(N, 40)] = cents[63] + 1e-3 * desc[: min(N, 40)]
    got_i, got_d2 = kbow.bow_assign(desc, cents)
    want_i, want_d2 = kbow.bow_assign_plain(desc, cents)
    assert torch.equal(got_i, want_i) and torch.equal(got_d2, want_d2)
    same = torch.ones((70, D), device=dev)
    flat = torch.full((K, D), 0.5, device=dev)
    si, sd = kbow.bow_assign(same, flat)
    assert bool((si == 0).all()) and torch.equal(sd, kbow.bow_assign_plain(same, flat)[1])


@pytest.mark.parametrize("B,N", [(256, 32), (7, 45), (1, 1)])
def test_tiled_search_histograms_match_plain(dev, B, N):
    """bow_quantize_hist runs the same search, an image's rows in tiles of
    32 against the word tiles of its cluster's ranks; an image of invalid
    rows adds nothing."""
    g = torch.Generator(device=dev).manual_seed(B * N)
    descs = torch.randn((B, N, 128), generator=g, device=dev)
    cents = torch.randn((250, 128), generator=g, device=dev)
    valids = torch.rand((B, N), generator=g, device=dev) < 0.7
    valids[0] = False
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
    assert torch.equal(got, kbow.quantize_hist_plain(descs, valids, cents))
    assert float(got[0].sum()) == 0.0


def _hist_problem(dev, B, N, D, K, weights, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    descs = torch.randn((B, N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    valid = torch.rand((B, N), generator=g, device=dev) < 0.8
    if weights == "bool":
        return descs, valid, cents
    if weights == "unit_f32":
        return descs, valid.float(), cents
    # fractional: sums of these depend on their order
    return descs, torch.rand((B, N), generator=g, device=dev) * valid, cents


@pytest.mark.parametrize("weights", ["bool", "unit_f32", "fractional"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (2, 45, 128, 5), (1, 100, 16, 700),
                                     (4, 5, 16, 33), (256, 32, 128, 250), (2, 100, 128, 33),
                                     (1, 32, 128, 250), (2, 40, 16, 1300)])
def test_bow_quantize_hist_clusters_are_bit_equal_and_deterministic(dev, B, N, D, K, normalize,
                                                                    weights):
    """One launch a call; two runs bit-identical and equal to the plain
    version (weights added and totals summed in ascending n), also for
    fractional weights; N over one row tile (40, 45, 100), K from one rank
    (5, 33) to six (700) and to eight ranks, three of them walking two word
    tiles (1300)."""
    descs, valids, cents = _hist_problem(dev, B, N, D, K, weights, seed=B * N + K)
    counters.reset()
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=normalize)
    again = kbow.bow_quantize_hist(descs, valids, cents, normalize=normalize)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["bow_quantize_hist"] == 2 and sum(counters.PLAIN_CALLS.values()) == 0
    want = kbow.quantize_hist_plain(descs, valids, cents, normalize=normalize)
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("weights", ["bool", "unit_f32"])
def test_bow_quantize_hist_normalisations_agree_on_unit_weights(dev, weights):
    """With {0, 1} weights every sum is an exact integer, so dividing by the
    total weight (the kernel) equals dividing by the row sum of the counts
    (`normalize_hist`, JAX's), bit for bit; an all-invalid image stays 0."""
    descs, valids, cents = _hist_problem(dev, 64, 32, 128, 250, weights, seed=5)
    valids[3] = 0
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=True)
    want = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    assert torch.equal(got, want)
    assert float(got[3].abs().sum()) == 0.0


def test_bow_quantize_hist_is_one_kernel_a_call(dev):
    """Under torch.profiler a call runs exactly one device activity, the
    cluster kernel: no memset of the histogram, no cast of the bool valids,
    no normalising launches."""
    from torch.profiler import ProfilerActivity, profile

    descs, valids, cents = _hist_problem(dev, 256, 32, 128, 250, "bool", seed=6)
    kbow.bow_quantize_hist(descs, valids, cents)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kbow.bow_quantize_hist(descs, valids, cents)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1, [e.name for e in device]
    assert "quantize_hist_kernel" in device[0].name


@pytest.mark.parametrize("K", [1, 128, 129, 250, 700, 1300])
def test_bow_quantize_hist_geometry_is_the_planners(dev, K):
    """The library's CTA shared memory and cluster size are the Python
    side's, and the card holds the predict request's clusters at once."""
    lib = _build.library("bow")
    assert lib.quantize_hist_smem_bytes() == kbow.hist_smem_bytes()
    assert lib.quantize_hist_ranks(K) == kbow.hist_ranks(K)
    if K == 250:
        assert lib.quantize_hist_max_clusters(K) >= 256


def test_bow_quantize_hist_empty_shapes_launch_nothing(dev):
    descs, valids, cents = _hist_problem(dev, 3, 4, 16, 5, "bool", seed=7)
    counters.reset()
    for d, v, c in ((descs[:, :0], valids[:, :0], cents), (descs, valids, cents[:0]),
                    (descs[:0], valids[:0], cents)):
        got = kbow.bow_quantize_hist(d.contiguous(), v.contiguous(), c.contiguous())
        assert got.shape == (d.shape[0], c.shape[0]) and float(got.abs().sum()) == 0.0
    assert counters.LAUNCHES["bow_quantize_hist"] == 0


@pytest.mark.parametrize("ksize", list(range(1, 32, 2)))
@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (37, 53), (511, 513), (512, 512),
                                   (20, 4096)])
def test_seed_gaussian_blur_strips_match_plain(dev, ksize, shape):
    """Every kernel size the launcher compiles, on planes of one pixel, one
    row, odd sizes (byte-wise windows) and widths a multiple of 16 (16-byte
    windows, edge tiles clamped)."""
    x = _image(dev, shape, torch.uint8, seed=ksize * 7 + shape[1])
    counters.reset()
    got = unfused.seed_gaussian_blur_2d(x, ksize)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_gaussian_blur"] == 1
    assert torch.equal(got, unfused.seed_gaussian_blur_2d(x, ksize, mode="ref"))


@pytest.mark.parametrize("ksize", [3, 15, 31])
def test_seed_gaussian_blur_unaligned_planes_match_plain(dev, ksize):
    """A plane whose first byte is not 16-byte aligned (a view one byte into
    its storage) takes the byte-wise window and word-wise or byte stores."""
    h, w = 64, 512
    big = _image(dev, (h * w + 1,), torch.uint8, seed=ksize)
    x = big[1:].view(h, w)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    got = unfused.seed_gaussian_blur_2d(x, ksize)
    assert torch.equal(got, unfused.seed_gaussian_blur_2d(x, ksize, mode="ref"))


def test_mode_none_launches_the_measured_winner(dev, tmp_path, monkeypatch):
    """`measure_chain` on two shapes (the 512x512 octave, 4K u8 filter2D
    k = 13) times only kernel modes, and ``mode=None`` then launches each
    winner once, bit-equal to that mode, with no plain version.  Which
    kernel wins freely is timing (printed, not asserted); the test then
    seeds a different winner on each shape (``modes=("window",)`` and
    ``("tiled2d",)``) and ``mode=None`` must follow each to its kernel.
    Naming "ref" on the card raises, in a measurement and in a ladder."""
    from repro_torch.core import autotune

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "chain_autotune.json"))
    monkeypatch.setattr(autotune, "_MODE_CACHE", {})
    st = ImageStream()
    k1 = ref.gaussian_kernel1d(13)
    cases = [
        (st.image((512, 512), seed=2).to(dev).float(), features.octave_chain(4, with_next_base=False),
         "window"),
        (st.image((2160, 3840), seed=0).to(dev), (stencil.filter_stage(torch.outer(k1, k1)),),
         "tiled2d"),
    ]

    def routes_to(img, chain, mode):
        counters.reset()
        got = stencil.fused_chain(img, chain)
        torch.cuda.synchronize()
        kernel = "stencil_chain" if mode == "window" else "stencil_stream"
        assert counters.LAUNCHES[kernel] == 1 and sum(counters.LAUNCHES.values()) == 1
        assert sum(counters.PLAIN_CALLS.values()) == 0
        want = stencil.fused_chain(img, chain, mode=mode)
        got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        return kernel

    kernels = []
    for img, chain, seeded in cases:
        with pytest.raises(ValueError, match="no candidate on the card"):
            autotune.measure_chain(img, chain, modes=("window", "ref"))
        with pytest.raises(ValueError, match="moves to 'ref'"):
            stencil.fused_chain(img, chain, mode="window", ladder=("window", "ref"))
        e = autotune.measure_chain(img, chain, n=3)
        assert "ref" not in e["times"] and e["mode"] in ("window", "streaming", "tiled2d")
        print(f"measured {tuple(img.shape)}: {e['mode']} {e['times']}")
        routes_to(img, chain, e["mode"])
        e = autotune.measure_chain(img, chain, n=1, modes=(seeded,))
        assert e["mode"] == seeded
        kernels.append(routes_to(img, chain, seeded))
    assert kernels == ["stencil_chain", "stencil_stream"], kernels


# -- the serving engine on the card ------------------------------------------------------


def _octave_streams(side: int) -> bool:
    """Do the octave chain's full-width f32 rings fit a block's shared memory
    at this width (the planner's own figures)?"""
    lc = LaunchConfig()
    prog, _ = exec_streaming.program(features.octave_chain(4, with_next_base=False),
                                     lc.stream_rows, torch.float32, torch.device("cpu"))
    return prog.layout.smem_bytes(side) + prog.table_smem <= lc.smem_budget


@pytest.mark.parametrize("side", [32, 64, 128, 256])
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_engine_streaming_rung_launches_on_every_bucket(dev, side, batch):
    """The streaming rung launches `stencil_stream` for both chains on every
    default bucket whose octave rings fit at full width, at the engine's
    batch sizes (the port has no plain-version tail for planes no larger
    than the octave's halo), bit-equal to `extract_features` at that mode;
    on the 256x256 bucket, where they do not fit, the batch moves to
    tiled2d with one event (the preprocess chain having launched once at
    streaming first).  No plain version runs."""
    from repro_torch.core import faultinject

    g = torch.Generator().manual_seed(side * 100 + batch)
    lo = side // 2 + 1
    work = [torch.randint(0, 256, (int(torch.randint(lo, side + 1, (1,), generator=g)),
                                   int(torch.randint(lo, side + 1, (1,), generator=g)), 3),
                          generator=g, dtype=torch.uint8).numpy() for _ in range(batch)]
    cfg = PipelineConfig(preprocess=True, max_kp=32)
    eng = cv_engine.CvEngine(config=cfg, capture_frames=True, device=dev)
    assert eng.ladder == ("streaming", "tiled2d", "window")
    streams = _octave_streams(side)
    assert streams == (side <= 128)
    rung = "streaming" if streams else "tiled2d"
    faultinject.clear_degradation_log()
    counters.reset()
    res = eng.extract(work)
    torch.cuda.synchronize()
    snap = counters.snapshot()
    log = faultinject.degradation_log()
    faultinject.clear_degradation_log()
    assert all(r.ok and r.plan == rung and r.retries == 0 and r.bucket == (side, side)
               for r in res)
    assert [(e.from_plan, e.to_plan) for e in log] == ([] if streams else [("streaming", "tiled2d")])
    assert snap["launches"]["stencil_stream"] == (2 if streams else 3)
    assert sum(snap["launches"].values()) == snap["launches"]["stencil_stream"]
    assert not any(snap["plain_calls"].values())
    (_, b), = eng.captured
    want = pipeline.extract_features(b, cfg.replace(mode=rung), device=dev)
    for k, r in enumerate(res):
        assert (r.desc == want["desc"][k].cpu().numpy()).all()
        assert (r.valid == want["valid"][k].cpu().numpy()).all()


def test_engine_refuses_a_ladder_to_ref_on_the_card(dev):
    counters.reset()
    for ladder in (("window", "ref"), cv_engine.DEFAULT_LADDER):
        with pytest.raises(ValueError, match="plain version"):
            cv_engine.CvEngine(ladder=ladder, device=dev)
    assert cv_engine.CvEngine(ladder=("ref",), device=dev).ladder == ("ref",)
    assert counters.snapshot()["launches"] == dict.fromkeys(counters.KERNELS, 0)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("ksize", [0, 1, 3, 7])
def test_vanherk_on_the_card_equals_the_cpu(dev, dtype, ksize):
    from repro_torch.cv import imgproc

    g = torch.Generator().manual_seed(ksize)
    x = (torch.randint(0, 256, (37, 61, 3), generator=g).to(dtype) if dtype == torch.uint8
         else torch.randn((37, 61, 3), generator=g))
    for op in ("erode_vanherk", "dilate_vanherk"):
        got = getattr(imgproc, op)(x.to(dev), ksize)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert torch.equal(got.cpu(), getattr(imgproc, op)(x, ksize))
    if dtype == torch.uint8 and ksize:
        plane = x[..., 0].contiguous().to(dev)
        assert torch.equal(imgproc.erode_vanherk(plane, ksize), ops.erode(plane, ksize))


# ---------------------------------------------------------------------------
# Training: `flash_attention` under autograd, a train step of each reduced arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,G,hd,causal", [(2, 200, 200, 4, 4, 64, True),
                                                 (1, 130, 300, 8, 2, 128, False),
                                                 (2, 257, 257, 4, 1, 256, True)])
def test_flash_training_gradient_kernel_against_plain(dev, dtype, B, S, T, H, G, hd, causal):
    """The kernel route's forward under `FlashAttention` against the plain
    route (``mode="ref"``): outputs within `AGREE`, and the gradients
    (both from the one plain backward, fed each route's output) within
    `AGREE`'s rtol in relative L2 in f32, 2^-6 in bf16 (the forward's
    rounding enters dS through rowsum(dO o))."""
    g = torch.Generator(dev).manual_seed(hd)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, T, G, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    grads = {}
    for mode in (None, "ref"):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        counters.reset()
        out = kattn.flash_attention(*ts, causal=causal, mode=mode)
        out.backward(do)
        torch.cuda.synchronize()
        assert counters.BACKWARD_CALLS["flash_attention"] == 1
        assert counters.LAUNCHES["flash_attention"] == (1 if mode is None else 0)
        grads[mode] = (out.detach(), [t.grad for t in ts])
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(grads[None][0].float(), grads["ref"][0].float(), rtol=rtol,
                               atol=atol)
    tol = 2e-4 if dtype == torch.float32 else 2.0**-6
    for a, b in zip(grads[None][1], grads["ref"][1]):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).norm()) <= tol * float(b.float().norm())


def test_reduced_train_steps_on_the_card(dev):
    """One train step of each arch's reduced config in f32 on the card:
    the kernel route against the plain route, loss and grad norm within
    1e-5 and 1e-3 relative, one launch a plain call of the plain route."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import step as tstep

    for arch in ARCHS:
        cfg = reduced_config(arch).replace(dtype="float32")
        out = {}
        for mode in (None, "ref"):
            state = tstep.init_state(cfg, device=dev,
                                     generator=torch.Generator(dev).manual_seed(0))
            batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=128,
                                global_batch=2).batch_at(0)
            if cfg.encdec or any(k == "xattn" for k, _ in cfg.blocks):
                from repro_torch.launch.serve import make_extras

                batch |= make_extras(cfg, 2, 128, generator=torch.Generator(dev).manual_seed(1),
                                     device=dev)
            counters.reset()
            _, m = tstep.make_train_step(cfg, mode=mode)(state, batch)
            out[mode] = ({k: float(m[k]) for k in ("loss", "grad_norm")}, counters.snapshot())
        (mk, sk), (mr, sr) = out[None], out["ref"]
        assert sk["launches"]["flash_attention"] == sr["plain_calls"]["flash_attention"], arch
        assert not any(sk["plain_calls"].values()), arch
        assert abs(mk["loss"] - mr["loss"]) <= 1e-5 * abs(mr["loss"]), arch
        assert abs(mk["grad_norm"] - mr["grad_norm"]) <= 1e-3 * mr["grad_norm"], arch
