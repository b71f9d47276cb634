"""The port's seed (pre-fusion) kernels against the JAX package's.

The JAX side loads `benchmarks/unfused_baseline.py` by its path (the
directory is no package) and runs its Pallas kernels in interpret mode with
`VectorConfig(lmul=4)`, as that file runs on the CPU.  The port runs the
wrappers on CPU tensors, which is each kernel's plain version.  Inputs are
made from a numpy seed and handed to both.

Tolerances: erosion, threshold and the pipeline's threshold output are
exact.  The blur is exact but where XLA's fused multiply-add may move a
value across a .5 rounding tie: there a u8 |diff| <= 1 is allowed, and
every such pixel must be a counted near-tie (0 predicted).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig

from repro_torch.kernels import counters, ref as tref, unfused

ROOT = pathlib.Path(__file__).resolve().parents[1]
VC = VectorConfig(lmul=4)
# (thresh, thresh cast to u8 as `seed_threshold_2d` casts it on the CPU);
# 255.99999999 rounds to 256.0 in f32 before the cast
T8_TABLE = [(0, 0), (100.5, 100), (254.5, 254), (255.9, 255), (255.99999999, 0), (256, 0),
            (-0.5, 0), (-1, 255), (-5, 251), (300, 44), (511.7, 255), (-256, 0)]


@pytest.fixture(scope="module")
def ub():
    spec = importlib.util.spec_from_file_location(
        "unfused_baseline_reference", ROOT / "benchmarks" / "unfused_baseline.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plane(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _near_ties(x: np.ndarray, ksize: int) -> np.ndarray:
    """Pixels whose blurred f32 value lies within 1e-3 of a .5 rounding tie."""
    k1 = tref.gaussian_kernel1d(ksize).numpy()
    p = ksize // 2
    xp = np.pad(x.astype(np.float32), p, mode="edge")
    h, w = x.shape
    row = sum(k1[j] * xp[:, j : j + w] for j in range(ksize))
    v = sum(k1[i] * row[i : i + h] for i in range(ksize))
    return np.abs(v - np.floor(v) - 0.5) < 1e-3


@pytest.mark.parametrize("shape", [(40, 72), (37, 53)])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_seed_blur_matches_jax(ub, ksize, shape):
    x = _plane(shape, seed=ksize)
    want = np.asarray(ub.seed_gaussian_blur_2d(jnp.asarray(x), ksize, VC))
    got = unfused.seed_gaussian_blur_2d(torch.from_numpy(x), ksize).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert diff.max() <= 1
    assert not (diff > 0)[~_near_ties(x, ksize)].any(), "differs off a .5 tie"


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("shape", [(40, 72), (37, 53)])
def test_seed_erode_matches_jax(ub, r, shape):
    x = _plane(shape, seed=10 + r)
    want = np.asarray(ub.seed_erode_2d(jnp.asarray(x), r, VC))
    got = unfused.seed_erode_2d(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh,t8", T8_TABLE)
def test_seed_threshold_matches_jax(ub, thresh, t8):
    """Every u8 value against each threshold of the table: the threshold
    is cast to u8 first (rounded to f32, truncated, then wrapped), as the
    JAX seed does."""
    x = (np.arange(37 * 53) % 256).astype(np.uint8).reshape(37, 53)
    want = np.asarray(ub.seed_threshold_2d(jnp.asarray(x), thresh, 255.0, VC))
    got = unfused.seed_threshold_2d(torch.from_numpy(x), thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert unfused.to_u8(thresh) == t8
    np.testing.assert_array_equal(got, np.where(x > t8, 255, 0).astype(np.uint8))


def test_seed_pipeline_matches_jax(ub):
    batch = _plane((2, 40, 72, 3), seed=20)
    want = np.asarray(ub.seed_pipeline(jnp.asarray(batch), blur_ksize=5, erode_r=1,
                                       thresh=100.0, vc=VC))
    counters.reset()
    got = unfused.seed_pipeline(torch.from_numpy(batch), blur_ksize=5, erode_r=1, thresh=100.0)
    np.testing.assert_array_equal(got.numpy(), want)
    for name in ("seed_gaussian_blur", "seed_erode", "seed_threshold"):
        assert counters.PLAIN_CALLS[name] == 6  # B * C planes
    assert sum(counters.LAUNCHES.values()) == 0


def test_seed_pipeline_takes_non_contiguous_channels():
    batch = torch.from_numpy(_plane((1, 21, 30, 2), seed=21))
    got = unfused.seed_pipeline(batch, blur_ksize=3, erode_r=2, thresh=-1)
    for c in range(2):
        p = batch[0, :, :, c].contiguous()
        want = unfused.seed_threshold_2d(unfused.seed_erode_2d(
            unfused.seed_gaussian_blur_2d(p, 3), 2), -1)
        assert torch.equal(got[0, :, :, c], want)


@pytest.mark.parametrize("fn,args", [
    (unfused.seed_gaussian_blur_2d, (5,)),
    (unfused.seed_erode_2d, (1,)),
    (unfused.seed_threshold_2d, (100.0,)),
])
def test_seed_wrappers_take_one_u8_plane(fn, args):
    with pytest.raises(ValueError, match="uint8"):
        fn(torch.zeros((8, 8), dtype=torch.float32), *args)
    with pytest.raises(ValueError, match="uint8"):
        fn(torch.zeros((2, 8, 8), dtype=torch.uint8), *args)
    with pytest.raises(ValueError, match="mode"):
        fn(torch.zeros((8, 8), dtype=torch.uint8), *args, mode="window")


def test_seed_blur_rejects_even_or_huge_kernels():
    for k in (4, 0, 33):
        with pytest.raises(ValueError, match="ksize"):
            unfused.seed_gaussian_blur_2d(torch.zeros((8, 8), dtype=torch.uint8), k)


def test_seed_plain_versions_equal_the_fused_oracles():
    """On the extended domain a single op's chain is the per-op result, so
    each seed plain version equals `kernels.ref`'s per-op oracle."""
    x = torch.from_numpy(_plane((33, 47), seed=22))
    k1 = tref.gaussian_kernel1d(7)
    assert torch.equal(unfused.seed_gaussian_blur_2d(x, 7), tref.sep_filter2d_ref(x, k1, k1))
    assert torch.equal(unfused.seed_erode_2d(x, 2), tref.erode_ref(x, 2))


# ---------------------------------------------------------------------------
# seed_gaussian_blur's strip walk (csrc/unfused.cu), in numpy
# ---------------------------------------------------------------------------

def _replay_blur_strips(x: np.ndarray, ksize: int) -> np.ndarray:
    """`seed_gaussian_blur_kernel<ksize>` over an (H, W) u8 plane: tiles of
    BLUR_ROWS x BLUR_COLS; each window is the tile's rows +- k/2 (clamped)
    by BLUR_PAD columns either side, read in 16-byte segments (raw bytes
    where a segment lies inside a plane of a width that is a multiple of 16,
    else byte by byte with clamped columns); the row pass in strips of 4
    outputs, output j of a strip reading window columns BLUR_PAD - k/2 + c +
    j + q for taps q ascending; the column pass over 4 columns a tap; each
    product and sum rounded to f32; rint and saturate; stores only inside
    the plane, each pixel once."""
    h, w = x.shape
    k1 = tref.gaussian_kernel1d(ksize).numpy()
    hk = ksize // 2
    R, C, P = unfused.BLUR_ROWS, unfused.BLUR_COLS, unfused.BLUR_PAD
    out = np.zeros((h, w), np.uint8)
    stores = np.zeros((h, w), np.int32)
    strips = 4 * np.arange(C // 4)
    for y0 in range(0, h, R):
        for x0 in range(0, w, C):
            rows = np.clip(np.arange(y0 - hk, y0 + R + hk), 0, h - 1)
            win = np.empty((R + 2 * hk, C + 2 * P), np.uint8)
            for sg in range((C + 2 * P) // 16):
                gx = x0 - P + 16 * sg
                if w % 16 == 0 and gx >= 0 and gx + 16 <= w:
                    win[:, 16 * sg:16 * sg + 16] = x[rows, gx:gx + 16]
                else:
                    cols = np.clip(np.arange(gx, gx + 16), 0, w - 1)
                    win[:, 16 * sg:16 * sg + 16] = x[rows][:, cols]
            v = win.astype(np.float32)
            seg = v[:, (P - hk + strips)[:, None] + np.arange(ksize + 3)[None, :]]  # (rows, strip, k+3)
            row = np.empty((R + 2 * hk, C // 4, 4), np.float32)
            for o in range(4):
                acc = k1[0] * seg[:, :, o]
                for q in range(1, ksize):
                    acc = acc + k1[q] * seg[:, :, o + q]
                row[:, :, o] = acc
            row = row.reshape(R + 2 * hk, C)
            acc = k1[0] * row[0:R]
            for q in range(1, ksize):
                acc = acc + k1[q] * row[q:q + R]
            tile = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
            ny, nx = min(R, h - y0), min(C, w - x0)
            out[y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
            stores[y0:y0 + ny, x0:x0 + nx] += 1
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("ksize", list(range(1, 32, 2)))
@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (37, 53), (511, 513), (48, 512)])
def test_blur_strip_replay_is_bit_equal_to_plain(ksize, shape):
    """Every kernel size, on one pixel, one row, odd sizes and a width that
    is a multiple of 16 (16-byte segments, edge tiles clamped): the strip
    walk equals `seed_gaussian_blur_2d_plain` bit for bit."""
    x = _plane(shape, seed=ksize + shape[0] * 3)
    want = unfused.seed_gaussian_blur_2d(torch.from_numpy(x), ksize).numpy()
    np.testing.assert_array_equal(_replay_blur_strips(x, ksize), want)


def test_blur_block_geometry_matches_the_kernel():
    """The replay's block is the kernel's (csrc/unfused.cu kBlurRows,
    kBlurCols, kBlurPad, kBlurThreads); the pad covers the largest halo
    (15) in one 16-byte segment; a block's static shared memory at k = 31
    (the u8 window and the f32 row pass) stays within 48 KB; a 512x512
    plane is one wave of blocks on 132 SMs."""
    import re

    src = (ROOT / "src" / "repro_torch" / "csrc" / "unfused.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kBlurRows"]), int(consts["kBlurCols"]), int(consts["kBlurPad"]),
            int(consts["kBlurThreads"])) == (unfused.BLUR_ROWS, unfused.BLUR_COLS,
                                             unfused.BLUR_PAD, unfused.BLUR_THREADS)
    assert unfused.BLUR_PAD == 16 and unfused.BLUR_PAD >= 31 // 2 and unfused.BLUR_COLS % 16 == 0
    wh = unfused.BLUR_ROWS + 2 * (31 // 2)
    assert wh * (unfused.BLUR_COLS + 2 * unfused.BLUR_PAD) + 4 * wh * unfused.BLUR_COLS <= 48 * 1024
    assert -(-512 // unfused.BLUR_ROWS) * -(-512 // unfused.BLUR_COLS) <= 132
    for k in range(1, 32, 2):
        assert f"case {k}: return launch_blur<{k}>" in src
