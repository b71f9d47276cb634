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
