"""The port's SIFT-lite features against the JAX package's, on the CPU.

The JAX side runs with ``mode="ref"`` (its fused chain at 48x48 takes the
`chain_ref` route; its Pallas stencil plans do not lower on every jax
release).  Inputs are made from a seed and handed to both packages.

Tolerances, with their reasons:
  * keypoints: the same (xy, scale, valid) set exactly; resp at rtol 2e-5,
    atol 1e-6 (tests/test_pyramid.py), as the scale stacks agree to ulps;
  * descriptors: at atol 1e-5 for at least 95% of the valid keypoints.  The
    orientation bins are floor()s of f32 angles; XLA and PyTorch take atan2
    and sqrt with different ulp errors, so an angle within an ulp of a bin
    edge can land in the neighbouring bin on one side and move that
    keypoint's dominant orientation.  Every such keypoint is reported.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.cv import features as jfeatures
from repro.cv import imgproc as jimgproc
from repro.data.synthetic import ImageStream as JaxImageStream

from repro_torch.cv import features as tfeatures
from repro_torch.cv import imgproc as timgproc
from repro_torch.cv.config import PipelineConfig
from repro_torch.kernels import counters

MAX_KP = 32


def _images(kind: str, n: int = 6, res: int = 48) -> np.ndarray:
    # an integer split seeds ImageStream identically in every process
    imgs, _ = JaxImageStream(res=res).batch(n, split=11)
    x = np.asarray(imgs).astype(np.float32)
    if kind == "gray":
        return np.array(jimgproc.rgb_to_gray(jnp.asarray(x)))
    if kind == "preprocessed":
        return np.array(jimgproc.preprocess_bow(jnp.asarray(x), mode="ref"))
    return x


def _jax_detect(x: np.ndarray) -> list:
    return [jfeatures.detect_keypoints(jnp.asarray(im), max_kp=MAX_KP, mode="ref") for im in x]


@pytest.mark.parametrize("kind", ["rgb", "gray", "preprocessed"])
def test_detect_keypoints_matches_jax(kind):
    x = _images(kind)
    want = _jax_detect(x)
    got = tfeatures.detect_keypoints(torch.from_numpy(x), max_kp=MAX_KP)
    assert int(got["valid"].sum()) > 0, "test images detected no keypoints"
    for i, w in enumerate(want):
        for k in ("xy", "scale", "valid"):
            np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(w[k]), err_msg=f"{i} {k}")
        np.testing.assert_allclose(got["resp"][i].numpy(), np.asarray(w["resp"]),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got["gray"][i].numpy(), np.asarray(w["gray"]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["rgb", "preprocessed"])
def test_describe_keypoints_matches_jax(kind):
    x = _images(kind)
    dets = _jax_detect(x)
    det = {k: torch.from_numpy(np.stack([np.array(d[k]) for d in dets]))
           for k in ("xy", "valid", "gray")}
    got = tfeatures.describe_keypoints(det)
    off, total = [], 0
    for i, d in enumerate(dets):
        want = np.asarray(jfeatures.describe_keypoints(d)["desc"])
        err = np.abs(got["desc"][i].numpy() - want).max(axis=1)
        valid = np.asarray(d["valid"])
        assert np.all(err[~valid] == 0.0)
        total += int(valid.sum())
        off += [(i, j, float(err[j])) for j in np.nonzero(valid & (err > 1e-5))[0]]
    assert total > 0
    assert len(off) <= 0.05 * total, f"descriptors off at a bin edge: {off}"


def test_topk_keeps_zero_score_ties_in_index_order():
    """With fewer extrema than max_kp the tail is zero-score ties: lax.top_k
    returns them in index order, and so must the port (torch.topk does not)."""
    rng = np.random.default_rng(0)
    pyr = np.zeros((7, 24, 24), np.float32)
    for _ in range(3):
        s, y, xx = rng.integers(2, 5), rng.integers(9, 15), rng.integers(9, 15)
        pyr[s, y, xx] = 0.5
    pyr = np.cumsum(pyr, axis=0)   # a scale-stack step that makes DoG extrema
    g = np.zeros((24, 24), np.float32)
    want = jfeatures._keypoints_from_pyr(jnp.asarray(pyr), jnp.asarray(g), max_kp=40,
                                         contrast_thresh=0.02, edge_thresh=10.0, border=8)
    got = tfeatures._keypoints_from_pyr(torch.from_numpy(pyr)[None], torch.from_numpy(g)[None],
                                        max_kp=40)
    assert int(np.asarray(want["valid"]).sum()) < 40
    for k in ("xy", "scale", "resp", "valid"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)


def test_gray_normalisation_is_per_image():
    """Images with different maxima in one batch: each is divided by its own
    max, as jax.lax.map does image by image in the JAX pipeline."""
    base = _images("rgb", n=3)
    scale = np.asarray([0.2, 0.5, 1.0], np.float32)[:, None, None, None]
    x = base * scale
    g = tfeatures._normalize_gray(torch.from_numpy(x))
    np.testing.assert_array_equal(g.amax(dim=(1, 2)).numpy(), np.ones(3, np.float32))
    batch = tfeatures.detect_keypoints(torch.from_numpy(x), max_kp=MAX_KP)
    for i, w in enumerate(_jax_detect(x)):
        single = tfeatures.detect_keypoints(torch.from_numpy(x[i : i + 1]), max_kp=MAX_KP)
        for k in ("xy", "scale", "valid"):
            assert torch.equal(batch[k][i], single[k][0])
            np.testing.assert_array_equal(batch[k][i].numpy(), np.asarray(w[k]))


def test_ladder_taps_and_octave_chain_match_jax():
    assert tfeatures.ladder_taps(4, 1.6, 15) == jfeatures.ladder_taps(4, 1.6, 15)
    jc = jfeatures.octave_chain(4, with_next_base=False)
    tc = tfeatures.octave_chain(4, with_next_base=False)
    assert [(s.op, s.tap) for s in tc] == [(s.op, s.tap) for s in jc]
    for js, ts in zip(jc, tc):
        for jw, tw in zip(js.weights, ts.weights):
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    # with the next base (the default in both): the terminal pyrDown tap
    jn, tn = jfeatures.octave_chain(4, with_next_base=True), tfeatures.octave_chain(4)
    assert [(s.op, s.tap) for s in tn] == [(s.op, s.tap) for s in jn]
    assert (tn[-1].op, tn[-1].tap, tn[-1].stride) == ("pyr_down", 4, (2, 2))
    for js, ts in zip(jn, tn):
        for jw, tw in zip(js.weights, ts.weights):
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_matches_jax(dtype):
    x = (np.random.default_rng(1).random((2, 9, 7, 3)) * 255).astype(dtype)
    want = np.asarray(jimgproc.rgb_to_gray(jnp.asarray(x)))
    got = timgproc.rgb_to_gray(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=1e-6, atol=1e-4)


def test_gradients_match_jax():
    g = _images("gray", n=1)[0] / 255.0
    jm, ja = jfeatures.gradients(jnp.asarray(g))
    tm, ta = tfeatures.gradients(torch.from_numpy(g))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    assert np.all(np.abs(ta.numpy()) <= math.pi + 1e-6)


def test_sift_rejects_the_queued_pyramid():
    """The pyramid `sift` once refused: n_octaves=2 now runs it, one
    octave chain a launch (two plain calls on the CPU), with the
    fixed-capacity output of the single-octave detector."""
    counters.reset()
    out = tfeatures.sift(torch.zeros((1, 32, 32)), PipelineConfig(n_octaves=2))
    assert counters.PLAIN_CALLS["stencil_chain"] == 2
    assert tuple(out["desc"].shape) == (1, 32, 128) and not bool(out["valid"].any())
