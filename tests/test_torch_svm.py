"""The port's `cv.svm` prediction and RBF features against the JAX
package's, and the `cv` and `data` package surfaces against JAX's.

Tolerances: `svm_predict` gives JAX's labels except where a row's best two
scores lie within 4 ulp of each other (two f32 matmuls summing in other
orders may order them either way; such rows are counted, and must be
few); `rbf_features` within 1e-6 (f32 exponentials of the same squared
distances, measured: below 1e-7)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.cv as jcv
import repro.data as jdata
from repro.cv import svm as jsvm

import repro_torch.cv as tcv
import repro_torch.data as tdata
from repro_torch.cv import svm as tsvm

ULPS = 4


def _near_ties(scores: np.ndarray) -> np.ndarray:
    """Rows whose best two scores lie within `ULPS` ulp."""
    top2 = np.sort(scores, axis=1)[:, -2:]
    return np.abs(top2[:, 1] - top2[:, 0]) <= ULPS * np.spacing(np.abs(top2[:, 1]))


@pytest.mark.parametrize("n,d,c", [(257, 250, 10), (64, 31, 3), (1000, 128, 33)])
def test_svm_predict_matches_jax(n, d, c):
    rng = np.random.default_rng(n + d + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    # planted exact ties: two classes with the same weights, the first must win
    w[1], b[1] = w[0], b[0]
    want = np.asarray(jsvm.svm_predict({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                       jnp.asarray(x)))
    got = tsvm.svm_predict({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                           torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = got.numpy()
    # the planted pair: equal scores, the first class in both packages
    assert not (got == 1).any() and not (want == 1).any()
    scores = (x.astype(np.float64) @ w.T.astype(np.float64) + b).astype(np.float32)
    ties = _near_ties(np.delete(scores, 1, axis=1))
    off = got != want
    assert not (off & ~ties).any(), np.nonzero(off & ~ties)
    assert ties.sum() <= max(1, n // 50), ties.sum()


def test_rbf_features_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 16)).astype(np.float32) * 0.2
    anchors = rng.standard_normal((9, 16)).astype(np.float32) * 0.2
    for gamma in (10.0, 0.5):
        want = np.asarray(jsvm.rbf_features(jnp.asarray(x), jnp.asarray(anchors), gamma))
        got = tsvm.rbf_features(torch.from_numpy(x), torch.from_numpy(anchors), gamma)
        assert got.shape == (40, 9)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_the_package_surfaces_are_jaxs():
    assert tcv.__all__ == jcv.__all__
    for name in tcv.__all__:
        assert getattr(tcv, name) is not None
    assert tcv.CLASSIFY_MODES == jcv.CLASSIFY_MODES
    assert tcv.PipelineConfig is tcv.config.PipelineConfig
    assert sorted(tdata.__all__) == sorted(n for n in ("ImageStream", "TokenStream")
                                           if hasattr(jdata, n))
    assert tdata.TokenStream is tdata.synthetic.TokenStream
    assert tdata.ImageStream is tdata.synthetic.ImageStream
