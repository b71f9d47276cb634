"""The port's multi-octave SIFT pyramid against the JAX package's, on the CPU.

The JAX side runs with ``mode="ref"`` (`chain_ref` for every link; its
Pallas stencil plans do not lower on every jax release).  Its oracle is
slow to trace, so each JAX result is computed once per module.  Inputs are
made from a numpy seed (smooth blobs of several sizes, so that every octave
holds extrema) and handed to both packages.

Tolerances, with their reasons:
  * bands: the repo's f32 oracle tolerance, rtol 2e-5 and atol 2e-3
    (tests/test_pyramid.py): XLA may contract a blur's multiply-add;
  * keypoints: (xy, octave, scale) identical except at counted near-ties,
    where two responses lie within 4 f32 ulps and the bands' ulp
    differences may swap them (each one reported); resp at rtol 2e-5,
    atol 1e-6;
  * descriptors: atol 1e-5 for at least 95% of the valid keypoints (an
    orientation bin edge within an ulp, tests/test_torch_features.py);
  * labels of `predict` with a carried-over model: identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.cv import bow as jbow
from repro.cv import classify as jclassify
from repro.cv import features as jfeatures
from repro.cv import gbdt as jgbdt
from repro.cv import pipeline as jpipeline
from repro.cv import svm as jsvm
from repro.cv.config import PipelineConfig as JaxConfig
from repro.data.synthetic import ImageStream as JaxImageStream
from repro.kernels import stencil as jstencil
from repro.kernels.stencil import plan as jplan

from repro_torch import convert
from repro_torch.cv import features as tfeatures
from repro_torch.cv import pipeline as tpipeline
from repro_torch.cv.config import PipelineConfig
from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil

RTOL, ATOL = 2e-5, 2e-3
N_OCT, MAX_KP = 3, 32


def _blobs(shape, seed):
    """Smooth Gaussian blobs of sigma 1.5 to 9 on a dim ramp, f32 in [0, 255]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    img = 20.0 + 10.0 * xx / shape[1]
    for _ in range(14):
        s = rng.uniform(1.5, 9.0)
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img += rng.uniform(40, 120) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return (img / img.max() * 255.0).astype(np.float32)


IMGS = np.stack([_blobs((96, 128), 1), _blobs((96, 128), 2)])


@pytest.fixture(scope="module")
def jax_pyr():
    """Per image: JAX `sift_pyramid` (n_octaves=3, mode="ref"), its
    descriptors, and the bands of `chained_launches` on the normalised gray."""
    out = []
    chains = jfeatures.pyramid_chains(N_OCT)
    for im in IMGS:
        det = jfeatures.sift_pyramid(jnp.asarray(im), n_octaves=N_OCT, max_kp=MAX_KP, mode="ref")
        desc = jfeatures.describe_keypoints(det)["desc"]
        bands, scales = jstencil.chained_launches(det["gray"], chains, mode="ref")
        few = jfeatures.sift_pyramid(jnp.asarray(im), n_octaves=N_OCT, max_kp=MAX_KP,
                                     kp_per_octave=4, mode="ref")
        out.append({"det": {k: np.asarray(v) for k, v in det.items()}, "desc": np.asarray(desc),
                    "bands": [[np.asarray(b) for b in o] for o in bands], "scales": scales,
                    "few": {k: np.asarray(v) for k, v in few.items()}})
    return out


def _near_ties(resp, ulps=4):
    """Keypoints whose response lies within `ulps` f32 ulps of a neighbour's
    in the sorted order (where ulp-level band differences may swap them)."""
    r = np.asarray(resp, np.float32)
    ulp = np.spacing(np.abs(r)).astype(np.float64)
    gap = np.full(r.shape, np.inf)
    d = np.abs(np.diff(r.astype(np.float64)))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap <= ulps * ulp


@pytest.mark.parametrize("n_octaves", [1, 2, 4])
def test_pyramid_chains_match_jax(n_octaves):
    """The port's per-octave chains equal JAX's, chain for chain: ops,
    statics, taps, tap weights; every link but the last keeps the
    next-base contract."""
    jc, tc = jfeatures.pyramid_chains(n_octaves), tfeatures.pyramid_chains(n_octaves)
    assert len(jc) == len(tc) == n_octaves
    for j, t in zip(jc, tc):
        assert [(s.op, s.static, s.tap) for s in t] == [(s.op, s.static, s.tap) for s in j]
        for js, ts in zip(j, t):
            for jw, tw in zip(js.weights, ts.weights):
                np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    for k, t in enumerate(tc[:-1]):
        assert tstencil.validate_next_base(t) == jstencil.validate_next_base(jc[k])


def test_validate_next_base_refuses_a_link_without_a_carry():
    chains = (tfeatures.octave_chain(4, with_next_base=False),) * 2
    with pytest.raises(ValueError, match="next_base"):
        tstencil.chained_launches(torch.zeros((40, 40, 1)), chains)
    with pytest.raises(ValueError, match="next-base"):
        tref.pyramid_ref(torch.zeros((40, 40, 1)), chains)


def test_chained_launches_and_pyramid_ref_bands_and_scales(jax_pyr):
    """One plain call per link on the CPU; the bands equal `pyramid_ref`'s
    bit for bit and JAX's within the f32 tolerance; the scales double."""
    g = tfeatures._normalize_gray(torch.from_numpy(IMGS))
    chains = tfeatures.pyramid_chains(N_OCT)
    counters.reset()
    outs, scales = tstencil.chained_launches(g[..., None], chains)
    assert sum(counters.PLAIN_CALLS.values()) == N_OCT and sum(counters.LAUNCHES.values()) == 0
    ref_outs, ref_scales = tref.pyramid_ref(g[..., None], chains)
    assert scales == ref_scales == [(1, 1), (2, 2), (4, 4)]
    assert [len(o) for o in outs] == [7, 7, 7]
    for a, b in zip(outs, ref_outs):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)
    for i, want in enumerate(jax_pyr):
        assert want["scales"] == scales
        for o, (got_o, want_o) in enumerate(zip(outs, want["bands"])):
            assert got_o[0].shape[1:3] == (96 // 2 ** o, 128 // 2 ** o)
            for x, y in zip(got_o, want_o, strict=True):
                np.testing.assert_allclose(x[i, ..., 0].numpy(), y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(512, 512), (1080, 1920), (37, 53), (32, 32)])
def test_pyramid_plan(shape):
    """Per link: the planes' shape and halo as JAX plans them, and the mode
    `resolve_mode` gives; every link launches (no plain-version tail), so
    the launches are the links."""
    tc, jc = tfeatures.pyramid_chains(4), jfeatures.pyramid_chains(4)
    got = tstencil.pyramid_plan(tc, shape)
    want = jplan.pyramid_plan(jc, shape)
    assert [(r["shape"], r["halo"]) for r in got] == [(r["shape"], r["halo"]) for r in want]
    for r, c in zip(got, tc):
        assert r["mode"] == tstencil.resolve_mode(c, (1, *r["shape"]), torch.float32)
        if r["shape"][0] <= r["halo"][0] or r["shape"][1] <= r["halo"][1]:
            assert r["mode"] == "window"
    if shape == (1080, 1920):
        assert [r["shape"] for r in got] == [(1080, 1920), (540, 960), (270, 480), (135, 240)]


def test_sift_pyramid_keypoints_match_jax(jax_pyr):
    """Keypoints in base-image coordinates: (xy, octave, scale) identical
    to JAX's except at counted near-ties; at least one keypoint from an
    octave above the base."""
    got = tfeatures.sift_pyramid(torch.from_numpy(IMGS), n_octaves=N_OCT, max_kp=MAX_KP)
    assert tuple(got["xy"].shape) == (2, MAX_KP, 2) and got["octave"].dtype == torch.int32
    off, upper = [], 0
    for i, want in enumerate(jax_pyr):
        w = want["det"]
        np.testing.assert_allclose(got["resp"][i].numpy(), w["resp"], rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(got["valid"][i].numpy(), w["valid"])
        same = ((got["xy"][i].numpy() == w["xy"]).all(-1) & (got["octave"][i].numpy() == w["octave"])
                & (got["scale"][i].numpy() == w["scale"]))
        near = _near_ties(w["resp"])
        off += [(i, j) for j in np.nonzero(~same)[0]]
        assert np.all(near[~same]), f"keypoints differ off a near-tie: {off}"
        np.testing.assert_allclose(got["gray"][i].numpy(), w["gray"], rtol=1e-6, atol=1e-7)
        upper += int((w["octave"][w["valid"]] > 0).sum())
    assert int(got["valid"].sum()) > 0 and upper > 0, "no keypoint above the base octave"
    print(f"sift_pyramid: {len(off)} keypoints differ from JAX, each at a near-tie: {off}")


def test_base_coordinates_are_octave_pixels_times_the_scale():
    """Each valid keypoint's base-image xy is its octave pixel times 2^octave:
    the merge reproduces the per-octave detector at that pixel."""
    x = torch.from_numpy(IMGS)
    got = tfeatures.sift_pyramid(x, n_octaves=N_OCT, max_kp=MAX_KP)
    g = tfeatures._normalize_gray(x)
    outs, scales = tstencil.chained_launches(g[..., None], tfeatures.pyramid_chains(N_OCT))
    for o, (bands, (sy, sx)) in enumerate(zip(outs, scales)):
        det = tfeatures._keypoints_from_pyr(torch.stack([b[..., 0] for b in bands], dim=1),
                                            bands[0][..., 0], max_kp=MAX_KP)
        for i in range(x.shape[0]):
            sel = got["valid"][i] & (got["octave"][i] == o)
            pix = set(map(tuple, det["xy"][i][det["valid"][i]].tolist()))
            for xb, yb in got["xy"][i][sel].tolist():
                assert xb % sx == 0 and yb % sy == 0
                assert (xb / sx, yb / sy) in pix


def test_pyramid_kp_per_octave_below_capacity(jax_pyr):
    """Fewer candidates than capacity (4 a octave x 3 octaves < 32): the
    set is padded back to max_kp with invalid zeros, as JAX's is."""
    got = tfeatures.sift_pyramid(torch.from_numpy(IMGS), n_octaves=N_OCT, max_kp=MAX_KP,
                                 kp_per_octave=4)
    assert tuple(got["resp"].shape) == (2, MAX_KP)
    for i, want in enumerate(jax_pyr):
        w = want["few"]
        assert not got["valid"][i, 12:].any() and not w["valid"][12:].any()
        assert float(got["resp"][i, 12:].abs().sum()) == 0.0
        np.testing.assert_array_equal(got["valid"][i].numpy(), w["valid"])
        np.testing.assert_allclose(got["resp"][i].numpy(), w["resp"], rtol=2e-5, atol=1e-6)


def test_sift_descriptors_at_three_octaves(jax_pyr):
    """`sift` with n_octaves=3 routes through the pyramid: descriptors at
    the base-image keypoints, within atol 1e-5 for 95% of them (JAX's
    keypoints fed to both describers, so near-ties do not enter)."""
    det = {k: torch.from_numpy(np.stack([w["det"][k] for w in jax_pyr]))
           for k in ("xy", "valid", "gray")}
    got = tfeatures.describe_keypoints(det)["desc"].numpy()
    off, total = [], 0
    for i, w in enumerate(jax_pyr):
        err = np.abs(got[i] - w["desc"]).max(axis=1)
        valid = w["det"]["valid"]
        assert np.all(err[~valid] == 0.0)
        total += int(valid.sum())
        off += [(i, j) for j in np.nonzero(valid & (err > 1e-5))[0]]
    assert total > 0 and len(off) <= 0.05 * total, off
    out = tfeatures.sift(torch.from_numpy(IMGS), PipelineConfig(n_octaves=N_OCT, max_kp=MAX_KP))
    assert tuple(out["desc"].shape) == (2, MAX_KP, 128)
    np.testing.assert_array_equal(out["valid"].numpy(), np.stack([w["det"]["valid"]
                                                                  for w in jax_pyr]))


JAX_CFG = JaxConfig(mode="ref", preprocess=True, n_octaves=N_OCT)
CFG = PipelineConfig(preprocess=True, n_octaves=N_OCT)


@pytest.fixture(scope="module")
def carried():
    """JAX features at n_octaves=3 (16 training and 16 test images of
    48x48), a 16-word dictionary, an SVM and a GBDT head trained from them
    in JAX and carried over; JAX's labels for the test images."""
    stream = JaxImageStream(res=48)
    imgs, labels = stream.batch(16, split=31)
    test_imgs, _ = stream.batch(16, split=32)
    feats = jpipeline.extract_features(imgs, JAX_CFG)
    B, N, D = feats["desc"].shape
    cents = jbow.kmeans(jax.random.key(0), feats["desc"].reshape(B * N, D),
                        feats["valid"].reshape(B * N).astype(jnp.float32), k=16)
    hists = jbow.histograms(feats["desc"], feats["valid"], cents)
    svm = jsvm.svm_train(hists, labels, n_classes=10)
    gb = jgbdt.gbdt_train(hists, labels, n_classes=10)
    models = {
        "svm": jpipeline.BowSvmModel(centroids=cents, svm=svm, n_classes=10),
        "gbdt": jpipeline.BowGbdtModel(centroids=cents, gbdt=gb, n_classes=10),
    }
    test_feats = jpipeline.extract_features(test_imgs, JAX_CFG)
    want = {}
    for head, m in models.items():
        plan = jclassify.build_plan(m, JAX_CFG)
        want[head] = np.asarray(plan.classify(plan.histograms(test_feats["desc"],
                                                              test_feats["valid"])))
    port = {
        "svm": convert.from_jax_model(np.asarray(cents), np.asarray(svm["w"]), np.asarray(svm["b"]),
                                      10, device="cpu"),
        "gbdt": convert.from_jax_gbdt_model(np.asarray(cents), np.asarray(gb.feat),
                                            np.asarray(gb.thr), np.asarray(gb.leaf),
                                            np.asarray(gb.base), 10, device="cpu"),
    }
    return {"test": np.array(test_imgs), "want": want, "port": port}


@pytest.mark.parametrize("head", ["svm", "gbdt"])
def test_predict_at_three_octaves_matches_jax(carried, head):
    """`predict` at n_octaves=3 with a carried-over model: labels identical
    to JAX's; on the CPU one plain call of the preprocess chain and one per
    octave (the 48-pixel base over the 36-pixel halo streams, the 24- and
    12-pixel octaves under theirs take the window kernel's plain version),
    and no launch."""
    counters.reset()
    got = tpipeline.predict(carried["port"][head], torch.from_numpy(carried["test"]), CFG,
                            device="cpu")
    np.testing.assert_array_equal(got.numpy(), carried["want"][head])
    assert counters.PLAIN_CALLS["stencil_stream"] == 2
    assert counters.PLAIN_CALLS["stencil_chain"] == N_OCT - 1
    assert sum(counters.LAUNCHES.values()) == 0
