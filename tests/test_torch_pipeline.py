"""The port's BoW pipeline against the JAX package's, end to end on the CPU.

A JAX model of each head is trained in-process (48x48 images, 16 of them, a
16-word dictionary, ``mode="ref"``, ``preprocess=True``) and carried across
with `convert.from_jax_model` / `convert.from_jax_gbdt_model`; both
packages then predict on the same images.

Rules, with their reasons:
  * labels are identical, and GBDT leaf indices from the same histograms
    too;
  * histograms from the same descriptors are exact except at counted
    near-ties (tests/test_torch_bow.py: the dot products are summed in
    another order);
  * `svm_train` on the same histograms agrees at rtol 1e-4 / atol 1e-5,
    since 500 momentum steps accumulate the two sides' ulp differences;
  * one Lloyd step of `kmeans` from the same initial centroids agrees at
    1e-5: the port assigns by the kernel's -2 d.c + |c|^2 and JAX's
    `kmeans` by the true distance, so the two agree except where two
    distances lie within rounding (none on this test's data), and the
    centroid means are summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.cv import bow as jbow
from repro.cv import classify as jclassify
from repro.cv import pipeline as jpipeline
from repro.cv import svm as jsvm
from repro.cv.config import PipelineConfig as JaxConfig
from repro.data.synthetic import ImageStream as JaxImageStream

from repro_torch import convert
from repro_torch.cv import bow as tbow
from repro_torch.cv import classify as tclassify
from repro_torch.cv import pipeline as tpipeline
from repro_torch.cv import svm as tsvm
from repro_torch.cv.config import PipelineConfig
from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref

from test_torch_bow import assert_hist_near_tie_rule

JAX_CFG = JaxConfig(mode="ref", preprocess=True)
CFG = PipelineConfig(preprocess=True)


@pytest.fixture(scope="module")
def trained():
    stream = JaxImageStream(res=48)
    imgs, labels = stream.batch(16, split=21)   # integer splits: the same images in any process
    test_imgs, test_labels = stream.batch(24, split=22)
    model = jpipeline.train(jax.random.key(0), imgs, labels, JAX_CFG, dict_size=16)
    port = convert.from_jax_model(np.asarray(model.centroids), np.asarray(model.svm["w"]),
                                  np.asarray(model.svm["b"]), model.n_classes, device="cpu")
    return {"model": model, "port": port, "imgs": np.array(imgs), "labels": np.array(labels),
            "test": np.array(test_imgs), "test_labels": np.array(test_labels)}


def test_predict_labels_identical_to_jax(trained):
    want = np.asarray(jpipeline.predict(trained["model"], jnp.asarray(trained["test"]), JAX_CFG))
    counters.reset()
    timing = {}
    got = tpipeline.predict(trained["port"], torch.from_numpy(trained["test"]), CFG,
                            device="cpu", timing=timing)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert set(timing) == {"keypoint_detection", "feature_generation", "prediction"}
    # the CPU path ran the plain version of each kernel on the path and
    # launched nothing; at 48x48 both chains (halo 4 and 34) resolve to
    # the streaming kernel
    assert counters.PLAIN_CALLS == {
        "stencil_chain": 0,
        "stencil_stream": 2,
        "bow_quantize_hist": 1,
        "linear_score": 1,
        "bow_assign": 0,
        "gbdt_score": 0,
        "flash_attention": 0,
        "seed_gaussian_blur": 0,
        "seed_erode": 0,
        "seed_threshold": 0,
    }
    assert sum(counters.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", ["fused", "ref"])
def test_histograms_from_the_same_descriptors(trained, mode):
    feats = jpipeline.extract_features(jnp.asarray(trained["test"]), JAX_CFG)
    descs, valids = np.array(feats["desc"]), np.array(feats["valid"])
    jplan = jclassify.build_plan(trained["model"], JAX_CFG)
    tplan = tclassify.build_plan(trained["port"], CFG)
    want = np.array(jplan.histograms(jnp.asarray(descs), jnp.asarray(valids)))
    got = tplan.histograms(torch.from_numpy(descs), torch.from_numpy(valids), mode=mode).numpy()
    counts = valids.sum(axis=1, keepdims=True).clip(min=1)
    assert_hist_near_tie_rule(got * counts, want * counts, descs, valids,
                              np.asarray(trained["model"].centroids))
    scores = tplan.scores(torch.from_numpy(want), mode=mode).numpy()
    np.testing.assert_allclose(scores, np.asarray(jplan.scores(jnp.asarray(want))),
                               rtol=1e-6, atol=1e-6)


def test_extract_features_shapes(trained):
    feats = tpipeline.extract_features(torch.from_numpy(trained["test"][:3]), CFG, device="cpu")
    assert feats["desc"].shape == (3, CFG.max_kp, 128)
    assert feats["valid"].shape == (3, CFG.max_kp) and feats["valid"].dtype == torch.bool
    assert bool(torch.all(torch.isfinite(feats["desc"])))


def test_accuracy_matches_jax(trained):
    x, y = trained["test"], trained["test_labels"]
    want = jpipeline.accuracy(trained["model"], jnp.asarray(x), jnp.asarray(y), JAX_CFG)
    got = tpipeline.accuracy(trained["port"], torch.from_numpy(x), torch.from_numpy(y), CFG,
                             device="cpu")
    assert got == pytest.approx(want)


def test_svm_train_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((40, 16)).astype(np.float32)
    x /= x.sum(axis=1, keepdims=True)
    y = rng.integers(0, 4, 40).astype(np.int32)
    want = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), n_classes=4)
    got = tsvm.svm_train(torch.from_numpy(x), torch.from_numpy(y), n_classes=4)
    for k in ("w", "b", "final_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def test_one_lloyd_step_matches_jax():
    rng = np.random.default_rng(1)
    desc = rng.standard_normal((200, 32)).astype(np.float32)
    w = (rng.random(200) < 0.8).astype(np.float32)
    key = jax.random.key(3)
    init = jbow.kmeans(key, jnp.asarray(desc), jnp.asarray(w), k=12, iters=0)
    want = jbow.kmeans(key, jnp.asarray(desc), jnp.asarray(w), k=12, iters=1)
    got = tbow.kmeans(torch.from_numpy(desc), torch.from_numpy(w), k=12, iters=1,
                      init=torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kmeans_seeding_is_weighted_and_distinct():
    desc = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    w = torch.zeros(20)
    w[:6] = 1.0
    g = torch.Generator().manual_seed(0)
    cents = tbow.kmeans(desc, w, k=6, iters=0, generator=g)
    assert sorted(cents[:, 0].tolist()) == [0.0, 2.0, 4.0, 6.0, 8.0, 10.0]
    # all-zero weights: uniform seeding, and empty clusters keep their centroid
    zero = tbow.kmeans(desc, torch.zeros(20), k=4, iters=3, generator=g)
    assert bool(torch.all(torch.isfinite(zero)))


def test_port_trains_on_the_cpu(trained):
    model = tpipeline.train(torch.from_numpy(trained["imgs"]), torch.from_numpy(trained["labels"]),
                            CFG, dict_size=16, device="cpu")
    assert model.centroids.shape == (16, 128) and model.w.shape == (10, 16)
    pred = tpipeline.predict(model, torch.from_numpy(trained["test"]), CFG, device="cpu")
    assert pred.shape == (24,)


def test_from_jax_model_checks_shapes():
    with pytest.raises(ValueError):
        convert.from_jax_model(np.zeros((4, 8)), np.zeros((3, 5)), np.zeros(3), 3, device="cpu")


@pytest.fixture(scope="module")
def trained_gbdt(trained):
    cfg = JaxConfig(mode="ref", preprocess=True, head="gbdt")
    model = jpipeline.train(jax.random.key(0), jnp.asarray(trained["imgs"]),
                            jnp.asarray(trained["labels"]), cfg, dict_size=16)
    g = model.gbdt
    port = convert.from_jax_gbdt_model(
        np.asarray(model.centroids), np.asarray(g.feat), np.asarray(g.thr), np.asarray(g.leaf),
        np.asarray(g.base), model.n_classes, device="cpu")
    return {"model": model, "port": port, "cfg": cfg}


def test_gbdt_predict_labels_identical_to_jax(trained, trained_gbdt):
    x = trained["test"]
    want = np.asarray(jpipeline.predict(trained_gbdt["model"], jnp.asarray(x), trained_gbdt["cfg"]))
    counters.reset()
    got = tpipeline.predict(trained_gbdt["port"], torch.from_numpy(x), CFG, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert counters.PLAIN_CALLS["gbdt_score"] == 1 and counters.PLAIN_CALLS["linear_score"] == 0
    # the plan's leaf indices from the same histograms are the JAX plan's, exactly
    feats = jpipeline.extract_features(jnp.asarray(x), JAX_CFG)
    jplan = jclassify.build_plan(trained_gbdt["model"], JAX_CFG)
    h = np.array(jplan.histograms(feats["desc"], feats["valid"]))
    tplan = tclassify.build_plan(trained_gbdt["port"], CFG)
    for mode in ("fused", "ref"):
        np.testing.assert_array_equal(
            tplan.leaf_indices(torch.from_numpy(h), mode=mode).numpy(),
            np.asarray(jplan.leaf_indices(jnp.asarray(h))),
        )


def test_from_jax_gbdt_model_checks_shapes_and_features(trained_gbdt):
    g = trained_gbdt["model"].gbdt
    parts = [np.asarray(a) for a in (trained_gbdt["model"].centroids, g.feat, g.thr, g.leaf,
                                     g.base)]
    with pytest.raises(ValueError, match="shapes"):
        convert.from_jax_gbdt_model(*parts[:3], parts[3][:, :5], parts[4], 10, device="cpu")
    bad = parts[1].copy()
    bad[0, 0] = parts[0].shape[0]
    with pytest.raises(ValueError, match="feature indices"):
        convert.from_jax_gbdt_model(parts[0], bad, *parts[2:], 10, device="cpu")


def test_bow_histograms_match_jax_kernel_path(trained):
    """`cv.bow.histograms` assigns as JAX's default (``use_kernel=True``)
    does: -2 d.c + |c|^2 with |d|^2 dropped."""
    feats = jpipeline.extract_features(jnp.asarray(trained["test"]), JAX_CFG)
    descs, valids = np.array(feats["desc"]), np.array(feats["valid"])
    cents = np.array(trained["model"].centroids)
    want = np.asarray(jbow.histograms(jnp.asarray(descs), jnp.asarray(valids),
                                      jnp.asarray(cents), use_kernel=True))
    got = tbow.histograms(torch.from_numpy(descs), torch.from_numpy(valids),
                          torch.from_numpy(cents)).numpy()
    counts = valids.sum(axis=1, keepdims=True).clip(min=1)
    assert_hist_near_tie_rule(got * counts, want * counts, descs, valids, cents)


def test_histograms_assign_like_the_jax_kernel_where_distances_tie():
    """One descriptor d = 1000 and words 0.5, 0.5 + 1e-5: the scores s differ
    (word 1 is nearer), but the true squared distances round to one f32
    value, so an assignment by true distance (`bow_assign_ref`, which the
    port's `histograms` used before) picks word 0 where JAX's default kernel
    path picks word 1."""
    descs = np.array([[[1000.0]]], np.float32)
    valids = np.ones((1, 1), bool)
    cents = np.array([[0.5], [0.5 + 1e-5]], np.float32)
    want = np.asarray(jbow.histograms(jnp.asarray(descs), jnp.asarray(valids),
                                      jnp.asarray(cents), use_kernel=True))
    got = tbow.histograms(torch.from_numpy(descs), torch.from_numpy(valids),
                          torch.from_numpy(cents)).numpy()
    np.testing.assert_array_equal(want, [[0.0, 1.0]])
    np.testing.assert_array_equal(got, want)
    by_distance, _ = tref.bow_assign_ref(torch.from_numpy(descs[0]), torch.from_numpy(cents))
    assert by_distance.tolist() == [0]


def test_port_trains_gbdt_on_the_cpu(trained):
    counters.reset()
    model = tpipeline.train(torch.from_numpy(trained["imgs"]), torch.from_numpy(trained["labels"]),
                            PipelineConfig(preprocess=True, head="gbdt"), dict_size=16,
                            device="cpu")
    assert isinstance(model, tpipeline.BowGbdtModel)
    assert model.centroids.shape == (16, 128)
    assert model.gbdt.feat.shape == (16, 3) and model.gbdt.leaf.shape == (16, 8, 10)
    assert counters.PLAIN_CALLS["bow_assign"] == 21  # 20 k-means iterations + the histograms
    assert sum(counters.LAUNCHES.values()) == 0
    pred = tpipeline.predict(model, torch.from_numpy(trained["test"]), CFG, device="cpu")
    assert pred.shape == (24,) and pred.dtype == torch.int32
