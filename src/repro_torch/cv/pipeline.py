"""End-to-end BoW image-classification pipeline, paper §4.5 (the counterpart
of `repro.cv.pipeline`).

Training: SIFT keypoints -> descriptors -> k-means dictionary -> word
histograms -> classifier head (one-vs-rest SVM or oblivious-tree GBDT),
on the card: the stencil chains as in prediction, and every word
assignment of k-means and of the histograms one `bow_assign` launch.
Prediction, the timed path: (I) keypoint detection, with the optional
fused preprocess chain one launch per batch and the octave chain one
launch per batch per octave (``config.n_octaves`` > 1 runs the pyramid,
each octave's chain taking the previous one's next base); (II)
descriptors and the word histograms
(`bow_quantize_hist`); (III) the head's scores (`linear_score` or
`gbdt_score`) and argmax.

Every entry point takes ``device=None`` (= ``"cuda"``, raising
`RuntimeError` when there is no CUDA device); pass ``device="cpu"`` to run
the kernels' plain versions.
"""

from __future__ import annotations

import time

import torch
from torch import nn

from ..core.device import resolve_device
from . import bow, classify, features, imgproc, svm
from . import gbdt as gbdt_mod
from .config import PipelineConfig


class BowSvmModel(nn.Module):
    """Trained BoW model: the word dictionary and the one-vs-rest SVM."""

    def __init__(self, centroids, w, b, n_classes: int):
        super().__init__()
        self.register_buffer("centroids", torch.as_tensor(centroids, dtype=torch.float32))
        self.register_buffer("w", torch.as_tensor(w, dtype=torch.float32))
        self.register_buffer("b", torch.as_tensor(b, dtype=torch.float32))
        self.n_classes = int(n_classes)


class BowGbdtModel(nn.Module):
    """Trained BoW model: the word dictionary and the oblivious-tree GBDT."""

    def __init__(self, centroids, gbdt: gbdt_mod.GbdtModel, n_classes: int):
        super().__init__()
        self.register_buffer("centroids", torch.as_tensor(centroids, dtype=torch.float32))
        self.gbdt = gbdt
        self.n_classes = int(n_classes)


def _on_device(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def validate_images(imgs: torch.Tensor, *, name: str = "imgs") -> None:
    """Reject a batch of the wrong rank ((B, H, W) or (B, H, W, C)), of a
    non-image dtype, or with NaN/Inf pixels, with a `ValueError`."""
    if not isinstance(imgs, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(imgs).__name__}")
    if imgs.ndim not in (3, 4):
        raise ValueError(
            f"{name}: expected rank 3 (B, H, W) or rank 4 (B, H, W, C), "
            f"got shape {tuple(imgs.shape)}"
        )
    if not (imgs.is_floating_point() or imgs.dtype == torch.uint8):
        raise ValueError(f"{name}: expected uint8 or floating pixels, got dtype {imgs.dtype}")
    if imgs.is_floating_point() and not bool(torch.all(torch.isfinite(imgs))):
        raise ValueError(f"{name}: input contains NaN/Inf pixels")


def extract_features(
    imgs, config: PipelineConfig | None = None, *, device=None, validate: bool = True
) -> dict:
    """(B, H, W[, C]) -> {"desc": (B, max_kp, 128), "valid": (B, max_kp)}.
    config.preprocess runs the fused blur -> erode -> gradient-magnitude
    chain over the whole batch first; config.n_octaves > 1 detects through
    the pyramid, keypoints in base-image coordinates, so the descriptor and
    histogram stages downstream are unchanged.  config.mode / .ladder go to
    every fused launch."""
    cfg = config if config is not None else PipelineConfig()
    dev = resolve_device(device)
    imgs = _on_device(imgs, dev)
    if validate:
        validate_images(imgs)
    x = imgs.to(torch.float32)
    if cfg.preprocess:
        if x.ndim == 3:  # (B, H, W) gray batch: add and strip a channel axis
            x = imgproc.preprocess_bow(x[..., None], mode=cfg.mode, lc=cfg.lc,
                                       ladder=cfg.ladder)[..., 0]
        else:
            x = imgproc.preprocess_bow(x, mode=cfg.mode, lc=cfg.lc, ladder=cfg.ladder)
    out = features.sift(x, config=cfg)
    return {"desc": out["desc"], "valid": out["valid"]}


def train(
    imgs,
    labels,
    config: PipelineConfig | None = None,
    *,
    n_classes: int = 10,
    dict_size: int = 250,
    generator: torch.Generator | None = None,
    device=None,
    timing: dict | None = None,
):
    """Fit the dictionary and the configured head on `device` (None = the
    card).  Returns a `BowSvmModel` (``config.head == "svm"``) or a
    `BowGbdtModel` (``"gbdt"``).  `generator` is a CPU generator that
    seeds the k-means initialisation (seed 0 when None).  `timing`, when
    given, receives the seconds of the "features", "kmeans", "histograms"
    and "head" stages."""
    cfg = config if config is not None else PipelineConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    feats = extract_features(imgs, cfg, device=dev)
    B, N, D = feats["desc"].shape
    desc = feats["desc"].reshape(B * N, D)
    wts = feats["valid"].reshape(B * N).to(torch.float32)
    _sync(dev)
    t1 = time.perf_counter()
    cents = bow.kmeans(desc, wts, k=dict_size, generator=generator)
    _sync(dev)
    t2 = time.perf_counter()
    hists = bow.histograms(feats["desc"], feats["valid"], cents)
    _sync(dev)
    t3 = time.perf_counter()
    y = _on_device(labels, dev)
    if cfg.head == "gbdt":
        model = BowGbdtModel(cents, gbdt_mod.gbdt_train(hists, y, n_classes=n_classes), n_classes)
    else:
        head = svm.svm_train(hists, y, n_classes=n_classes)
        model = BowSvmModel(cents, head["w"], head["b"], n_classes)
    _sync(dev)
    if timing is not None:
        timing["features"] = t1 - t0
        timing["kmeans"] = t2 - t1
        timing["histograms"] = t3 - t2
        timing["head"] = time.perf_counter() - t3
    return model


def predict(
    model,
    imgs,
    config: PipelineConfig | None = None,
    *,
    device=None,
    validate: bool = True,
    timing: dict | None = None,
    plan: classify.ClassifyPlan | None = None,
) -> torch.Tensor:
    """The paper's three timed test stages for a `BowSvmModel` or a
    `BowGbdtModel`; returns labels (B,) i32 on the device.  Pass ``plan=`` to
    reuse a ClassifyPlan built on that device."""
    cfg = config if config is not None else PipelineConfig()
    dev = resolve_device(device)
    imgs = _on_device(imgs, dev)
    if validate:
        validate_images(imgs)
    if plan is None:
        plan = classify.build_plan(model, cfg, device=dev)
    t0 = time.perf_counter()
    feats = extract_features(imgs, cfg, device=dev, validate=False)
    _sync(dev)
    t1 = time.perf_counter()
    hists = plan.histograms(feats["desc"], feats["valid"])
    _sync(dev)
    t2 = time.perf_counter()
    pred = plan.classify(hists)
    _sync(dev)
    t3 = time.perf_counter()
    if timing is not None:
        timing["keypoint_detection"] = t1 - t0
        timing["feature_generation"] = t2 - t1
        timing["prediction"] = t3 - t2
    return pred


def accuracy(model, imgs, labels, config: PipelineConfig | None = None, *, device=None) -> float:
    dev = resolve_device(device)
    pred = predict(model, imgs, config, device=dev)
    return float(torch.mean((pred.long() == _on_device(labels, dev).long()).to(torch.float32)))
