"""Carry a trained model across from the JAX package.

`from_jax_model` takes plain numpy arrays (what ``np.asarray(model.centroids)``,
``np.asarray(model.svm["w"])`` and ``np.asarray(model.svm["b"])`` give for a
`repro.cv.pipeline.BowSvmModel`), and `from_jax_gbdt_model` those of a
`repro.cv.pipeline.BowGbdtModel` (``model.centroids`` and
``model.gbdt.{feat, thr, leaf, base}``), so both packages compute with the
same model and this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .cv.gbdt import GbdtModel
from .cv.pipeline import BowGbdtModel, BowSvmModel


def from_jax_model(centroids, w, b, n_classes: int, *, device=None) -> BowSvmModel:
    """numpy centroids (K, D), w (C, K), b (C,) -> the port's `BowSvmModel`
    on `device` (None = "cuda")."""
    dev = resolve_device(device)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    centroids, w, b = f32(centroids), f32(w), f32(b)
    if centroids.ndim != 2 or w.shape != (n_classes, centroids.shape[0]) or b.shape != (n_classes,):
        raise ValueError(
            f"from_jax_model: shapes {tuple(centroids.shape)} / {tuple(w.shape)} / "
            f"{tuple(b.shape)} do not form a {n_classes}-class model"
        )
    return BowSvmModel(centroids, w, b, n_classes)


def from_jax_gbdt_model(
    centroids, feat, thr, leaf, base, n_classes: int, *, device=None
) -> BowGbdtModel:
    """numpy centroids (K, D), feat (T, depth) int, thr (T, depth),
    leaf (T, 2^depth, C), base (C,) -> the port's `BowGbdtModel` on
    `device` (None = "cuda").  Every feature index must name a word."""
    dev = resolve_device(device)
    centroids = np.array(centroids, dtype=np.float32)
    feat_i = np.array(feat)
    thr, leaf, base = (np.array(a, dtype=np.float32) for a in (thr, leaf, base))
    if (
        centroids.ndim != 2
        or feat_i.ndim != 2
        or not np.issubdtype(feat_i.dtype, np.integer)
        or thr.shape != feat_i.shape
        or leaf.shape != (feat_i.shape[0], 2 ** feat_i.shape[1], n_classes)
        or base.shape != (n_classes,)
    ):
        raise ValueError(
            f"from_jax_gbdt_model: shapes {centroids.shape} / feat {feat_i.shape} "
            f"{feat_i.dtype} / thr {thr.shape} / leaf {leaf.shape} / base {base.shape} "
            f"do not form a {n_classes}-class model"
        )
    if feat_i.size and (feat_i.min() < 0 or feat_i.max() >= centroids.shape[0]):
        raise ValueError(
            f"from_jax_gbdt_model: feature indices must lie in [0, {centroids.shape[0]})"
        )
    gbdt = GbdtModel(feat_i.astype(np.int32), thr, leaf, base, n_classes)
    return BowGbdtModel(torch.from_numpy(centroids), gbdt, n_classes).to(dev)
