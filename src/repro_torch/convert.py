"""Carry a trained model across from the JAX package.

`from_jax_model` takes plain numpy arrays (what ``np.asarray(model.centroids)``,
``np.asarray(model.svm["w"])`` and ``np.asarray(model.svm["b"])`` give for a
`repro.cv.pipeline.BowSvmModel`), so both packages compute with the same
model and this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .cv.pipeline import BowSvmModel


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
