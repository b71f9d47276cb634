"""Bag-of-visual-words training: k-means dictionary + word histograms (the
counterpart of `repro.cv.bow`).

Plain PyTorch on the CPU.  Their kernel, `bow_assign`, belongs to the
training slice (ROADMAP: "`bow_assign` and training on the card"), so
`cv.pipeline.train` runs them only on the CPU for now.
"""

from __future__ import annotations

import torch

from ..kernels import ref as kref


def _init_indices(weights: torch.Tensor, k: int, generator) -> torch.Tensor:
    """k distinct indices drawn with probability proportional to `weights`
    (Gumbel top-k), uniform when every weight is zero."""
    n = weights.shape[0]
    total = torch.sum(weights)
    p = weights / torch.clamp(total, min=1e-6) if total > 0 else torch.full((n,), 1.0 / n)
    u = torch.rand(n, generator=generator, dtype=torch.float64).clamp(min=1e-300)
    keys = torch.log(p.to(torch.float64)) - torch.log(-torch.log(u))
    return torch.sort(keys, descending=True, stable=True).indices[:k]


def kmeans(
    desc: torch.Tensor,
    weights: torch.Tensor,
    *,
    k: int = 250,
    iters: int = 20,
    generator: torch.Generator | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Lloyd's k-means over descriptors (N, D) with sample weights (N,).

    Returns centroids (k, D).  `init` gives the starting centroids (else k
    weighted draws from `desc` with `generator`).  Empty clusters keep their
    previous centroid.
    """
    desc = desc.to(torch.float32)
    weights = weights.to(torch.float32)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cents = desc[_init_indices(weights, k, generator)]
    else:
        cents = init.to(torch.float32)
    for _ in range(iters):
        idx, _ = kref.bow_assign_ref(desc, cents)
        oh = torch.nn.functional.one_hot(idx.long(), k).to(torch.float32) * weights[:, None]
        counts = torch.sum(oh, dim=0)
        sums = oh.T @ desc
        new = sums / torch.clamp(counts[:, None], min=1e-6)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def histograms(descs: torch.Tensor, valids: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Normalised word histograms: descs (B, N, D) + valids (B, N) -> (B, K),
    assigning by true squared distance (`kernels.ref.bow_assign_ref`)."""
    B, N, D = descs.shape
    idx, _ = kref.bow_assign_ref(descs.reshape(B * N, D).to(torch.float32), centroids)
    h = torch.zeros((B, centroids.shape[0]), dtype=torch.float32, device=descs.device)
    h.scatter_add_(1, idx.long().reshape(B, N), valids.to(torch.float32))
    return h / torch.clamp(torch.sum(h, dim=1, keepdim=True), min=1e-6)
