"""Bag-of-visual-words training: k-means dictionary + word histograms (the
counterpart of `repro.cv.bow`).

Both assign descriptors to words through `kernels.bow.bow_assign`: the
kernel for a CUDA tensor, its plain version for a CPU tensor.  The rest is
plain PyTorch on the descriptors' device.
"""

from __future__ import annotations

import torch

from ..kernels import bow as kbow


def _init_indices(weights: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct indices drawn with probability proportional to `weights`
    (Gumbel top-k), uniform when every weight is zero.  The noise comes from
    the CPU `generator` on the CPU, so one seed picks the same indices
    whatever device the weights lie on; they are returned on that device."""
    w = weights.detach().to("cpu", torch.float32)
    n = w.shape[0]
    total = torch.sum(w)
    p = w / torch.clamp(total, min=1e-6) if total > 0 else torch.full((n,), 1.0 / n)
    u = torch.rand(n, generator=generator, dtype=torch.float64).clamp(min=1e-300)
    keys = torch.log(p.to(torch.float64)) - torch.log(-torch.log(u))
    return torch.sort(keys, descending=True, stable=True).indices[:k].to(weights.device)


def kmeans(
    desc: torch.Tensor,
    weights: torch.Tensor,
    *,
    k: int = 250,
    iters: int = 20,
    generator: torch.Generator | None = None,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Lloyd's k-means over descriptors (N, D) with sample weights (N,), on
    the descriptors' device.

    Returns centroids (k, D).  `init` gives the starting centroids (else k
    weighted draws from `desc` with the CPU `generator`, seed 0 when None).
    Empty clusters keep their previous centroid.  Each iteration assigns
    through `kernels.bow.bow_assign` (argmin of -2 d.c + |c|^2, one launch on
    the card), where JAX's `kmeans` assigns by the true squared distance
    (`kernels.ref.bow_assign_ref`): the two pick different words only where
    two distances lie within rounding of each other.
    """
    desc = desc.to(torch.float32).contiguous()
    weights = weights.to(torch.float32)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cents = desc[_init_indices(weights, k, generator)]
    else:
        cents = init.to(device=desc.device, dtype=torch.float32)
    for _ in range(iters):
        idx, _ = kbow.bow_assign(desc, cents.contiguous())
        oh = torch.nn.functional.one_hot(idx.long(), k).to(torch.float32) * weights[:, None]
        counts = torch.sum(oh, dim=0)
        sums = oh.T @ desc
        new = sums / torch.clamp(counts[:, None], min=1e-6)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def histograms(descs: torch.Tensor, valids: torch.Tensor, centroids: torch.Tensor, *,
               use_kernel: bool = True, fused: bool = False) -> torch.Tensor:
    """Normalised word histograms, the one histogram entry point: batched
    descs (B, N, D) + valids (B, N) -> (B, K); unbatched (N, D) + (N,) ->
    (K,) through the same path (a leading batch axis of one).

    ``fused=True`` runs the single-launch quantize -> histogram kernel
    (`kernels.bow.bow_quantize_hist`, the `ClassifyPlan` fused mode); the
    default materialises word indices through `kernels.bow.bow_assign`
    (its plain version `bow_assign_plain` when ``use_kernel=False``) and
    scatter-adds, which is what k-means training reuses."""
    if descs.ndim == 2:
        return histograms(descs[None], valids[None], centroids, use_kernel=use_kernel,
                          fused=fused)[0]
    descs = descs.to(torch.float32).contiguous()
    centroids = centroids.to(torch.float32).contiguous()
    if fused:
        return kbow.bow_quantize_hist(descs, valids, centroids)
    B, N, D = descs.shape
    assign = kbow.bow_assign if use_kernel else kbow.bow_assign_plain
    idx, _ = assign(descs.reshape(B * N, D), centroids)
    h = torch.zeros((B, centroids.shape[0]), dtype=torch.float32, device=descs.device)
    h.scatter_add_(1, idx.long().reshape(B, N), valids.to(torch.float32))
    return kbow.normalize_hist(h)


def histogram(desc: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, *,
              use_kernel: bool = True) -> torch.Tensor:
    """Per-image histogram: the unbatched form of `histograms`."""
    return histograms(desc, valid, centroids, use_kernel=use_kernel)


def batch_histograms(descs: torch.Tensor, valids: torch.Tensor, centroids: torch.Tensor, *,
                     use_kernel: bool = True) -> torch.Tensor:
    """Batched histograms: an alias of `histograms` kept for JAX's call sites."""
    return histograms(descs, valids, centroids, use_kernel=use_kernel)
