"""Gradient-boosted oblivious decision trees over BoW histograms (the
counterpart of `repro.cv.gbdt`).

The second classifier head of the paper's §4.5 pipeline: every node at
depth l of a tree shares one (feature, threshold) split, so a tree of
depth d is d comparisons and its leaf index is the d-bit comparison mask
(level l contributes bit 2^l, as in `kernels.gbdt`).  Training is
deterministic multi-output residual boosting on one-hot class targets, in
plain PyTorch on the features' device; prediction runs through
`kernels.gbdt.gbdt_score` behind `cv.classify.ClassifyPlan`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import ref as kref


class GbdtModel(nn.Module):
    """Oblivious-tree ensemble: feat (T, depth) i32, thr (T, depth), leaf
    (T, 2^depth, C), base (C,) f32 buffers, and ``n_classes``."""

    def __init__(self, feat, thr, leaf, base, n_classes: int):
        super().__init__()
        self.register_buffer("feat", torch.as_tensor(feat, dtype=torch.int32).contiguous())
        self.register_buffer("thr", torch.as_tensor(thr, dtype=torch.float32).contiguous())
        self.register_buffer("leaf", torch.as_tensor(leaf, dtype=torch.float32).contiguous())
        self.register_buffer("base", torch.as_tensor(base, dtype=torch.float32).contiguous())
        self.n_classes = int(n_classes)


def _level_split(x, r, pid, n_leaves: int, thresholds):
    """Best oblivious split for one level: maximise the sum over children of
    |sum of residuals|^2 / count.  x (N, F), r (N, C), pid (N,) current
    partition, thresholds (F, Q) candidate values per feature.
    Returns (feature, threshold, bits (N,)) as tensors on x's device."""
    N, F = x.shape
    Q = thresholds.shape[1]
    C = r.shape[1]
    bits = x[:, :, None] > thresholds[None, :, :]  # (N, F, Q)
    poh = nn.functional.one_hot(pid.long(), n_leaves).to(torch.float32)  # (N, P)
    bf = bits.reshape(N, F * Q).to(torch.float32)
    s_all = poh.T @ r  # (P, C)
    c_all = torch.sum(poh, dim=0)  # (P,)
    # right-child sums per (candidate, parent, class), without an (N, FQ, P, C) intermediate
    s_r = (bf.T @ (poh[:, :, None] * r[:, None, :]).reshape(N, n_leaves * C)).reshape(
        F * Q, n_leaves, C
    )
    c_r = bf.T @ poh  # (FQ, P)
    s_l = s_all[None] - s_r
    c_l = c_all[None] - c_r

    def score(s, c):
        return torch.sum(torch.sum(s * s, dim=-1) / torch.clamp(c, min=1e-6), dim=-1)

    gain = score(s_r, c_r) + score(s_l, c_l)
    best = torch.argmax(gain).reshape(1)  # the first maximum, as jnp.argmax
    # index with tensors so that the card never waits on a copy to the host
    thr = thresholds.reshape(F * Q).index_select(0, best)[0]
    return best[0] // Q, thr, bf.index_select(1, best)[:, 0] > 0


def gbdt_train(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    n_classes: int,
    n_trees: int = 16,
    depth: int = 3,
    lr: float = 0.5,
    n_bins: int = 8,
) -> GbdtModel:
    """Fit an oblivious GBDT on features x (N, F), labels y (N,) int, on
    x's device."""
    x = x.to(torch.float32)
    N, F = x.shape
    L = 2**depth
    yoh = nn.functional.one_hot(y.to(x.device).long(), n_classes).to(torch.float32)
    base = torch.mean(yoh, dim=0)
    pred = base.expand(N, n_classes)
    # per-feature candidate thresholds: interior quantiles of the data
    qs = torch.linspace(0.0, 1.0, n_bins + 2)[1:-1].to(x.device)
    thresholds = torch.quantile(x, qs, dim=0).T.contiguous()  # (F, Q), linear interpolation

    feats, thrs, leaves = [], [], []
    for _ in range(n_trees):
        r = yoh - pred
        pid = torch.zeros((N,), dtype=torch.int32, device=x.device)
        tf, tt = [], []
        for lvl in range(depth):
            f, t, bits = _level_split(x, r, pid, 2**lvl, thresholds)
            tf.append(f)
            tt.append(t)
            pid = pid + bits.to(torch.int32) * (2**lvl)
        poh = nn.functional.one_hot(pid.long(), L).to(torch.float32)  # (N, L)
        cnt = torch.sum(poh, dim=0)  # (L,)
        mean_r = (poh.T @ r) / torch.clamp(cnt[:, None], min=1e-6)
        leaf = lr * torch.where(cnt[:, None] > 0, mean_r, 0.0)  # (L, C)
        pred = pred + poh @ leaf
        feats.append(torch.stack(tf))
        thrs.append(torch.stack(tt))
        leaves.append(leaf)

    return GbdtModel(
        feat=torch.stack(feats),
        thr=torch.stack(thrs),
        leaf=torch.stack(leaves),
        base=base,
        n_classes=n_classes,
    )


def gbdt_predict_ref(model: GbdtModel, x: torch.Tensor) -> torch.Tensor:
    """Class prediction through the staged oracle (the plan's "ref" mode)."""
    s = kref.gbdt_scores_ref(x.to(torch.float32), model.feat, model.thr, model.leaf, model.base)
    return torch.argmax(s, dim=1).to(torch.int32)
