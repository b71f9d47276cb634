"""Multi-class SVM (the counterpart of `repro.cv.svm`): one-vs-rest
linear, trained by squared-hinge full-batch gradient descent with
momentum, its prediction (the paper's stage III), and an explicit RBF
feature map.  Plain PyTorch on the tensors' device: JAX's versions are no
Pallas kernels either."""

from __future__ import annotations

import torch


def _loss(x, t, w, b, c):
    margins = x @ w.T + b[None, :]
    hinge = torch.clamp(1.0 - t * margins, min=0.0)
    loss = 0.5 * torch.mean(torch.sum(w * w, dim=1)) + c * torch.mean(torch.sum(hinge**2, dim=1))
    return loss, hinge


def svm_train(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    n_classes: int,
    c: float = 1.0,
    lr: float = 0.5,
    steps: int = 500,
) -> dict:
    """x (N, D) f32, y (N,) int -> {'w': (C, D), 'b': (C,), 'final_loss'}."""
    x = x.to(torch.float32)
    N, D = x.shape
    t = 2.0 * torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32) - 1.0
    w = torch.zeros((n_classes, D), dtype=torch.float32, device=x.device)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=x.device)
    vw, vb = torch.zeros_like(w), torch.zeros_like(b)
    for _ in range(steps):
        _, hinge = _loss(x, t, w, b, c)
        gm = (-2.0 * c / N) * hinge * t  # d loss / d margins
        gw = w / n_classes + gm.T @ x
        gb = torch.sum(gm, dim=0)
        vw = 0.9 * vw - lr * gw
        vb = 0.9 * vb - lr * gb
        w, b = w + vw, b + vb
    return {"w": w, "b": b, "final_loss": _loss(x, t, w, b, c)[0]}


def svm_predict(model: dict, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) -> the predicted class (N,) int32: the argmax of
    ``x @ w.T + b`` (the first of equal scores)."""
    scores = x @ model["w"].T + model["b"][None, :]
    return torch.argmax(scores, dim=1).to(torch.int32)


def rbf_features(x: torch.Tensor, anchors: torch.Tensor, gamma: float = 10.0) -> torch.Tensor:
    """x (N, D), anchors (M, D) -> exp(-gamma * |x - anchor|^2) (N, M)."""
    d2 = torch.sum((x[:, None, :] - anchors[None]) ** 2, dim=-1)
    return torch.exp(-gamma * d2)
