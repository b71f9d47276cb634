"""ClassifyPlan: the classifier tail (quantize -> histogram -> classify)
behind one plan seam (the counterpart of `repro.cv.classify`).

Modes:

  fused  `kernels.bow.bow_quantize_hist` then `kernels.bow.linear_score`:
         the whole tail in two launches on a CUDA tensor (a CPU tensor
         runs the kernels' plain versions).
  ref    the kernels' plain PyTorch versions on either device.

There is no degradation ladder: a fused launch that fails raises.  The
GBDT head is queued.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import DEFAULT, LaunchConfig
from ..kernels import bow as kbow
from .config import PipelineConfig

CLASSIFY_MODES = ("fused", "ref")


@dataclass(frozen=True, eq=False)
class ClassifyPlan:
    """Bound classifier tail: codebook + SVM head + execution mode.

    mode: None = "fused"; "fused" | "ref" pins the mode for every call.
    """

    centroids: torch.Tensor
    n_classes: int
    w: torch.Tensor
    b: torch.Tensor
    head: str = "svm"
    mode: str | None = None
    normalize: bool = True
    lc: LaunchConfig = DEFAULT

    def __post_init__(self):
        if self.head == "gbdt":
            raise NotImplementedError("ClassifyPlan: the GBDT head is not ported yet")
        if self.head != "svm":
            raise ValueError(f"ClassifyPlan: unknown head {self.head!r}")
        self.resolve_mode(self.mode)

    def resolve_mode(self, mode: str | None = None) -> str:
        """Explicit arg -> plan.mode -> "fused"."""
        m = mode or self.mode or "fused"
        if m not in CLASSIFY_MODES:
            raise ValueError(f"ClassifyPlan: unknown mode {m!r} (expected one of {CLASSIFY_MODES})")
        return m

    def histograms(self, descs: torch.Tensor, valids: torch.Tensor, *, mode=None):
        """descs (B, N, D) + valids (B, N) -> word histograms (B, K)."""
        descs = descs.to(torch.float32).contiguous()
        if self.resolve_mode(mode) == "fused":
            return kbow.bow_quantize_hist(
                descs, valids, self.centroids, normalize=self.normalize, lc=self.lc
            )
        h = kbow.quantize_hist_plain(descs, valids, self.centroids)
        return kbow.normalize_hist(h) if self.normalize else h

    def scores(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """Histograms (B, K) -> decision scores (B, n_classes)."""
        hists = hists.to(torch.float32).contiguous()
        if self.resolve_mode(mode) == "fused":
            return kbow.linear_score(hists, self.w, self.b, lc=self.lc)
        return kbow.linear_score_plain(hists, self.w, self.b)

    def classify(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """Histograms -> predicted labels (B,) i32."""
        return torch.argmax(self.scores(hists, mode=mode), dim=1).to(torch.int32)

    def __call__(self, descs: torch.Tensor, valids: torch.Tensor, *, mode=None) -> dict:
        """The whole tail: descriptors -> {"hist", "scores", "label"}."""
        h = self.histograms(descs, valids, mode=mode)
        s = self.scores(h, mode=mode)
        return {"hist": h, "scores": s, "label": torch.argmax(s, dim=1).to(torch.int32)}


def build_plan(model, config: PipelineConfig | None = None, *, device=None) -> ClassifyPlan:
    """Bind a trained `BowSvmModel` to a ClassifyPlan on `device` (default:
    the model's own) with the config's classifier knobs."""
    cfg = config if config is not None else PipelineConfig()
    if cfg.head == "gbdt":
        raise NotImplementedError("build_plan: the GBDT head is not ported yet")
    dev = device if device is not None else model.centroids.device

    def on_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=torch.float32).contiguous()

    return ClassifyPlan(
        centroids=on_dev(model.centroids),
        n_classes=model.n_classes,
        w=on_dev(model.w),
        b=on_dev(model.b),
        mode=cfg.classify_mode,
        lc=cfg.lc,
    )
