"""ClassifyPlan: the classifier tail (quantize -> histogram -> classify)
behind one plan seam (the counterpart of `repro.cv.classify`).

Modes:

  fused  `kernels.bow.bow_quantize_hist`, then `kernels.bow.linear_score`
         (SVM head) or `kernels.gbdt.gbdt_score` (GBDT head): the whole
         tail in two launches on a CUDA tensor (a CPU tensor runs the
         kernels' plain versions).
  ref    plain PyTorch on either device: the kernels' plain versions for
         the histograms and the SVM scores, the staged oracles
         `kernels.ref.gbdt_scores_ref` / `gbdt_leaf_ref` for the GBDT head.

There is no degradation ladder: a fused launch that fails raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import DEFAULT, LaunchConfig
from ..kernels import bow as kbow
from ..kernels import gbdt as kgbdt
from ..kernels import ref as kref
from .config import PipelineConfig
from .gbdt import GbdtModel

CLASSIFY_MODES = ("fused", "ref")


@dataclass(frozen=True, eq=False)
class ClassifyPlan:
    """Bound classifier tail: codebook + head parameters + execution mode.

    head: "svm" (w (C, K), b (C,)) or "gbdt" (`cv.gbdt.GbdtModel`).
    mode: None = "fused"; "fused" | "ref" pins the mode for every call.
    """

    centroids: torch.Tensor
    n_classes: int
    w: torch.Tensor | None = None
    b: torch.Tensor | None = None
    head: str = "svm"
    gbdt: GbdtModel | None = None
    mode: str | None = None
    normalize: bool = True
    lc: LaunchConfig = DEFAULT

    def __post_init__(self):
        if self.head == "svm":
            if self.w is None or self.b is None:
                raise ValueError("ClassifyPlan: head='svm' needs w and b")
        elif self.head == "gbdt":
            if self.gbdt is None:
                raise ValueError("ClassifyPlan: head='gbdt' needs a GbdtModel")
        else:
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
            return kbow.bow_quantize_hist(descs, valids, self.centroids, normalize=self.normalize)
        h = kbow.quantize_hist_plain(descs, valids, self.centroids)
        return kbow.normalize_hist(h) if self.normalize else h

    def scores(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """Histograms (B, K) -> decision scores (B, n_classes)."""
        hists = hists.to(torch.float32).contiguous()
        fused = self.resolve_mode(mode) == "fused"
        if self.head == "svm":
            if fused:
                return kbow.linear_score(hists, self.w, self.b, lc=self.lc)
            return kbow.linear_score_plain(hists, self.w, self.b)
        m = self.gbdt
        if fused:
            return kgbdt.gbdt_score(hists, m.feat, m.thr, m.leaf, m.base, lc=self.lc)[0]
        return kref.gbdt_scores_ref(hists, m.feat, m.thr, m.leaf, m.base)

    def leaf_indices(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """GBDT head only: per-tree leaf indices (B, T) i32."""
        if self.head != "gbdt":
            raise ValueError("ClassifyPlan.leaf_indices: head is not 'gbdt'")
        hists = hists.to(torch.float32).contiguous()
        m = self.gbdt
        if self.resolve_mode(mode) == "fused":
            return kgbdt.gbdt_score(hists, m.feat, m.thr, m.leaf, m.base, lc=self.lc)[1]
        return kref.gbdt_leaf_ref(hists, m.feat, m.thr)

    def classify(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """Histograms -> predicted labels (B,) i32."""
        return torch.argmax(self.scores(hists, mode=mode), dim=1).to(torch.int32)

    def __call__(self, descs: torch.Tensor, valids: torch.Tensor, *, mode=None) -> dict:
        """The whole tail: descriptors -> {"hist", "scores", "label"}."""
        h = self.histograms(descs, valids, mode=mode)
        s = self.scores(h, mode=mode)
        return {"hist": h, "scores": s, "label": torch.argmax(s, dim=1).to(torch.int32)}


def build_plan(model, config: PipelineConfig | None = None, *, device=None) -> ClassifyPlan:
    """Bind a trained model to a ClassifyPlan on `device` (default: the
    model's own) with the config's classifier knobs.  Dispatches on the
    model, as JAX's does: a `BowGbdtModel` carries a ``gbdt`` `GbdtModel`, a
    `BowSvmModel` carries ``w`` and ``b``; both carry ``centroids`` and
    ``n_classes``."""
    cfg = config if config is not None else PipelineConfig()
    dev = device if device is not None else model.centroids.device

    def on_dev(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return t.to(device=dev, dtype=dtype).contiguous()

    common = dict(
        centroids=on_dev(model.centroids),
        n_classes=model.n_classes,
        mode=cfg.classify_mode,
        lc=cfg.lc,
    )
    g = getattr(model, "gbdt", None)
    if g is not None:
        gbdt = GbdtModel(
            on_dev(g.feat, torch.int32), on_dev(g.thr), on_dev(g.leaf), on_dev(g.base), g.n_classes
        )
        return ClassifyPlan(head="gbdt", gbdt=gbdt, **common)
    if getattr(model, "w", None) is None or getattr(model, "b", None) is None:
        raise ValueError(
            f"build_plan: {type(model).__name__} carries neither w and b nor a 'gbdt' GbdtModel"
        )
    return ClassifyPlan(head="svm", w=on_dev(model.w), b=on_dev(model.b), **common)
