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

Mode resolution: explicit argument -> plan.mode -> the measured winner
(`core.autotune.cached_classify_mode`) -> "fused".  A plan bound to a CUDA
device resolves ``mode=None`` to "fused" with no lookup: that is the only
candidate `measure_classify` times on the card.  Ladder semantics follow
`kernels.stencil.ladder.run_ladder`: a `ValueError` always raises, any
other failure of a rung moves to the next with a recorded event, and the
last rung's failure raises.  Two departures from the JAX package: the
port's `ladder` defaults to None, not ("fused", "ref"), so a kernel that
fails on the card raises instead of running the plain version; and on a
CUDA tensor a ladder that moves to "ref" raises `ValueError`, so the
plain version runs on the card only as a caller's explicit mode "ref".
A caller who passes a ladder on the CPU gets JAX's behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import faultinject
from ..core.device import DEFAULT, LaunchConfig
from ..kernels import bow as kbow
from ..kernels import gbdt as kgbdt
from ..kernels import ref as kref
from ..kernels.stencil.ladder import ordered_rungs, run_ladder
from .config import PipelineConfig
from .gbdt import GbdtModel

# the tail's modes, fastest first; ref is plain PyTorch, no launch
CLASSIFY_MODES = ("fused", "ref")
CLASSIFY_LADDER = ("fused", "ref")


def resolve_classify_rungs(mode: str, ladder, *, card: bool = False) -> tuple[str, ...]:
    """The rungs one classify call runs (the tail's `ladder.resolve_rungs`):
    the resolved mode first, then the ladder's rungs after it, each once;
    no ladder means the one mode, whose failure raises.  `card`: the
    call's tensor is on a CUDA device, where a move to "ref" raises."""
    if mode not in CLASSIFY_MODES:
        raise ValueError(f"ClassifyPlan: unknown mode {mode!r} (expected one of {CLASSIFY_MODES})")
    if not ladder:
        return (mode,)
    return ordered_rungs(mode, ladder, CLASSIFY_MODES, "ClassifyPlan", card=card)


@dataclass(frozen=True, eq=False)
class ClassifyPlan:
    """Bound classifier tail: codebook + head parameters + execution mode.

    head: "svm" (w (C, K), b (C,)) or "gbdt" (`cv.gbdt.GbdtModel`).
    mode: None = the measured winner, else "fused" ("fused" on a CUDA
        device); "fused" | "ref" pins the mode for every call.
    ladder: degradation ladder over CLASSIFY_MODES; None (the default) or
        () means none: a failing rung raises.  On a CUDA device a ladder
        may not move to "ref".
    """

    centroids: torch.Tensor
    n_classes: int
    w: torch.Tensor | None = None
    b: torch.Tensor | None = None
    head: str = "svm"
    gbdt: GbdtModel | None = None
    mode: str | None = None
    ladder: tuple[str, ...] | None = None
    normalize: bool = True
    lc: LaunchConfig = DEFAULT

    def __post_init__(self):
        if self.ladder is not None and not isinstance(self.ladder, tuple):
            object.__setattr__(self, "ladder", tuple(self.ladder))
        if self.head == "svm":
            if self.w is None or self.b is None:
                raise ValueError("ClassifyPlan: head='svm' needs w and b")
        elif self.head == "gbdt":
            if self.gbdt is None:
                raise ValueError("ClassifyPlan: head='gbdt' needs a GbdtModel")
        else:
            raise ValueError(f"ClassifyPlan: unknown head {self.head!r}")
        if self.mode is not None:
            resolve_classify_rungs(self.mode, self.ladder)

    @property
    def signature(self) -> str:
        """The tail's identity in the plan table (head + problem shape), JAX's."""
        K, D = self.centroids.shape
        return f"classify:{self.head}:k{K}d{D}c{self.n_classes}"

    @property
    def on_card(self) -> bool:
        return self.centroids.device.type == "cuda"

    def resolve_mode(self, shape, dtype, mode: str | None = None) -> str:
        """Explicit arg -> plan.mode -> measured cache -> "fused"; on a CUDA
        device the cache is not asked, since "fused" is its only entry."""
        if mode is not None:
            return mode
        if self.mode is not None:
            return self.mode
        if self.on_card:
            return "fused"
        from ..core import autotune

        cached = autotune.cached_classify_mode(self, shape, dtype)
        return cached if cached is not None else "fused"

    def _run(self, rung_fns: dict, mode: str | None, shape, dtype, stage: str):
        rungs = resolve_classify_rungs(self.resolve_mode(shape, dtype, mode), self.ladder,
                                       card=self.on_card)
        dname = str(dtype).removeprefix("torch.")
        detail = f"{self.signature}|{'x'.join(map(str, shape))}|{dname}"
        return run_ladder(rungs, lambda r: rung_fns[r](), stage=stage, detail=detail)

    def histograms(self, descs: torch.Tensor, valids: torch.Tensor, *, mode=None):
        """descs (B, N, D) + valids (B, N) -> word histograms (B, K)."""
        shape, dtype = tuple(descs.shape), descs.dtype
        descs = descs.to(torch.float32).contiguous()

        def fused():
            faultinject.maybe_raise("lowering_error", site="classify:fused")
            return kbow.bow_quantize_hist(descs, valids, self.centroids, normalize=self.normalize)

        def ref():
            h = kbow.quantize_hist_plain(descs, valids, self.centroids)
            return kbow.normalize_hist(h) if self.normalize else h

        return self._run({"fused": fused, "ref": ref}, mode, shape, dtype, "classify_hist")

    def scores(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """Histograms (B, K) -> decision scores (B, n_classes)."""
        shape, dtype = tuple(hists.shape), hists.dtype
        hists = hists.to(torch.float32).contiguous()
        m = self.gbdt

        def fused():
            faultinject.maybe_raise("lowering_error", site="classify:fused")
            if self.head == "svm":
                return kbow.linear_score(hists, self.w, self.b, lc=self.lc)
            return kgbdt.gbdt_score(hists, m.feat, m.thr, m.leaf, m.base)[0]

        def ref():
            if self.head == "svm":
                return kbow.linear_score_plain(hists, self.w, self.b)
            return kref.gbdt_scores_ref(hists, m.feat, m.thr, m.leaf, m.base)

        return self._run({"fused": fused, "ref": ref}, mode, shape, dtype, "classify_score")

    def leaf_indices(self, hists: torch.Tensor, *, mode=None) -> torch.Tensor:
        """GBDT head only: per-tree leaf indices (B, T) i32."""
        if self.head != "gbdt":
            raise ValueError("ClassifyPlan.leaf_indices: head is not 'gbdt'")
        shape, dtype = tuple(hists.shape), hists.dtype
        hists = hists.to(torch.float32).contiguous()
        m = self.gbdt

        def fused():
            faultinject.maybe_raise("lowering_error", site="classify:fused")
            return kgbdt.gbdt_score(hists, m.feat, m.thr, m.leaf, m.base)[1]

        def ref():
            return kref.gbdt_leaf_ref(hists, m.feat, m.thr)

        return self._run({"fused": fused, "ref": ref}, mode, shape, dtype, "classify_score")

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
        ladder=cfg.classify_ladder,
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
