"""PipelineConfig: the one place the CV stack's knobs live (the counterpart of
`repro.cv.config`; its deprecated per-function kwargs are not carried
over)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..core.device import DEFAULT, LaunchConfig

CLASSIFY_HEADS = ("svm", "gbdt")


@dataclass(frozen=True)
class PipelineConfig:
    """Frozen bundle of every CV-pipeline knob.

    max_kp: keypoints (= descriptors) per image.
    preprocess: run the fused blur -> erode -> grad denoise chain first.
    n_octaves: >1 routes detection through the multi-octave pyramid
        (`features.sift_pyramid`, one launch per octave).
    mode / ladder: fused-chain execution plan (`kernels.stencil.MODES`) and
        degradation ladder, threaded to every fused launch; on a CUDA
        tensor the ladder may not move to "ref".
    head: classifier head that `cv.pipeline.train` fits: "svm" (one-vs-rest
        linear) or "gbdt" (oblivious-tree ensemble).
    classify_mode / classify_ladder: `ClassifyPlan` mode, "fused" or "ref"
        (None = the measured winner, else "fused"), and its ladder over
        ("fused", "ref").  The port's `classify_ladder` defaults to None,
        not JAX's ("fused", "ref"): a kernel that fails on the card raises
        instead of running the plain version, and on the card a ladder that
        moves to "ref" raises `ValueError`.
    lc: the kernels' launch configuration (`core.device.LaunchConfig`).
    """

    max_kp: int = 32
    preprocess: bool = False
    n_octaves: int = 1
    mode: str | None = None
    ladder: tuple[str, ...] | None = None
    head: str = "svm"
    classify_mode: str | None = None
    classify_ladder: tuple[str, ...] | None = None
    lc: LaunchConfig = DEFAULT

    def __post_init__(self):
        for f in ("ladder", "classify_ladder"):  # lists to tuples: the config stays hashable
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if self.head not in CLASSIFY_HEADS:
            raise ValueError(
                f"PipelineConfig: unknown head {self.head!r} (expected one of {CLASSIFY_HEADS})"
            )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
