"""PipelineConfig: the one place the CV stack's knobs live (the counterpart of
`repro.cv.config`).

The JAX package's ladder fields (`ladder`, `classify_ladder`) and its
deprecated per-function kwargs are not carried over: the port has no
degradation ladder yet, so a kernel that fails on the card raises.
"""

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
    mode: fused-chain execution plan (`kernels.stencil.MODES`).
    head: classifier head that `cv.pipeline.train` fits: "svm" (one-vs-rest
        linear) or "gbdt" (oblivious-tree ensemble).
    classify_mode: `ClassifyPlan` mode, "fused" or "ref"; None = "fused".
    lc: the kernels' launch configuration (`core.device.LaunchConfig`).
    """

    max_kp: int = 32
    preprocess: bool = False
    n_octaves: int = 1
    mode: str | None = None
    head: str = "svm"
    classify_mode: str | None = None
    lc: LaunchConfig = DEFAULT

    def __post_init__(self):
        if self.head not in CLASSIFY_HEADS:
            raise ValueError(
                f"PipelineConfig: unknown head {self.head!r} (expected one of {CLASSIFY_HEADS})"
            )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
