"""PipelineConfig: the one place the CV stack's knobs live (the counterpart of
`repro.cv.config`).  `resolve_config` is JAX's deprecation shim, through
which `serve.cv_engine.CvEngine` takes its old ``max_kp=``, ``n_octaves=``
and ``preprocess=`` keywords; the port's pipeline entry points take only
``config=``."""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

from ..core.device import DEFAULT, LaunchConfig

CLASSIFY_HEADS = ("svm", "gbdt")

# keywords that forward into the config with a DeprecationWarning; max_kp,
# lc and head override silently (single-function knobs, not routing state)
DEPRECATED_KWARGS = ("mode", "ladder", "n_octaves", "preprocess")

# "keyword not passed", as distinct from an explicit None (a meaningful
# value of mode= and ladder=)
_UNSET = object()


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


def resolve_config(config: PipelineConfig | None = None, *, where: str, mode=_UNSET,
                   ladder=_UNSET, n_octaves=_UNSET, preprocess=_UNSET, max_kp=_UNSET,
                   lc=_UNSET, head=_UNSET) -> PipelineConfig:
    """Merge legacy keywords into a PipelineConfig, as JAX's shim does: the
    keywords of `DEPRECATED_KWARGS` emit one `DeprecationWarning` a call (all
    of them named in one message), then forward into the config; `max_kp`,
    `lc` (JAX's `vc`) and `head` override silently.  Explicit keywords win
    over the config's fields."""
    cfg = config if config is not None else PipelineConfig()
    if not isinstance(cfg, PipelineConfig):
        raise ValueError(f"{where}: config= expects a PipelineConfig, got {type(cfg).__name__}")
    overrides = {k: v for k, v in (("mode", mode), ("ladder", ladder), ("n_octaves", n_octaves),
                                   ("preprocess", preprocess), ("max_kp", max_kp), ("lc", lc),
                                   ("head", head))
                 if v is not _UNSET}
    deprecated = sorted(k for k in overrides if k in DEPRECATED_KWARGS)
    if deprecated:
        warnings.warn(
            f"{where}: keyword argument(s) {', '.join(deprecated)} are "
            f"deprecated — pass config=PipelineConfig(...) instead "
            f"(the legacy kwargs still forward into the config)",
            DeprecationWarning, stacklevel=3)
    return cfg.replace(**overrides) if overrides else cfg
