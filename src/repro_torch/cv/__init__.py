"""The OpenCV-algorithm stack (the counterpart of `repro.cv`): the
submodules, `PipelineConfig` (the one knob bundle every entry point
accepts) and `ClassifyPlan` (the classifier tail's plan), with the JAX
package's public names."""

from . import bow, classify, config, features, gbdt, imgproc, pipeline, svm
from .classify import CLASSIFY_MODES, ClassifyPlan, build_plan
from .config import PipelineConfig, resolve_config

__all__ = [
    "bow", "classify", "config", "features", "gbdt", "imgproc",
    "pipeline", "svm",
    "CLASSIFY_MODES", "ClassifyPlan", "build_plan",
    "PipelineConfig", "resolve_config",
]
