"""Serving front end (the counterpart of `repro.serve`): `CvEngine` and its
`Request` / `Response` envelope, the submodules, and the LM serving steps
(prefill, decode, greedy `generate`) in `cv_engine`."""

from . import cv_engine, health, shard_dispatch
from .cv_engine import CvEngine, Request, Response

__all__ = [
    "cv_engine", "health", "shard_dispatch",
    "CvEngine", "Request", "Response",
]
