"""Synthetic data (the counterpart of `repro.data`)."""

from .synthetic import ImageStream, TokenStream

__all__ = ["ImageStream", "TokenStream"]
