"""Optimizers and schedules (the counterpart of `repro.optim`)."""

from .adamw import adafactor_init, adafactor_update, adamw_init, adamw_update
from .schedule import cosine_schedule

__all__ = [
    "adafactor_init",
    "adafactor_update",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
]
