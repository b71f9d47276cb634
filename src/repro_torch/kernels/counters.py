"""Launch counters of the hand-written kernels and call counters of their
plain PyTorch versions.

A kernel's wrapper adds one to ``LAUNCHES[name]`` where it launches the
kernel and nowhere else; a plain version adds one to ``PLAIN_CALLS[name]``
each time it runs.  A run on the card resets both, drives the main path,
and reads them back to show that every kernel ran and no plain version did.
"""

from __future__ import annotations

KERNELS = (
    "stencil_chain",
    "stencil_stream",
    "bow_quantize_hist",
    "linear_score",
    "bow_assign",
    "gbdt_score",
    "flash_attention",
    "seed_gaussian_blur",
    "seed_erode",
    "seed_threshold",
)

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


def snapshot() -> dict:
    return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS)}
