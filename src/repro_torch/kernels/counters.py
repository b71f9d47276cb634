"""Launch counters of the hand-written kernels and call counters of their
plain PyTorch versions.

A kernel's wrapper adds one to ``LAUNCHES[name]`` where it launches the
kernel and nowhere else; a plain version adds one to ``PLAIN_CALLS[name]``
each time it runs.  A run on the card resets both, drives the main path,
and reads them back to show that every kernel ran and no plain version did.

``BACKWARD_CALLS`` counts the plain PyTorch gradients of the kernels that
training differentiates (`attention.flash_attention`'s backward).  Such a
gradient is neither a kernel nor a kernel's plain version, so it has a
counter of its own, outside `KERNELS`.

``RECORDERS`` holds the active cost recorders (`roofline.cost.CostMode`).
A wrapper that reports its work calls `record` for every call it answers
with a launch or, on the meta device, with the output's shape alone
(`attention.flash_attention`), behind ``if RECORDERS:``: with no recorder
active that costs one empty-list check and the work is not computed.
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
BACKWARD_CALLS: dict[str, int] = {"flash_attention": 0}


def reset() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0
    for name in BACKWARD_CALLS:
        BACKWARD_CALLS[name] = 0


def snapshot() -> dict:
    return {
        "launches": dict(LAUNCHES),
        "plain_calls": dict(PLAIN_CALLS),
        "backward_calls": dict(BACKWARD_CALLS),
    }


RECORDERS: list = []


def record(name: str, flops: float, nbytes: float) -> None:
    """Report one call of kernel `name` to the active cost recorders: the
    function's operations and the bytes of its inputs and output, each once."""
    for r in RECORDERS:
        r(name, flops, nbytes)
