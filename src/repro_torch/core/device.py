"""Device resolution and the kernels' launch configuration.

The counterpart of `repro.core.vector`.  On the TPU, `VectorConfig.lmul`
scales a Pallas block against the VMEM budget; on Hopper the same knob is
a thread block's output tile, its thread count, and its dynamic shared
memory, which may not exceed 227 KB (232,448 bytes) per block.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# shared memory one thread block may use on an H100 (sm_90)
SMEM_MAX_BYTES = 232_448


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device that is not present raises
    `RuntimeError`: the port never carries on on the CPU unless the caller
    asks for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


@dataclass(frozen=True)
class LaunchConfig:
    """Launch shape of the hand-written kernels.

    tile_rows / tile_cols: output tile of one `stencil_chain` block; the
        block also holds the tile's accumulated halo, so the wrapper halves
        the tile until the window fits `smem_budget`.
    threads: threads per block of `linear_score`, a power of two from 32
        to 1024 (the stencil kernels size their blocks by their plans; the
        nearest-word searches, `gbdt_score` and the seed kernels fix theirs
        in ``csrc``).
    smem_budget: shared memory a block may use.
    stream_rows: output rows one `stencil_stream` step advances by (the
        counterpart of `VectorConfig.rows()`); every ring holds this many
        rows beyond what its consumers lag.
    tile2d_cols: column-tile width of the tiled2d plan; None lets the
        planner pick the widest tile whose rings fit `smem_budget`.
    row_segments: row segments per plane of a `stencil_stream` launch;
        None takes the rule of `plan.row_segments` (about two blocks per
        SM, at least two steps a segment).
    """

    tile_rows: int = 32
    tile_cols: int = 32
    threads: int = 256
    smem_budget: int = SMEM_MAX_BYTES
    stream_rows: int = 8
    tile2d_cols: int | None = None
    row_segments: int | None = None

    def __post_init__(self):
        if not 0 < self.smem_budget <= SMEM_MAX_BYTES:
            raise ValueError(
                f"smem_budget must be in (0, {SMEM_MAX_BYTES}], got {self.smem_budget}"
            )
        if self.threads not in (32, 64, 128, 256, 512, 1024):
            raise ValueError(f"threads must be a power of two in [32, 1024], got {self.threads}")
        if not 1 <= self.stream_rows <= 64:
            raise ValueError(f"stream_rows must be in [1, 64], got {self.stream_rows}")
        for name in ("tile2d_cols", "row_segments"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be None or a positive int, got {v!r}")


DEFAULT = LaunchConfig()
