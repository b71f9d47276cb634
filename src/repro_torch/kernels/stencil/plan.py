"""Chain geometry: the counterpart of `repro.kernels.stencil.plan`, reduced
to what the window kernel needs (the accumulated halo)."""

from __future__ import annotations

from .ir import resolve_chain


def chain_accumulated_halo(stages) -> tuple[int, int]:
    """(row, col) halo of the whole chain in input-resolution units: each
    stage's halo scaled by the net resolution factor before it (ceil of
    halo * downsample / upsample product)."""
    ph = pw = 0
    ny = nx = 1
    dy = dx = 1
    for _op, mode, halo, stride, up, _, _, _ in resolve_chain(stages):
        ph += -(-halo[0] * ny // dy)
        pw += -(-halo[1] * nx // dx)
        if mode == "map":
            ny *= stride[0]
            nx *= stride[1]
            dy *= up[0]
            dx *= up[1]
    return ph, pw


def chain_halo(stages) -> tuple[int, int]:
    """Accumulated (row, col) halo of the whole chain (alias kept for the
    JAX package's name)."""
    return chain_accumulated_halo(stages)
