"""Fused stencil chain: the counterpart of `repro.kernels.stencil`.

A chain of image stages over a batched, multi-channel image runs as one
launch of a hand-written CUDA kernel: the input is normalised to (N, H, W)
planes and only the output bands are written back.  Two kernels:
`stencil_chain` (mode "window": one block per (plane, output tile), each
recomputing the chain over its own overlapping window) and
`stencil_stream` (modes "streaming" and "tiled2d": one block per (plane,
column tile, row segment), carrying rows from step to step in
shared-memory rings).  Border semantics are the JAX package's extended
domain: the input is edge-padded once by the chain's accumulated halo and
every stage is a valid-mode op (`kernels.ref.chain_ref`), on a u8 or f32
carrier.

Modules: `ir` (Stage IR and the band-arity walk), `plan` (halo, row walk,
carry plan, ring layout, tile width, row segments), `exec_window` and
`exec_streaming` (each kernel's planner, wrapper and plain version),
`driver` (`fused_chain` and its mode resolution).
"""

from .driver import MODES, fused_chain, resolve_mode
from .ir import (
    Stage,
    affine_stage,
    box_stage,
    dilate_stage,
    erode_stage,
    filter_stage,
    gaussian_stage,
    grad_stage,
    pyr_down_stage,
    resolve_chain,
    sep_filter_stage,
    threshold_stage,
)
from .plan import (
    chain_accumulated_halo,
    chain_halo,
    chain_iface,
    chain_stream_plan,
    stage_out_hw,
)

__all__ = [
    "MODES",
    "Stage",
    "affine_stage",
    "box_stage",
    "chain_accumulated_halo",
    "chain_halo",
    "chain_iface",
    "chain_stream_plan",
    "dilate_stage",
    "erode_stage",
    "filter_stage",
    "fused_chain",
    "gaussian_stage",
    "grad_stage",
    "pyr_down_stage",
    "resolve_chain",
    "resolve_mode",
    "sep_filter_stage",
    "stage_out_hw",
    "threshold_stage",
]
