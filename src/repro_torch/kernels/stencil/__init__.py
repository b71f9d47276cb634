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
carrier; a Sobel pair is f32 whatever the carrier, and a gather
(warp_affine, remap) samples at absolute image coordinates.

Modules: `ir` (Stage IR, the band-arity walk and the next-base contract),
`plan` (halo, levels, row walk, carry plan, ring layout, tile width, row
segments), `exec_window` and `exec_streaming` (each kernel's planner,
wrapper and plain version), `ladder` (the modes, the degradation ladder and
the process defaults), `driver` (`fused_chain`, its mode resolution:
default, measured winner, fit rule; and `chained_launches`: a pyramid, one
launch per link).
"""

from .driver import MODES, chained_launches, fit_mode, fused_chain, resolve_mode, streaming_fits
from .ir import (
    Stage,
    affine_disp_bound,
    affine_stage,
    box_stage,
    dilate_stage,
    erode_stage,
    filter_stage,
    gaussian_stage,
    grad_stage,
    pyr_down_stage,
    pyr_up_stage,
    remap_stage,
    resize2_stage,
    resolve_chain,
    sep_filter_stage,
    sobel_stage,
    threshold_stage,
    validate_next_base,
    warp_affine_stage,
)
from .ladder import (
    DEGRADATION_LADDER,
    default_chain_mode,
    default_ladder,
    set_default_chain_mode,
    set_default_ladder,
)
from .plan import (
    PlanOverBudget,
    chain_accumulated_halo,
    chain_halo,
    chain_iface,
    chain_levels,
    chain_stream_plan,
    gather_metas,
    pyramid_plan,
    pyr_up_metas,
    stage_out_hw,
)

__all__ = [
    "DEGRADATION_LADDER",
    "MODES",
    "PlanOverBudget",
    "Stage",
    "affine_disp_bound",
    "affine_stage",
    "box_stage",
    "chain_accumulated_halo",
    "chained_launches",
    "chain_halo",
    "chain_iface",
    "chain_levels",
    "chain_stream_plan",
    "default_chain_mode",
    "default_ladder",
    "dilate_stage",
    "erode_stage",
    "filter_stage",
    "fit_mode",
    "fused_chain",
    "gather_metas",
    "gaussian_stage",
    "grad_stage",
    "pyr_down_stage",
    "pyr_up_metas",
    "pyr_up_stage",
    "pyramid_plan",
    "remap_stage",
    "resize2_stage",
    "resolve_chain",
    "resolve_mode",
    "sep_filter_stage",
    "set_default_chain_mode",
    "set_default_ladder",
    "sobel_stage",
    "stage_out_hw",
    "streaming_fits",
    "threshold_stage",
    "validate_next_base",
    "warp_affine_stage",
]
