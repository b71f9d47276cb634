"""Fused stencil chain: the counterpart of `repro.kernels.stencil`.

A chain of image stages over a batched, multi-channel image runs as one
launch of the hand-written `stencil_chain` CUDA kernel: the input is
normalised to (N, H, W) planes, each block computes the whole chain for one
(plane, output tile) in shared memory, and only the output bands are
written back.  Border semantics are the JAX package's extended domain: the
input is edge-padded once by the chain's accumulated halo and every stage
is a valid-mode op (`kernels.ref.chain_ref`).

Modules: `ir` (Stage IR and the band-arity walk), `plan` (accumulated
halo), `exec_window` (the kernel's planner, wrapper and plain version),
`driver` (`fused_chain` and its mode resolution).
"""

from .driver import MODES, fused_chain
from .ir import Stage, erode_stage, gaussian_stage, grad_stage, resolve_chain, sep_filter_stage
from .plan import chain_accumulated_halo, chain_halo

__all__ = [
    "MODES",
    "Stage",
    "chain_accumulated_halo",
    "chain_halo",
    "erode_stage",
    "fused_chain",
    "gaussian_stage",
    "grad_stage",
    "resolve_chain",
    "sep_filter_stage",
]
