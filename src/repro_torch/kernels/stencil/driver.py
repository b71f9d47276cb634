"""Chain driver: `fused_chain`, the public entry point of the stencil engine
(the counterpart of `repro.kernels.stencil.driver`).

Modes, and the kernel each names:

  ===========  ===========================================================
  mode         what runs
  ===========  ===========================================================
  "window"     `stencil_chain`: one block per (plane, 32x32 tile), each
               recomputing the chain over its own overlapping window
  "streaming"  `stencil_stream` with one full-width column tile; a chain
               whose rings do not fit shared memory raises `ValueError`
  "tiled2d"    `stencil_stream` with column tiles (`tile_w=`, else
               `LaunchConfig.tile2d_cols`, else the planner's width)
  "ref"        the plain PyTorch version, on any device
  None         the process default (`ladder.set_default_chain_mode`), else
               the measured winner `core.autotune.measure_chain` cached for
               this chain, image shape, dtype, launch configuration and
               device, else the fit rule: "window" for planes no larger
               than the chain's accumulated halo (the port's stand-in for
               JAX's no-launch fallback) and for chains without row halo;
               else "streaming", or "tiled2d" when one full-width tile's
               rings do not fit
  ===========  ===========================================================

A CPU tensor runs the plain version of the kernel its mode names; a CUDA
tensor launches that kernel or raises.  A mode the cache names launches
exactly the kernel that mode names.  There is no other fallback: only a
caller's `ladder=` (or `ladder.set_default_ladder`) moves a failed call to
the next rung, every such move recorded in `core.faultinject`'s
degradation log, and on a CUDA tensor a ladder that moves to "ref", or a
"ref" that `mode=None` finds in the process default or the plan table,
raises `ValueError`.  `chained_launches` runs a pyramid: one `fused_chain`
launch per link, each link's next-base band the next one's input.
"""

from __future__ import annotations

import torch

from ...core import autotune, faultinject
from ...core.device import DEFAULT, LaunchConfig
from .. import ref
from . import exec_streaming, exec_window, ir, plan
from .ladder import MODES, default_chain_mode, resolve_rungs, run_ladder


def _halo(stages) -> tuple[int, int]:
    return exec_window.by_stages(stages, ("halo",), lambda: plan.chain_accumulated_halo(stages))


def streaming_fits(stages, shape, dtype, lc: LaunchConfig = DEFAULT) -> bool:
    """Whether mode "streaming" takes (N, H, W) planes of `dtype`: one
    full-width tile's rings fit `lc.smem_budget`, on planes larger than
    the chain's accumulated halo."""
    _, H, W = shape
    ph, pw = _halo(stages)
    if H <= ph or W <= pw:
        return False
    prog, _ = exec_streaming.program(stages, lc.stream_rows, dtype, torch.device("cpu"))
    return prog.layout.smem_bytes(W) + prog.table_smem <= lc.smem_budget


def fit_mode(stages, shape, dtype, lc: LaunchConfig = DEFAULT) -> str:
    """The fit rule for (N, H, W) planes of `dtype`."""
    _, H, W = shape
    ph, pw = _halo(stages)
    if H <= ph or W <= pw or ph == 0:
        return "window"
    return "streaming" if streaming_fits(stages, shape, dtype, lc) else "tiled2d"


def resolve_mode(stages, shape, dtype, lc: LaunchConfig = DEFAULT, *, img_shape=None,
                 device=None) -> str:
    """The mode `mode=None` takes for (N, H, W) planes of `dtype`, in JAX's
    order: the process default, then the measured winner cached under the
    image's shape (`img_shape`, else `shape`) on `device` (None: the CPU),
    then `fit_mode`.  A "ref" from the default or the cache raises on a
    CUDA device: the plain version runs on the card only when the caller
    names it."""
    mode = default_chain_mode()
    if mode is None:
        mode = autotune.cached_chain_mode(stages, img_shape or shape, dtype, lc, device)
    if mode is None:
        return fit_mode(stages, shape, dtype, lc)
    if mode == "ref" and torch.device(device or "cpu").type == "cuda":
        raise ValueError(
            "fused_chain: the process default or the plan table names 'ref' for a CUDA tensor; "
            "the plain version runs on the card only as mode='ref'"
        )
    return mode


def fused_chain(
    img: torch.Tensor,
    stages,
    *,
    mode: str | None = None,
    lc: LaunchConfig = DEFAULT,
    tile_w: int | None = None,
    ladder=None,
):
    """Run a stage chain over an image in one launch.

    img: (H, W), (H, W, C) or (B, H, W, C), u8 or f32, on the device it
    runs on.  tile_w: the column-tile width of mode "tiled2d" only.
    ladder: rungs (`ladder.MODES`) to move to, in order, when the resolved
    mode fails with anything but a `ValueError`, each move recorded as a
    degradation event; None takes the process default
    (`ladder.set_default_ladder`), which is none: a failure raises.  On a
    CUDA tensor a ladder may not move to "ref" (`ValueError`).
    Returns one array when the chain ends with one live band, else a tuple
    (one per band, e.g. a Gaussian ladder's scales or a Sobel pair).  A
    band a pyrDown made is (ceil(H/2), ceil(W/2)) where the input is (H,
    W), one a resize2 made (H//2, W//2), one a pyrUp made (2H, 2W), in the
    order of the chain's resolution changes; a strided or upsampling map
    stage may sit anywhere in the chain (`plan.chain_levels`).  A band has
    the input's dtype, but a Sobel pair is f32.  A remap stage's map planes
    go to the kernel as they lie: on the image's device."""
    stages = tuple(stages)
    if not stages:
        return img
    if img.ndim not in (2, 3, 4):
        raise ValueError(f"fused_chain: unsupported rank {img.ndim}")
    if mode is not None and mode not in MODES:
        raise ValueError(f"fused_chain: unknown mode {mode!r} (expected one of {MODES} or None)")
    if tile_w is not None and mode != "tiled2d":
        raise ValueError(f"fused_chain: tile_w= only applies to mode='tiled2d', not {mode!r}")
    planes = ref.to_planes(img)
    if mode is None:
        mode = resolve_mode(stages, planes.shape, planes.dtype, lc, img_shape=tuple(img.shape),
                            device=img.device)

    def run(rung: str):
        if rung == "ref":
            return exec_window.stencil_chain_plain(planes, stages)
        faultinject.maybe_raise("lowering_error", site=f"fused_chain:{rung}")
        if rung == "window":
            return exec_window.stencil_chain(planes, stages, lc)
        return exec_streaming.stencil_stream(
            planes, stages, lc, tiled=rung == "tiled2d", tile_w=tile_w if rung == "tiled2d" else None
        )

    rungs = resolve_rungs(mode, ladder, card=img.device.type == "cuda")
    outs = run_ladder(rungs, run, stage="fused_chain",
                      detail=f"{tuple(img.shape)}|{str(img.dtype).removeprefix('torch.')}")
    outs = tuple(ref.from_planes(o, img.shape) for o in outs)
    return outs[0] if len(outs) == 1 else outs


def chained_launches(
    img: torch.Tensor, chains, *, mode: str | None = None, lc: LaunchConfig = DEFAULT, ladder=None
) -> tuple[list, list]:
    """A pyramid of chains, one `fused_chain` launch per link over the whole
    batch: link k+1 takes link k's last output band (its next base, the
    strided terminal tap `ir.validate_next_base` requires of every link but
    the last) as its input.  `mode=None` resolves each link's mode for its
    own, shrinking planes; a link whose planes are no larger than its halo
    launches `stencil_chain` like any other (the port has no plain-version
    tail on the card), so the launches are the links; `ladder=` goes to
    each link's `fused_chain`.

    Returns ``(outs, scales)``: ``outs[k]`` is link k's output bands
    without the carry band, ``scales[k]`` the (row, col) factor that maps
    link k's pixel (y, x) to base-image (y * sy, x * sx), exact because
    strided taps decimate on image-even coordinates."""
    chains = tuple(tuple(c) for c in chains)
    if not chains:
        raise ValueError("chained_launches: need at least one chain")
    outs_all, scales = [], []
    base = img
    sy = sx = 1
    for k, stages in enumerate(chains):
        last = k == len(chains) - 1
        if not last:
            ir.validate_next_base(stages)
        outs = fused_chain(base, stages, mode=mode, lc=lc, ladder=ladder)
        outs = outs if isinstance(outs, tuple) else (outs,)
        scales.append((sy, sx))
        if last:
            outs_all.append(outs)
        else:
            outs_all.append(outs[:-1])
            base = outs[-1]
            st = tuple(stages[-1].stride)
            sy, sx = sy * st[0], sx * st[1]
    return outs_all, scales
