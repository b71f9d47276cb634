"""Streaming executor: the `stencil_stream` CUDA kernel's wrapper, its step
and ring planner, and its plain PyTorch version.

Replaces `repro.kernels.stencil.exec_streaming.streaming_kernel` (TPU,
Pallas) in its "streaming" and "tiled2d" plans.  Bound on an H100: bytes
for the single ops and short chains on u8 images, operations for a large
filter2d; the kernel computes each row of every stage once per column tile
and carries the rows its successors still need in shared-memory rings, so
no stage's halo is recomputed from step to step.  See
``csrc/stencil_stream.cu`` for the design.

`compile_stream` turns a chain and `LaunchConfig.stream_rows` into the
kernel's program: `plan.stream_layout`'s streams with their ring depths,
dtypes, levels, row rates and leads (the kernel lays the rings out by
their levels' widths), and one step per stage application (a Sobel writes
two streams, the pair reduction reads two; the bands a Sobel passes by
wait in their own rings, as the bands of a tap stage do), each marked
whether it runs a register strip.  `stream_geometry` picks the column
tile, the row segments, the threads of a launch and whether stream 0 is
loaded a step ahead, so that two blocks fit on an SM.  Each stream lives
at its stage's level (`plan.chain_levels`) and advances its own rows a
step: twice the rows above a stride before the last stage, half below a
pyrUp; its ring's columns are its level's frame.  A strided last stage
(pyrDown, resize2) is planned at its input's resolution; its step computes
the image-even rows and columns of each step's rows and stores them
straight to the decimated output, so step rows, segment starts and column
tiles are all multiples of the stride product.  A gather's ring holds its
source rows up to the displacement halo on each side; it samples at the
absolute image row of the ring and the image column ``co0 + t*cstep`` of
tile t's column 0.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import _build, counters, ref
from . import plan
from .exec_window import (
    Bands,
    band_outputs,
    by_stages,
    check_planes,
    check_ported,
    chain_key,
    stage_params,
)

_STEP_FIELDS = (
    "op", "src", "src2", "dst", "dst2", "kh", "kw", "wx", "wy", "rw", "cw", "lead", "mult", "ls",
    "lo", "store", "store2", "down", "pk", "strip",
)
_STREAM_FIELDS = ("depth", "level", "mult", "lead", "store", "u8")
# the most threads of a block (csrc/stencil_stream.cu kMaxThreads, its
# __launch_bounds__ with two blocks an SM); fewer for narrow frames
STREAM_THREADS = 256


# ints of the program's header: steps, streams, levels, rows a step, priming
# steps, the last step that reads stream 0, weights, padding
HEADER_INTS = 8
# stencil_stream_launch(in, bands*, prog, prog_bytes, n, h, w, tile_w, n_seg, seg_rows,
#                       smem_bytes, threads, u8, ahead, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@dataclass(frozen=True)
class StreamProgram:
    """A chain compiled for `stencil_stream`: steps and streams as field
    dicts, the flat weights, the ring layout (`layout.smem_bytes` gives a
    block's shared memory), each output band's ``(dtype, resolution ops)``
    (`plan.band_meta`) and the chain's stride product."""

    steps: tuple
    streams: tuple
    weights: tuple
    layout: plan.StreamLayout
    bands: tuple
    down: tuple = (1, 1)
    # (shape, LaunchConfig, tiled, tile_w, sms) -> StreamGeometry: planned once
    _memo: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def halo(self) -> tuple:
        return self.layout.halo

    @property
    def n_bands(self) -> int:
        return len(self.layout.outs)

    @property
    def smem_rows(self) -> int:
        return self.layout.smem_rows

    @property
    def table_bytes(self) -> int:
        """Bytes of the packed program: the header, the steps, the streams,
        each level's column pad, the weights."""
        ints = (HEADER_INTS + len(_STEP_FIELDS) * len(self.steps)
                + len(_STREAM_FIELDS) * len(self.streams) + len(self.layout.col_pads))
        return 4 * (ints + len(self.weights))

    @property
    def table_smem(self) -> int:
        """The shared memory a block keeps before its rings: the program,
        then each ring's first byte and row stride (and the scratch's first
        byte), rounded up to the 16 bytes the rings are aligned to
        (csrc/stencil_stream.cu `table_smem`), sized per chain."""
        return -(-(self.table_bytes + 4 * (2 * len(self.streams) + 1)) // 16) * 16

    def packed(self) -> bytes:
        lay = self.layout
        ints = [len(self.steps), len(self.streams), len(lay.col_pads), lay.rows, lay.prime_steps,
                lay.rd0, len(self.weights), 0]
        for st in self.steps:
            ints += [st[f] for f in _STEP_FIELDS]
        for st in self.streams:
            ints += [st[f] for f in _STREAM_FIELDS]
        ints += list(lay.col_pads)
        return (np.asarray(ints, dtype=np.int32).tobytes()
                + np.asarray(self.weights, dtype=np.float32).tobytes())


def compile_stream(stages, rows: int, carrier: torch.dtype = torch.float32) -> StreamProgram:
    """Plan the kernel's streams and steps for a chain of the ported
    stages, `rows` output rows per step."""
    resolved = check_ported(stages, "stencil_stream")
    down = plan.stride_product(stages)
    plan.check_strides(down, rows, 0)
    layout = plan.stream_layout(stages, rows, carrier)
    lv = layout.lv
    weights: list = []
    maps: list = []
    params = [
        stage_params(s, r[1], r[2], weights, maps) for s, r in zip(stages, resolved)
    ]
    band_of = {s: b for b, s in enumerate(layout.outs)}
    streams = []
    for s, depth in enumerate(layout.depths):
        buffered_out = s in band_of and depth > 0
        streams.append({
            "depth": depth, "level": layout.levels[s], "mult": layout.mults[s],
            "lead": layout.leads[s], "store": band_of[s] if buffered_out else -1,
            "u8": int(layout.esizes[s] == 1),
        })
    walk = plan.band_walk(stages, carrier)
    last = len(resolved) - 1
    steps = []
    for k, srcs, dsts in layout.apps:
        direct = [layout.depths[d] == 0 for d in dsts]
        st = dict.fromkeys(_STEP_FIELDS, 0)
        st.update(params[k])
        st.update(
            src=srcs[0],
            src2=srcs[-1],
            dst=-1 if direct[0] else dsts[0],
            dst2=-1 if direct[-1] else dsts[-1],
            # the columns around the tile the source holds and the output covers
            rw=lv.need[k][1],
            cw=lv.need_out(k)[1],
            lead=layout.leads[dsts[0]],
            mult=layout.mults[dsts[0]],
            ls=lv.lv_in[k],
            lo=lv.lv_out[k],
            down=params[k]["down"] if k == last else 1,
            store=band_of[dsts[0]] if direct[0] else -1,
            store2=band_of[dsts[-1]] if len(dsts) > 1 and direct[-1] else -1,
            pk=int(walk.meta[dsts[0]][0] == torch.uint8),
            strip=int(layout.strips[k]),
        )
        steps.append(st)
    bands = tuple(walk.meta[i] for i in walk.outs)
    return StreamProgram(tuple(steps), tuple(streams), tuple(weights), layout, bands, down)


@dataclass(frozen=True)
class StreamGeometry:
    """One launch's column tile (`tile_w` columns, `n_tiles` of them), row
    segments (`n_seg` per plane, `seg_rows` rows each), the dynamic shared
    memory one block takes, its threads, whether stream 0 is loaded a step
    ahead, and how many blocks an SM holds at once (`plan.blocks_per_sm`,
    the program's table included)."""

    tile_w: int
    n_tiles: int
    n_seg: int
    seg_rows: int
    smem_bytes: int
    threads: int
    ahead: bool = False
    per_sm: int = 1


def stream_geometry(
    prog: StreamProgram,
    shape: tuple,
    lc: LaunchConfig,
    *,
    tiled: bool,
    tile_w: int | None = None,
    sms: int = 132,
) -> StreamGeometry:
    """Column tile and row segments of a launch over (N, H, W) planes.

    Untiled ("streaming"), the tile is the full width, and a chain whose
    rings do not fit `lc.smem_budget` raises `ValueError` naming the bytes.
    Tiled, the width is `tile_w`, else `lc.tile2d_cols`, else
    `plan.pick_stream_tile`'s (two blocks an SM unless that costs a wide
    halo too much column work); a tile is at the input's resolution and
    its frame halves through each stride and
    doubles through each pyrUp (one full-width tile is rounded up to the
    stride product, so that each level's tile is whole).  Stream 0 is
    loaded a step ahead when its deeper ring still leaves room for two
    blocks an SM.  Threads: `STREAM_THREADS`, halved while at least four
    times the 4-column groups of the widest frame (narrow tiles and
    planes).  Segments (of the rows at the chain's last level):
    `lc.row_segments`, else `plan.row_segments` for `sms` multiprocessors
    and the blocks one SM holds (at least two waves' worth where it holds
    one)."""
    key = (tuple(shape), lc, tiled, tile_w, sms)
    hit = prog._memo.get(key)
    if hit is None:
        hit = prog._memo[key] = _stream_geometry(prog, tuple(shape), lc, tiled, tile_w, sms)
    return hit


def _stream_geometry(prog, shape, lc, tiled, tile_w, sms) -> StreamGeometry:
    N, H, W = shape
    layout = prog.layout
    two = min(lc.smem_budget, plan.TWO_BLOCK_SMEM)
    if not tiled:
        tw = W
    elif tile_w is not None or lc.tile2d_cols is not None:
        tw = min(tile_w if tile_w is not None else lc.tile2d_cols, W)
        if tw < 1:
            raise ValueError(f"stencil_stream: tile_w must be positive, got {tw}")
        plan.check_strides(prog.down, layout.rows, W, tw)
    else:
        tw = plan.pick_stream_tile(layout, W, lc.smem_budget, prog.table_smem, prog.down[1]) or W
    if tw >= W:  # one tile: as wide as the plane, rounded up to the stride product
        tw = -(-W // prog.down[1]) * prog.down[1]
    smem = layout.smem_bytes(tw)
    if smem + prog.table_smem > lc.smem_budget:
        what = "full-width" if not tiled else f"{tw}-column"
        raise plan.PlanOverBudget(
            f"stencil_stream: the {what} rings of this chain need {smem} bytes of shared memory "
            f"(+{prog.table_smem} for the step table), over the budget of {lc.smem_budget}"
        )
    ahead = layout.smem_bytes(tw, True) + prog.table_smem <= two
    if ahead:
        smem = layout.smem_bytes(tw, True)
    n_tiles = -(-W // tw)
    frame = max(layout.width(lv, tw) for lv in range(layout.lv.n_levels))
    threads = STREAM_THREADS
    while threads > 32 and threads >= 4 * -(-frame // 4):
        threads //= 2
    per_sm = plan.blocks_per_sm(smem + prog.table_smem, threads)
    h_last = layout.lv.size(layout.lv.n_levels - 1, H, W)[0]
    if lc.row_segments is not None:
        n_seg, seg_rows = plan.fix_segments(lc.row_segments, h_last, layout.rows)
    else:
        n_seg, seg_rows = plan.row_segments(N, n_tiles, h_last, layout.rows, sms,
                                            min(max(per_sm, 2), 4), layout.prime_steps)
    return StreamGeometry(tw, n_tiles, n_seg, seg_rows, smem, threads, ahead, per_sm)


# (chain, rows, carrier, device) -> (StreamProgram, its packed table on the device)
_PROGRAMS: dict = {}


def program(stages, rows: int, carrier: torch.dtype, device: torch.device) -> tuple:
    """The chain's compiled program and, off the CPU, its table copied to
    `device` once per chain (memoised on the stage objects too:
    `exec_window.by_stages`)."""

    def build():
        key = (chain_key(stages), rows, carrier, str(device))
        hit = _PROGRAMS.get(key)
        if hit is None:
            prog = compile_stream(stages, rows, carrier)
            table = None
            if device.type != "cpu":
                table = torch.frombuffer(bytearray(prog.packed()), dtype=torch.uint8).to(device)
            hit = _PROGRAMS[key] = (prog, table)
        return hit

    return by_stages(stages, ("stream", rows, carrier, str(device)), build)


@functools.cache
def _launcher():
    lib = _build.library("stencil_stream")
    sizes = (ctypes.c_int * 3)()
    lib.stencil_stream_layout(sizes)
    want = [4 * HEADER_INTS, 4 * len(_STEP_FIELDS), 4 * len(_STREAM_FIELDS)]
    if list(sizes) != want:
        raise RuntimeError(f"stencil_stream: program layout {list(sizes)} in C, {want} in Python")
    if lib.stencil_bands_bytes() != ctypes.sizeof(Bands):
        raise RuntimeError("stencil_stream: Bands layout differs between C and Python")
    static = [lib.stencil_stream_static_bytes(u8) for u8 in (0, 1)]
    if static != [0, 0]:
        raise RuntimeError(f"stencil_stream: {static} bytes of static shared memory, the "
                           "planner counts none")
    fn = lib.stencil_stream_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stencil_stream_plain(planes: torch.Tensor, stages) -> tuple:
    """Plain PyTorch version of the kernel: `ref.chain_ref_planes`."""
    counters.PLAIN_CALLS["stencil_stream"] += 1
    return ref.chain_ref_planes(planes, tuple(stages))


def stencil_stream(
    planes: torch.Tensor,
    stages,
    lc: LaunchConfig = DEFAULT,
    *,
    tiled: bool = False,
    tile_w: int | None = None,
) -> tuple:
    """(N, H, W) u8 or f32 planes -> tuple of output bands in one launch:
    (N, H, W) each, or resized by the pyrDowns (ceil half), resize2s (floor
    half) and pyrUps (double) that made the band; of the carrier's dtype,
    f32 for a Sobel pair.

    The chain is planned first on every device (an untiled chain whose
    rings exceed `lc.smem_budget` raises `ValueError`, as does a gather
    whose displacement bound is too small).  Then a CPU tensor runs the
    plain version; any other tensor launches the kernel or raises."""
    stages = tuple(stages)
    prog, table = program(stages, lc.stream_rows, planes.dtype, planes.device)
    sms = _sms(planes.device) if planes.is_cuda else 132
    geom = stream_geometry(prog, tuple(planes.shape), lc, tiled=tiled, tile_w=tile_w, sms=sms)
    plan.check_gathers(stages, planes.shape[-2:], lc.stream_rows, geom.tile_w)
    if planes.device.type == "cpu":
        return stencil_stream_plain(planes, stages)
    fn = _launcher()
    check_planes("stencil_stream", planes)
    N, H, W = planes.shape
    outs, bands = band_outputs(planes, prog.bands, stages, prog.layout.lv, (1, geom.tile_w))
    with _build.on_device(planes.device):
        err = fn(
            planes.data_ptr(),
            ctypes.addressof(bands),
            table.data_ptr(),
            prog.table_bytes,
            N,
            H,
            W,
            geom.tile_w,
            geom.n_seg,
            geom.seg_rows,
            geom.smem_bytes + prog.table_smem,
            geom.threads,
            int(planes.dtype == torch.uint8),
            int(geom.ahead),
            _build.cuda_stream(planes.device),
        )
    _build.check(err, "stencil_stream")
    counters.LAUNCHES["stencil_stream"] += 1
    return outs
