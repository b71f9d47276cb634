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
kernel's program: `plan.stream_layout`'s streams with their ring offsets
and depths, and one step per stage application.  `stream_geometry` picks
the column tile and the row segments of a launch.  A strided last stage
(pyrDown) is planned at full resolution; its step computes the image-even
rows and columns of each step's rows and stores them straight to the
half-resolution output, so step rows, segment starts and column tiles are
all even.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import _build, counters, ref
from . import plan
from .exec_window import (
    MAX_STEPS,
    MAX_WEIGHTS,
    band_outputs,
    check_planes,
    check_ported,
    chain_key,
    stage_params,
    store_slots,
)

_STEP_FIELDS = ("op", "src", "dst", "kh", "kw", "wx", "wy", "rw", "lead", "store", "down")
_STREAM_FIELDS = ("depth", "offset", "store")
# threads of a block: its rings leave room for about one block per SM, so it
# takes more than the other kernels (scripts/torch_stencil_sweep.py)
MAX_THREADS = 1024


class _Step(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _STEP_FIELDS]


class _Stream(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _STREAM_FIELDS]


class _Program(ctypes.Structure):
    """Mirror of ``StreamProgram`` in csrc/stencil_stream.cu."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("n_streams", ctypes.c_int),
        ("ph", ctypes.c_int),
        ("pw", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("scratch", ctypes.c_int),
        ("pad", ctypes.c_int * 2),
        ("steps", _Step * MAX_STEPS),
        ("streams", _Stream * (MAX_STEPS + 1)),
        ("weights", ctypes.c_float * MAX_WEIGHTS),
    ]


PROGRAM_BYTES = ctypes.sizeof(_Program)
# stencil_stream_launch(in, out, out_half, prog, n, h, w, tile_w, n_seg, seg_rows, smem_rows, pw,
#                       threads, u8, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@dataclass(frozen=True)
class StreamProgram:
    """A chain compiled for `stencil_stream`: steps and streams as field
    dicts, the flat weights, the ring layout and the rows of shared memory
    (rings + scratch) one block needs per column of its tile window."""

    steps: tuple
    streams: tuple
    weights: tuple
    layout: plan.StreamLayout
    scratch: int
    downs: tuple

    @property
    def halo(self) -> tuple:
        return self.layout.halo

    @property
    def down(self) -> tuple:
        """(row, col) stride product: a pyrDown band's 2 both ways, else 1."""
        return (max(self.downs),) * 2

    @property
    def n_bands(self) -> int:
        return len(self.layout.outs)

    @property
    def smem_rows(self) -> int:
        return self.layout.smem_rows

    def packed(self) -> bytes:
        p = _Program(
            n_steps=len(self.steps),
            n_streams=len(self.streams),
            ph=self.halo[0],
            pw=self.halo[1],
            rows=self.layout.rows,
            scratch=self.scratch,
        )
        for k, st in enumerate(self.steps):
            p.steps[k] = _Step(**st)
        for k, st in enumerate(self.streams):
            p.streams[k] = _Stream(**st)
        for k, v in enumerate(self.weights):
            p.weights[k] = v
        return bytes(p)


def compile_stream(stages, rows: int, carrier: torch.dtype = torch.float32) -> StreamProgram:
    """Plan the kernel's streams and steps for a chain of the ported stages
    in map and tap modes, `rows` output rows per step."""
    resolved = check_ported(stages, "stencil_stream")
    plan.check_strides(plan.stride_product(stages), rows, 0)
    layout = plan.stream_layout(stages, rows)
    if len(layout.apps) > MAX_STEPS:
        raise ValueError(f"stencil_stream: {len(layout.apps)} steps exceed the table's {MAX_STEPS}")
    weights: list = []
    params = [stage_params(s, weights, carrier) for s in stages]
    if len(weights) > MAX_WEIGHTS:
        raise ValueError(f"stencil_stream: {len(weights)} weights exceed the table's {MAX_WEIGHTS}")
    downs = tuple(plan.band_downs(stages))
    slot_of = store_slots(downs)
    band_of = {s: slot_of[b] for b, s in enumerate(layout.outs)}
    streams, offset = [], 0
    for s, depth in enumerate(layout.depths):
        buffered_out = s in band_of and depth > 0
        streams.append(
            {"depth": depth, "offset": offset, "store": band_of[s] if buffered_out else -1}
        )
        offset += depth
    # column halo the source still carries before stage k: the halos of k..end
    col_halo = [sum(r[2][1] for r in resolved[k:]) for k in range(len(resolved))]
    steps = []
    for k, src, dst in layout.apps:
        direct = layout.depths[dst] == 0
        st = dict.fromkeys(_STEP_FIELDS, 0)
        st.update(params[k])
        st.update(
            src=src,
            dst=-1 if direct else dst,
            rw=col_halo[k],
            lead=layout.leads[dst],
            store=band_of[dst] if direct else -1,
        )
        steps.append(st)
    return StreamProgram(tuple(steps), tuple(streams), tuple(weights), layout, offset, downs)


@dataclass(frozen=True)
class StreamGeometry:
    """One launch's column tile (`tile_w` columns, `n_tiles` of them), row
    segments (`n_seg` per plane, `seg_rows` rows each), the shared memory
    one block takes and its threads."""

    tile_w: int
    n_tiles: int
    n_seg: int
    seg_rows: int
    smem_bytes: int
    threads: int


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
    `plan.pick_tile_plan`'s.  Segments: `lc.row_segments`, else
    `plan.row_segments` for `sms` multiprocessors.  Threads: `MAX_THREADS`,
    halved while they are at least as many as the values in one step's
    rows of the tile window (small planes)."""
    N, H, W = shape
    layout = prog.layout
    if not tiled:
        tw = W
    elif tile_w is not None or lc.tile2d_cols is not None:
        tw = min(tile_w if tile_w is not None else lc.tile2d_cols, W)
        if tw < 1:
            raise ValueError(f"stencil_stream: tile_w must be positive, got {tw}")
        plan.check_strides(prog.down, layout.rows, W, tw)
    else:
        tw = plan.pick_tile_plan(layout, W, lc.smem_budget, PROGRAM_BYTES) or W
    smem = layout.smem_bytes(tw)
    if smem + PROGRAM_BYTES > lc.smem_budget:
        what = "full-width" if not tiled else f"{tw}-column"
        raise ValueError(
            f"stencil_stream: the {what} rings of this chain need {smem} bytes of shared memory "
            f"(+{PROGRAM_BYTES} for the step table), over the budget of {lc.smem_budget}"
        )
    n_tiles = -(-W // tw)
    if lc.row_segments is not None:
        n_seg, seg_rows = plan.fix_segments(lc.row_segments, H, layout.rows)
    else:
        n_seg, seg_rows = plan.row_segments(N, n_tiles, H, layout.rows, sms)
    threads = MAX_THREADS
    while threads > 32 and threads >= layout.rows * (tw + 2 * layout.halo[1]):
        threads //= 2
    return StreamGeometry(tw, n_tiles, n_seg, seg_rows, smem, threads)


# (chain, rows, carrier, device) -> (StreamProgram, its packed table on the device)
_PROGRAMS: dict = {}


def program(stages, rows: int, carrier: torch.dtype, device: torch.device) -> tuple:
    """The chain's compiled program and, off the CPU, its table copied to
    `device` once per chain."""
    key = (chain_key(stages), rows, carrier, str(device))
    hit = _PROGRAMS.get(key)
    if hit is None:
        prog = compile_stream(stages, rows, carrier)
        table = None
        if device.type != "cpu":
            table = torch.frombuffer(bytearray(prog.packed()), dtype=torch.uint8).to(device)
        hit = _PROGRAMS[key] = (prog, table)
    return hit


@functools.cache
def _launcher():
    lib = _build.library("stencil_stream")
    if lib.stencil_stream_program_bytes() != PROGRAM_BYTES:
        raise RuntimeError("stencil_stream: StreamProgram layout differs between C and Python")
    fn = lib.stencil_stream_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    """(N, H, W) u8 or f32 planes -> tuple of output bands of the same
    dtype, in one launch: (N, H, W) each, or (N, ceil(H/2), ceil(W/2)) for
    a band a pyrDown made.

    The chain is planned first on every device (an untiled chain whose
    rings exceed `lc.smem_budget` raises `ValueError`).  Then a CPU tensor
    runs the plain version; any other tensor launches the kernel or
    raises."""
    stages = tuple(stages)
    prog, table = program(stages, lc.stream_rows, planes.dtype, planes.device)
    sms = 132
    if planes.is_cuda:
        sms = torch.cuda.get_device_properties(planes.device).multi_processor_count
    geom = stream_geometry(prog, tuple(planes.shape), lc, tiled=tiled, tile_w=tile_w, sms=sms)
    if planes.device.type == "cpu":
        return stencil_stream_plain(planes, stages)
    fn = _launcher()
    check_planes("stencil_stream", planes)
    N, H, W = planes.shape
    full, half, bands = band_outputs(planes, prog.downs)
    with torch.cuda.device(planes.device):
        err = fn(
            planes.data_ptr(),
            full.data_ptr(),
            half.data_ptr(),
            table.data_ptr(),
            N,
            H,
            W,
            geom.tile_w,
            geom.n_seg,
            geom.seg_rows,
            prog.smem_rows,
            prog.halo[1],
            geom.threads,
            int(planes.dtype == torch.uint8),
            _build.cuda_stream(planes.device),
        )
    _build.check(err, "stencil_stream")
    counters.LAUNCHES["stencil_stream"] += 1
    return bands
