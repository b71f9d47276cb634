"""Window executor: the `stencil_chain` CUDA kernel's wrapper, its host-side
planner, and its plain PyTorch version.

Replaces `repro.kernels.stencil.exec_window.window_kernel` (TPU, Pallas),
and computes what `exec_streaming.streaming_kernel` computes.  Bound on an
H100: bytes (each input pixel read once, each output band written once;
the arithmetic is far below the fp32 rate), so the kernel keeps every
intermediate band in shared memory and writes each band once.  One block
per (plane, output tile) loads the tile's window, clamping coordinates only
on that read, and runs the chain there; see ``csrc/stencil_chain.cu``.

`compile_chain` turns a chain into the kernel's step table: which
shared-memory slots each stage reads and writes (a Sobel writes two, the
pair reduction reads two), which halo the source band still carries,
whether the step packs its result to u8, and which output bands are final
after the step and stored.  Every output band has a buffer of its own
dtype and size (`band_outputs`): the carrier's, or f32 for a Sobel pair.
Each step runs in the frame of its level (`plan.chain_levels`): the tile
at that resolution plus the level's pad, a tile that is a multiple of the
chain's stride product, so every level's tile is whole.  A strided stage
before the last halves the frame of the stages after it and a pyrUp
doubles it, writing both phases into the doubled frame; a strided last
stage (pyrDown, resize2) computes only the image-even rows and columns of
the tile and stores them straight to its decimated output.  A gather
(warp_affine, remap) samples its source band at absolute image
coordinates, its level's origin (tile origin minus the pad) plus the
frame index; remap's map planes are read from device memory.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import _build, counters, ref
from .plan import (
    SEPARABLE_OPS,
    Levels,
    aligned_pad,
    band_hw,
    band_walk,
    chain_accumulated_halo,
    chain_levels,
    check_gathers,
    kernel_walk,
    stride_product,
)

MAX_STEPS = 32
MAX_WEIGHTS = 512
MAX_BANDS = 16
MAX_MAPS = 4
MAX_LEVELS = 8
# stage op -> the kernels' op code (csrc/stencil_ops.cuh `stencil::Op`);
# grad_mag in reduce mode is the pair magnitude, GRAD_PAIR
OP_CODES = {
    "sep_filter": 0,
    "erode": 1,
    "grad_mag": 2,
    "filter2d": 4,
    "dilate": 5,
    "box": 6,
    "threshold": 7,
    "affine": 8,
    "pyr_down": 9,
    "sobel": 10,
    "resize2": 12,
    "warp_affine": 13,
    "remap": 14,
    "pyr_up": 15,
}
_STORE = 3
GRAD_PAIR = 11
CARRIERS = (torch.uint8, torch.float32)
_STEP_FIELDS = (
    "op", "src", "src2", "dst", "dst2", "tmp", "kh", "kw", "wx", "wy", "rh", "rw", "oh", "ow",
    "ls", "lo", "store", "store2", "down", "pk",
)


class _Step(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _STEP_FIELDS]


class _Program(ctypes.Structure):
    """Mirror of ``ChainProgram`` in csrc/stencil_chain.cu."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("n_levels", ctypes.c_int),
        ("pad", ctypes.c_int * 2),
        ("steps", _Step * MAX_STEPS),
        ("pads", ctypes.c_int * (2 * MAX_LEVELS)),
        ("weights", ctypes.c_float * MAX_WEIGHTS),
    ]


class Bands(ctypes.Structure):
    """Mirror of ``stencil::Bands`` in csrc/stencil_ops.cuh: each output
    band's buffer, dtype and (h, w), each remap stage's map planes (map_x,
    map_y), and each level's image (h, w) and tile (rows, cols) at this
    launch, passed to the kernel by value."""

    _fields_ = [
        ("out", ctypes.c_void_p * MAX_BANDS),
        ("maps", ctypes.c_void_p * (2 * MAX_MAPS)),
        ("u8", ctypes.c_int * MAX_BANDS),
        ("h", ctypes.c_int * MAX_BANDS),
        ("w", ctypes.c_int * MAX_BANDS),
        ("lh", ctypes.c_int * MAX_LEVELS),
        ("lw", ctypes.c_int * MAX_LEVELS),
        ("th", ctypes.c_int * MAX_LEVELS),
        ("tw", ctypes.c_int * MAX_LEVELS),
    ]


PROGRAM_BYTES = ctypes.sizeof(_Program)
# stencil_chain_launch(in, bands*, prog, n, h, w, tile_h, tile_w, slot, n_slots, threads, u8,
#                      stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@dataclass(frozen=True)
class ChainProgram:
    """A chain compiled for the kernel: steps as field dicts, the flat tap
    weights, the shared-memory slots it needs, each output band's ``(dtype,
    resolution ops)`` (`plan.band_meta`), the window's pad (the chain's
    accumulated halo, aligned to its stride product), the levels of the
    chain (`plan.Levels`) with each level's pad (level 0: `halo`), and the
    stride product a tile must be a multiple of."""

    steps: tuple
    weights: tuple
    n_slots: int
    bands: tuple
    halo: tuple
    levels: Levels | None = None
    pads: tuple = ()
    unit: tuple = (1, 1)
    # (tile) -> slot floats and (LaunchConfig) -> pick_tile: planned once
    _memo: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    def frame(self, level: int, th: int, tw: int) -> tuple:
        """(rows, cols) of a level's frame for a (th, tw) input tile."""
        lt = self.levels.tile(level, th, tw)
        return lt[0] + 2 * self.pads[level][0], lt[1] + 2 * self.pads[level][1]

    def slot_floats(self, th: int, tw: int) -> int:
        """Floats of one slot: the largest level frame, or the row-pass
        scratch of a resolution change (a pyrUp's: its output rows at its
        input's width; a strided stage's: its input rows at its output's
        width), if larger."""
        areas = [r * c for r, c in (self.frame(lv, th, tw) for lv in range(len(self.pads)))]
        for st in self.steps:
            if st["ls"] != st["lo"]:
                (rs, cs), (rd, cd) = self.frame(st["ls"], th, tw), self.frame(st["lo"], th, tw)
                areas.append(rd * cs if st["op"] == OP_CODES["pyr_up"] else rs * cd)
        return max(areas)

    def packed(self) -> bytes:
        p = _Program(n_steps=len(self.steps), n_levels=len(self.pads))
        for k, st in enumerate(self.steps):
            p.steps[k] = _Step(**st)
        for k, (py, px) in enumerate(self.pads):
            p.pads[2 * k], p.pads[2 * k + 1] = py, px
        for k, v in enumerate(self.weights):
            p.weights[k] = v
        return bytes(p)


def check_ported(stages, kernel: str) -> list:
    """The chain's `plan.kernel_walk`; raise `NotImplementedError` where a
    chain needs more output bands, remap stages or resolution levels than
    the kernels' tables hold."""
    resolved = kernel_walk(stages)
    n_bands = resolved[-1][6] if resolved else 1
    n_levels = chain_levels(stages).n_levels
    if (n_bands > MAX_BANDS or sum(s.op == "remap" for s in stages) > MAX_MAPS
            or n_levels > MAX_LEVELS):
        raise NotImplementedError(
            f"{kernel}: at most {MAX_BANDS} output bands, {MAX_MAPS} remap stages and "
            f"{MAX_LEVELS} resolution levels a launch"
        )
    return resolved


def stage_params(s, mode: str, halo: tuple, weights: list, maps: list) -> dict:
    """One stage's op code, extents and the offsets of its taps or scalars,
    appending them to `weights` (the step table's shared weight array; an
    affine warp's M goes in rounded to f32).  Threshold's maxval goes in as
    it is: the step packs it to its band's dtype as it packs any result.  A
    remap's `wx` is the index of its map planes in `maps`, which it is
    appended to."""
    hy, hx = halo
    kh, kw = 2 * hy + 1, 2 * hx + 1
    wx = wy = len(weights)
    op = GRAD_PAIR if mode == "reduce" else OP_CODES[s.op]
    if s.op in ("sep_filter", "pyr_down"):
        kx, ky = s.weights if s.op == "sep_filter" else s.weights * 2
        if (len(ky), len(kx)) != (kh, kw):
            raise NotImplementedError("stencil kernels: even-length filter taps")
        weights += kx.tolist()
        wy = len(weights)
        weights += ky.tolist()
    elif s.op == "filter2d":
        if tuple(s.weights[0].shape) != (kh, kw):
            raise NotImplementedError("stencil kernels: even-sized filter2d kernels")
        weights += s.weights[0].reshape(-1).tolist()
    elif s.op == "box":
        weights.append(float(torch.tensor(1.0 / (kh * kw), dtype=torch.float32)))
    elif s.op == "threshold":
        weights += list(s.static)
    elif s.op == "affine":
        weights += list(s.static)
    elif s.op == "warp_affine":
        weights += list(s.static[:6])
    elif s.op == "remap":
        wx = len(maps)
        maps.append(s)
    return {"op": op, "kh": kh, "kw": kw, "wx": wx, "wy": wy, "down": s.stride[0]}


def compile_chain(stages, carrier: torch.dtype = torch.float32) -> ChainProgram:
    """Plan the kernel's steps for a chain (`NotImplementedError` past the
    tables' limits).  Slot 0 holds the input window; each band takes a slot
    from its step until the last stage that reads it, and is stored by the
    step that makes it when it is an output band.  A step's ``rh, rw`` are
    the rows and columns around the tile its source holds and ``oh, ow``
    those its output covers, at the levels ``ls`` and ``lo`` of its source
    and output; ``down`` is 2 for a strided last stage only, which stores
    straight to its decimated band."""
    resolved = check_ported(stages, "stencil_chain")
    lv = chain_levels(stages)
    walk = band_walk(stages, carrier)
    final = {d: b for b, d in enumerate(walk.outs)}
    in_use = [True]  # slot 0 holds the input window

    def alloc() -> int:
        for i, used in enumerate(in_use):
            if not used:
                in_use[i] = True
                return i
        in_use.append(True)
        return len(in_use) - 1

    def step(**kw) -> dict:
        st = dict.fromkeys(_STEP_FIELDS, 0) | {"down": 1, "store": -1, "store2": -1}
        st.update(kw)
        return st

    steps, weights, maps = [], [], []
    slot_of = {0: 0}
    last = len(resolved) - 1
    if 0 in final:  # the input band is an output as it is
        rh, rw = lv.need[0] if resolved else (0, 0)
        steps.append(step(op=_STORE, rh=rh, rw=rw, oh=rh, ow=rw, store=final[0]))
    for k, (s, (op, mode, (hy, hx), *_rest), stage) in enumerate(zip(stages, resolved, walk.apps)):
        params = stage_params(s, mode, (hy, hx), weights, maps)
        params["down"] = params["down"] if k == last else 1
        (rh, rw), (oh, ow) = lv.need[k], lv.need_out(k)
        for srcs, dsts in stage:
            # a strided last stage stores straight from its last pass: no dst slot
            dslots = [alloc() if params["down"] == 1 else -1 for _ in dsts]
            tmp = alloc() if op in SEPARABLE_OPS or op == "pyr_up" else dslots[0]
            src = [slot_of[i] for i in srcs]
            steps.append(step(
                src=src[0], src2=src[-1], dst=dslots[0], dst2=dslots[-1], tmp=tmp, rh=rh, rw=rw,
                oh=oh, ow=ow, ls=lv.lv_in[k], lo=lv.lv_out[k],
                store=final.get(dsts[0], -1), store2=final.get(dsts[-1], -1) if len(dsts) > 1 else -1,
                pk=int(walk.meta[dsts[0]][0] == torch.uint8), **params,
            ))
            if tmp != dslots[0]:
                in_use[tmp] = False
            slot_of.update(zip(dsts, dslots))
            for i in srcs:  # a map's source is replaced: free it at once
                if walk.last_read[i] <= k and slot_of.get(i, -1) >= 0:
                    in_use[slot_of.pop(i)] = False
        for i in [i for i, sl in slot_of.items() if sl >= 0 and walk.last_read[i] <= k]:
            in_use[slot_of.pop(i)] = False
    if len(steps) > MAX_STEPS or len(weights) > MAX_WEIGHTS:
        raise ValueError(
            f"stencil_chain: {len(steps)} steps / {len(weights)} weights exceed the "
            f"kernel's table ({MAX_STEPS} / {MAX_WEIGHTS})"
        )
    ph_acc, pw_acc = chain_accumulated_halo(stages)
    down_y, down_x = stride_product(stages)
    halo = (aligned_pad(ph_acc, down_y), aligned_pad(pw_acc, down_x))
    bands = tuple(walk.meta[i] for i in walk.outs)
    pads = (halo,) + lv.pads[1:]
    return ChainProgram(tuple(steps), tuple(weights), len(in_use), bands, halo, lv, pads,
                        (down_y, down_x))


def pick_tile(prog: ChainProgram, lc: LaunchConfig) -> tuple[int, int, int]:
    """Largest tile (halving from the configured one) whose slots fit the
    block's shared-memory budget.  Returns (tile_h, tile_w, bytes).  A tile
    is a multiple of the chain's stride product, so that every level's
    tile is whole and starts on an image-even row and column above a
    stride.  The tile is at the input's resolution; the window is the tile
    plus the chain's accumulated halo, the gathers' included."""
    hit = prog._memo.get(lc)
    if hit is None:
        hit = prog._memo[lc] = _pick_tile(prog, lc)
    return hit


def _pick_tile(prog: ChainProgram, lc: LaunchConfig) -> tuple[int, int, int]:
    uy, ux = prog.unit
    th, tw = lc.tile_rows, lc.tile_cols
    if th % uy or tw % ux:
        raise ValueError(
            f"stencil_chain: a {th}x{tw} tile is not a multiple of the stride product {prog.unit}"
        )
    while True:
        smem = prog.n_slots * prog.slot_floats(th, tw) * 4
        if smem + PROGRAM_BYTES <= lc.smem_budget:
            return th, tw, smem
        if th == uy and tw == ux:
            raise ValueError(
                f"stencil_chain: a {th}x{tw} tile under the halo {prog.halo} needs "
                f"{smem + PROGRAM_BYTES} bytes of shared memory, over the budget of {lc.smem_budget}"
            )
        th, tw = max(uy, th // 2 // uy * uy), max(ux, tw // 2 // ux * ux)


def chain_key(stages) -> tuple:
    """A chain's cache key: its ops, statics, taps and tap weights.  A
    remap's map planes are bound at each launch, not in the program, so
    only their shape enters."""
    return tuple(
        (s.op, s.static, s.tap, tuple(
            (tuple(w.shape), () if s.op == "remap" else tuple(w.reshape(-1).tolist()))
            for w in s.weights
        ))
        for s in stages
    )


# (chain, carrier, device) -> (ChainProgram, its packed step table on the device)
_PROGRAMS: dict = {}


def _program(stages, carrier: torch.dtype, device: torch.device) -> tuple:
    """The chain's compiled program, and its step table copied to `device`
    once per chain (not once per launch)."""
    key = (chain_key(stages), carrier, str(device))
    hit = _PROGRAMS.get(key)
    if hit is None:
        prog = compile_chain(stages, carrier)
        table = torch.frombuffer(bytearray(prog.packed()), dtype=torch.uint8).to(device)
        hit = _PROGRAMS[key] = (prog, table)
    return hit


@functools.cache
def _launcher():
    lib = _build.library("stencil_chain")
    if lib.stencil_chain_program_bytes() != PROGRAM_BYTES:
        raise RuntimeError("stencil_chain: ChainProgram layout differs between C and Python")
    if lib.stencil_bands_bytes() != ctypes.sizeof(Bands):
        raise RuntimeError("stencil_chain: Bands layout differs between C and Python")
    fn = lib.stencil_chain_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stencil_chain_plain(planes: torch.Tensor, stages) -> tuple:
    """Plain PyTorch version of the kernel: `ref.chain_ref_planes`."""
    counters.PLAIN_CALLS["stencil_chain"] += 1
    return ref.chain_ref_planes(planes, tuple(stages))


def check_planes(name: str, planes: torch.Tensor) -> None:
    if not planes.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {planes.device}")
    if planes.dtype not in CARRIERS or planes.ndim != 3 or not planes.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous (N, H, W) uint8 or float32 planes, got "
            f"{planes.dtype} {tuple(planes.shape)}"
        )


def band_outputs(planes: torch.Tensor, bands, stages, levels: Levels, tile=(1, 1)) -> tuple:
    """One buffer per output band, (N, h_b, w_b) of the band's dtype ((H,
    W), or `plan.band_hw` of the resolution ops that made it), and the
    `Bands` table the kernel takes: those buffers, the remap stages' map
    planes, which must lie on the planes' device as contiguous f32 planes
    of their level's size, and each level's image size and tile for an
    input tile of `tile` (rows, cols)."""
    N, H, W = planes.shape
    outs, table = [], Bands()
    for lv in range(levels.n_levels):
        table.lh[lv], table.lw[lv] = levels.size(lv, H, W)
        table.th[lv], table.tw[lv] = levels.tile(lv, *tile)
    for b, (dt, ops) in enumerate(bands):
        h, w = band_hw(ops, H, W)
        o = torch.empty((N, h, w), dtype=dt, device=planes.device)
        outs.append(o)
        table.out[b], table.u8[b], table.h[b], table.w[b] = o.data_ptr(), dt == torch.uint8, h, w
    maps = [m for s in stages if s.op == "remap" for m in s.weights]
    for i, m in enumerate(maps):
        if m.device != planes.device or m.dtype != torch.float32 or not m.is_contiguous():
            raise ValueError(
                f"remap stage: map planes must be contiguous float32 on {planes.device}, got "
                f"{m.dtype} on {m.device}"
            )
        table.maps[i] = m.data_ptr()
    return tuple(outs), table


def stencil_chain(planes: torch.Tensor, stages, lc: LaunchConfig = DEFAULT) -> tuple:
    """(N, H, W) u8 or f32 planes -> tuple of output bands in one launch:
    (N, H, W) each, or resized by the pyrDowns (ceil half), resize2s (floor
    half) and pyrUps (double) that made the band; of the carrier's dtype,
    f32 for a Sobel pair.

    The gathers' displacement bounds are checked first (`plan.check_gathers`,
    `ValueError`).  Then a CPU tensor runs the plain version; any other
    tensor launches the kernel or raises.  Every plane size launches,
    planes smaller than the chain's halo included."""
    stages = tuple(stages)
    check_gathers(stages, planes.shape[-2:], lc.stream_rows)
    if planes.device.type == "cpu":
        return stencil_chain_plain(planes, stages)
    fn = _launcher()
    check_planes("stencil_chain", planes)
    prog, dev_prog = _program(stages, planes.dtype, planes.device)
    th, tw, _ = pick_tile(prog, lc)
    N, H, W = planes.shape
    outs, table = band_outputs(planes, prog.bands, stages, prog.levels, (th, tw))
    with torch.cuda.device(planes.device):
        err = fn(
            planes.data_ptr(),
            ctypes.addressof(table),
            dev_prog.data_ptr(),
            N,
            H,
            W,
            th,
            tw,
            prog.slot_floats(th, tw),
            prog.n_slots,
            lc.threads,
            int(planes.dtype == torch.uint8),
            _build.cuda_stream(planes.device),
        )
    _build.check(err, "stencil_chain")
    counters.LAUNCHES["stencil_chain"] += 1
    return outs
