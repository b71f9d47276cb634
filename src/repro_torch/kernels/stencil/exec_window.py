"""Window executor: the `stencil_chain` CUDA kernel's wrapper, its host-side
planner, and its plain PyTorch version.

Replaces `repro.kernels.stencil.exec_window.window_kernel` (TPU, Pallas),
and computes what `exec_streaming.streaming_kernel` computes.  Bound on an
H100: bytes by the chain's own counts (each input pixel read once, each
output band written once), but operations by what a window must compute:
a block recomputes its tile's halo through every stage.  So the kernel
computes only the rows and columns of a frame that are distinct (below),
in register strips, and keeps every intermediate band in shared memory;
see ``csrc/stencil_chain.cu``.

`compile_chain` turns a chain into the kernel's program: one frame per band
(its level, the rows and columns around the tile it holds, and its clamp),
one step per stage application (which frames and shared-memory slots it
reads and writes, its taps, whether it packs to u8, which output bands it
stores), and the flat tap weights.  Every output band has a buffer of its
own dtype and size (`band_outputs`).

Frames: a band's frame is its tile at its level (`plan.chain_levels`)
plus the rows and columns its readers need around it, ``R``.  In the
edge-padded window, a band made from the input through level-0, stride-1,
position-independent stages (filters, box, erode, dilate, Sobel, the grad
pair, the pointwise stages) repeats its row ``-L`` above it and its row
``H - 1 + L`` below it, where ``L`` is the sum of the halos along its
lineage (0 for the input): the rows beyond have the same operands in the
same order.  Such a band, when every reader of it reads through a clamp,
is *cut*: its frame keeps only the rows ``[-L, H + L)`` (and columns
likewise) and every read clamps into the frame, which is bit-identical by
construction.  The octave ladder of a 32x32 request plane thus holds
frames of at most 64x64 instead of 100x100.  Gathers, resolution changes
and the bands they read keep full frames.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import _build, counters, ref
from .plan import (
    SEPARABLE_OPS,
    Levels,
    PlanOverBudget,
    aligned_pad,
    band_hw,
    band_walk,
    chain_accumulated_halo,
    chain_levels,
    chain_threads,
    check_gathers,
    kernel_walk,
    stride_product,
)

# the kernels' per-launch tables, passed by value (csrc/stencil_ops.cuh)
MAX_BANDS = 64
MAX_MAPS = 16
MAX_LEVELS = 16
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
# the ops whose window bodies read their sources through a clamp to the
# source's frame (csrc/stencil_chain.cu), and whose outputs repeat beyond
# their lineage's halo at level 0
CLAMPED_OPS = frozenset(
    {"sep_filter", "box", "erode", "dilate", "filter2d", "grad_mag", "sobel", "threshold",
     "affine"}
)
# the clamp of a frame that is not cut: past any frame's extent
UNCUT = 1 << 20
_FRAME_FIELDS = ("level", "ry", "rx", "ly", "lx", "pad")
_STEP_FIELDS = (
    "op", "src", "src2", "dst", "dst2", "tmp", "fs", "fs2", "fd", "fd2", "kh", "kw", "wx", "wy",
    "rh", "rw", "ls", "lo", "store", "store2", "down", "pk",
)
# ints of the program's header: steps, frames, weights, padding
HEADER_INTS = 4


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


# stencil_chain_launch(in, bands*, prog, prog_bytes, n, h, w, tile_h, tile_w, slot,
#                      n_slots, threads, u8, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@dataclass(frozen=True)
class ChainProgram:
    """A chain compiled for the kernel: steps and band frames as field
    dicts, the flat tap weights, the shared-memory slots it needs, each
    output band's ``(dtype, resolution ops)`` (`plan.band_meta`), the
    chain's accumulated halo (aligned to its stride product), the levels of
    the chain (`plan.Levels`), and the stride product a tile must be a
    multiple of."""

    steps: tuple
    frames: tuple
    weights: tuple
    n_slots: int
    bands: tuple
    halo: tuple
    levels: Levels | None = None
    unit: tuple = (1, 1)
    # (tile, shape) -> slot floats; (LaunchConfig, shape) -> pick_tile: planned once
    _memo: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    @property
    def table_bytes(self) -> int:
        """Bytes of the packed program, which each block copies into its
        shared memory: the header, the frames, the steps, the weights."""
        ints = HEADER_INTS + len(_FRAME_FIELDS) * len(self.frames)
        return 4 * (ints + len(_STEP_FIELDS) * len(self.steps) + len(self.weights))

    def table_smem(self) -> int:
        """The table's shared memory, rounded up to the 16 bytes the slots
        after it are aligned to."""
        return -(-self.table_bytes // 16) * 16

    def frame_spans(self, th: int, tw: int, shape: tuple | None = None) -> list:
        """Per band, the largest (rows, cols) its frame takes over the tiles
        of an (H, W) plane (`frame_extent`); with no shape, the frame of a
        tile whose frames nothing cuts."""
        return [
            (_span(fr, 0, th, tw, shape, self.levels), _span(fr, 1, th, tw, shape, self.levels))
            for fr in self.frames
        ]

    def slot_floats(self, th: int, tw: int, shape: tuple | None = None) -> int:
        """Floats of one slot: the largest frame of a band that has a slot,
        or of a step's row-pass scratch, at a row stride of its columns
        rounded up to odd (`frame_extent`, `tmp_extent`); over the tiles of
        an (H, W) plane, or with no shape for uncut frames."""
        return self.areas(th, tw, shape)[0]

    def areas(self, th: int, tw: int, shape: tuple | None = None) -> tuple:
        """(`slot_floats`, the most 4-output strips any one pass of a block
        computes: a step's output frame or its row-pass scratch)."""
        key = (th, tw, shape)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = _areas(self, th, tw, shape)
        return hit

    def packed(self) -> bytes:
        ints = [len(self.steps), len(self.frames), len(self.weights), 0]
        for fr in self.frames:
            ints += [fr[f] for f in _FRAME_FIELDS]
        for st in self.steps:
            ints += [st[f] for f in _STEP_FIELDS]
        return (np.asarray(ints, dtype=np.int32).tobytes()
                + np.asarray(self.weights, dtype=np.float32).tobytes())


def frame_extent(fr: dict, axis: int, t0, t: int, size: int):
    """A band frame's [lo, hi) along one axis for tiles starting at `t0`
    (int or array) of `t` rows (or columns) at its level, in a plane of
    `size` at that level: the tile plus ``R`` each way, cut to [-L, size +
    L) (``L`` is `UNCUT` for a frame that is not cut)."""
    r, cut = (fr["ry"], fr["ly"]) if axis == 0 else (fr["rx"], fr["lx"])
    return np.maximum(t0 - r, -cut), np.minimum(t0 + t + r, size + cut)


def tmp_extent(st: dict, fs: tuple, fd: tuple, t0, t: int) -> tuple:
    """The row-pass scratch of a step, per axis ((rows lo, hi), (cols lo,
    hi)), from its source frame ``fs`` and output frame ``fd`` (each
    ((y0, y1), (x0, x1))) for tiles at ``t0`` = (ty0, tx0) of ``t`` = (th,
    tw) at the source's level, or None for a step without one:

    * separable, same level: the source rows the output reads (clamped into
      the source frame) by the output's columns;
    * pyrUp: the output's rows by the source columns it reads;
    * pyrDown before the last stage: the source rows it reads by the
      output's columns;
    * pyrDown last: the tile's rows plus the halo by its image-even
      columns (``[0, ceil(tw / 2))``)."""
    op, down = st["op"], st["down"]
    (sy0, sy1), _sx = fs
    hy = st["kh"] // 2
    if op == OP_CODES["pyr_down"] and down == 2:
        return (t0[0] - hy, t0[0] + t[0] + hy), (0, (t[1] + 1) // 2)
    (dy0, dy1), (dx0, dx1) = fd
    if op == OP_CODES["pyr_up"]:
        return (dy0, dy1), (np.floor_divide(dx0, 2) - 1, np.floor_divide(dx1 - 1, 2) + 2)
    if op == OP_CODES["pyr_down"]:
        return (2 * dy0 - hy, 2 * (dy1 - 1) + hy + 1), (dx0, dx1)
    if op in (0, 1, 5, 6):
        return (np.maximum(dy0 - hy, sy0), np.minimum(dy1 - 1 - hy + st["kh"] - 1, sy1 - 1) + 1), \
            (dx0, dx1)
    return None


def _tiles(levels: Levels, level: int, th: int, tw: int, shape) -> tuple:
    """Tile origins (rows, cols) at `level` for every tile of an (H, W)
    plane, the tile there and the plane's size there."""
    lth, ltw = levels.tile(level, th, tw)
    if shape is None:
        return np.array([0]), np.array([0]), lth, ltw, UNCUT, UNCUT
    H, W = shape
    lh, lw = levels.size(level, H, W)
    return (np.arange(-(-H // th)) * lth, np.arange(-(-W // tw)) * ltw, lth, ltw, lh, lw)


def _extent(fr: dict, axis: int, th: int, tw: int, shape, levels: Levels):
    ty, tx, lth, ltw, lh, lw = _tiles(levels, fr["level"], th, tw, shape)
    if shape is None:  # a tile nothing cuts
        fr = fr | {"ly": UNCUT, "lx": UNCUT}
    return frame_extent(fr, axis, ty if axis == 0 else tx, lth if axis == 0 else ltw,
                        lh if axis == 0 else lw)


def _span(fr: dict, axis: int, th: int, tw: int, shape, levels: Levels) -> int:
    lo, hi = _extent(fr, axis, th, tw, shape, levels)
    return int((hi - lo).max())


def _areas(prog: ChainProgram, th: int, tw: int, shape) -> tuple:
    slotted = {st["fd"] for st in prog.steps if st["dst"] >= 0}
    slotted |= {st["fd2"] for st in prog.steps if st["dst2"] >= 0}
    slotted.add(0)
    spans = prog.frame_spans(th, tw, shape)
    areas = [r * (c | 1) for b, (r, c) in enumerate(spans) if b in slotted]
    strips = [r * -(-c // 4) for b, (r, c) in enumerate(spans)
              if any(b == st["fd"] for st in prog.steps)]
    for st in prog.steps:
        if st["tmp"] < 0:
            continue
        fs = prog.frames[st["fs"]]
        ext_s = (_extent(fs, 0, th, tw, shape, prog.levels),
                 _extent(fs, 1, th, tw, shape, prog.levels))
        ext_d = None
        if st["fd"] >= 0:
            fd = prog.frames[st["fd"]]
            ext_d = (_extent(fd, 0, th, tw, shape, prog.levels),
                     _extent(fd, 1, th, tw, shape, prog.levels))
        ty, tx, lth, ltw, _lh, _lw = _tiles(prog.levels, fs["level"], th, tw, shape)
        (ra, rb), (ca, cb) = tmp_extent(st, ext_s, ext_d, (ty, tx), (lth, ltw))
        rows, cols = int(np.max(rb - ra)), int(np.max(cb - ca))
        areas.append(rows * (cols | 1))
        strips.append(rows * -(-cols // 4))
    return max(areas), max(strips, default=1)


# FLOP per output of the per-output bodies (chip_smoke.py `stage_flops`'s
# counts): a Sobel pair, central-difference grad, the pair magnitude, the
# pointwise stages, the gathers, a pyrUp output's two phases, resize2
_PER_OUTPUT_FLOPS = {10: 13, 2: 7, 11: 3, 7: 1, 8: 2, 13: 19, 14: 11, 15: 4.5, 12: 3}


def window_flops(prog: ChainProgram, th: int, tw: int, shape: tuple) -> float:
    """The arithmetic the kernel's windows do on one (H, W) plane, summed
    over its tiles: each step's outputs over its output frame (and a
    separable stage's row pass over its scratch) times the taps, a rounded
    product and sum a tap for the filters, one operation a tap for box,
    erode and dilate; a strided last stage's image-even outputs.  With
    every frame full (`UNCUT`) this is what full windows compute."""
    lv = prog.levels
    total = 0.0

    def area(ext_y, ext_x):
        return float(np.sum(ext_y[1] - ext_y[0])) * float(np.sum(ext_x[1] - ext_x[0]))

    for st in prog.steps:
        op = st["op"]
        if op == _STORE:
            continue
        fs = prog.frames[st["fs"]]
        es = (_extent(fs, 0, th, tw, shape, lv), _extent(fs, 1, th, tw, shape, lv))
        per_tap = 2 if op in (0, 4, 9) else 1
        ty, tx, lth, ltw, _h, _w = _tiles(lv, fs["level"], th, tw, shape)
        if st["down"] == 2:
            rows_e, cols_e = (lth + 1) // 2, (ltw + 1) // 2
            n_t = len(ty) * len(tx)
            if op == 9:
                total += n_t * ((lth + 2 * (st["kh"] // 2)) * cols_e * st["kw"]
                                + rows_e * cols_e * st["kh"]) * per_tap
            else:
                total += n_t * rows_e * cols_e * 3
            continue
        fd = prog.frames[st["fd"]]
        ed = (_extent(fd, 0, th, tw, shape, lv), _extent(fd, 1, th, tw, shape, lv))
        out = area(*ed)
        if op in (0, 1, 5, 6, 9):
            tmp = tmp_extent(st, es, ed, (ty, tx), (lth, ltw))
            total += area(*tmp) * st["kw"] * per_tap + out * st["kh"] * per_tap + out * (op == 6)
        elif op == 4:
            total += out * st["kh"] * st["kw"] * per_tap
        else:
            total += out * _PER_OUTPUT_FLOPS[op]
    return total


def check_ported(stages, kernel: str) -> list:
    """The chain's `plan.kernel_walk`; raise `NotImplementedError` where a
    chain needs more output bands, remap stages or resolution levels than
    the kernels' per-launch tables (`Bands`) hold."""
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
    affine warp's M goes in rounded to f32).  A filter's extents are its
    taps' own, odd or even: halo ``k // 2``, output ``o`` reading source
    rows ``o - k//2 .. o - k//2 + k - 1`` (JAX's loops).  Threshold's maxval
    goes in as it is: the step packs it to its band's dtype as it packs any
    result.  A remap's `wx` is the index of its map planes in `maps`, which
    it is appended to."""
    hy, hx = halo
    kh, kw = 2 * hy + 1, 2 * hx + 1
    wx = wy = len(weights)
    op = GRAD_PAIR if mode == "reduce" else OP_CODES[s.op]
    if s.op in ("sep_filter", "pyr_down"):
        kx, ky = s.weights if s.op == "sep_filter" else s.weights * 2
        kh, kw = len(ky), len(kx)
        weights += kx.tolist()
        wy = len(weights)
        weights += ky.tolist()
    elif s.op == "filter2d":
        kh, kw = s.weights[0].shape
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
    """Plan the kernel's frames and steps for a chain (`NotImplementedError`
    past the per-launch tables' limits).

    Slot 0 holds the input band's frame; a band that a later stage reads
    takes a slot from its step until the last stage that reads it, and a
    band that only goes out is stored by the step that makes it, straight
    from its values (no slot).  A band's frame holds ``R`` = the rows and
    columns its maker's output must cover around the tile (``lv.need``; 0
    for a band nothing reads), and is cut to its lineage's halo ``L`` where
    every reader clamps (module docstring).  A step's ``rh, rw`` are the
    rows and columns around the tile its source must hold, at the levels
    ``ls`` and ``lo`` of its source and output; ``down`` is 2 for a strided
    last stage only, which stores straight to its decimated band."""
    resolved = check_ported(stages, "stencil_chain")
    lv = chain_levels(stages)
    walk = band_walk(stages, carrier)
    final = {d: b for b, d in enumerate(walk.outs)}
    last = len(resolved) - 1

    # each band's level, lineage halo (None: its rows beyond do not repeat),
    # whether every reader clamps, and the rows around the tile it holds
    level, lineage, clamped, need = {0: 0}, {0: (0, 0)}, {0: True}, {}
    need[0] = lv.need[0] if resolved else (0, 0)
    for k, ((op, mode, halo, *_r), stage) in enumerate(zip(resolved, walk.apps)):
        aware = op in CLAMPED_OPS
        for srcs, dsts in stage:
            for i in srcs:
                clamped[i] = clamped[i] and aware
                if need[i][0] < lv.need[k][0] or need[i][1] < lv.need[k][1]:
                    raise AssertionError(f"stencil_chain: band {i} holds {need[i]} < {lv.need[k]}")
            L = None
            if aware and lv.lv_in[k] == 0 and all(lineage[i] is not None for i in srcs):
                L = tuple(max(lineage[i][a] for i in srcs) + halo[a] for a in (0, 1))
            read_later = any(walk.last_read[d] > k for d in dsts)
            for d in dsts:
                level[d], lineage[d], clamped[d] = lv.lv_out[k], L, True
                need[d] = lv.need_out(k) if read_later else (0, 0)
    for k, ((op, *_r), stage) in enumerate(zip(resolved, walk.apps)):
        for _srcs, dsts in stage:  # a Sobel's pair shares one frame
            cut = all(lineage[d] is not None and clamped[d] for d in dsts)
            for d in dsts:
                clamped[d] = cut
    frames = []
    for i in range(len(walk.meta)):
        cut = lineage[i] is not None and clamped[i] and level[i] == 0
        ly, lx = lineage[i] if cut else (UNCUT, UNCUT)
        frames.append({"level": level[i], "ry": need[i][0], "rx": need[i][1], "ly": ly,
                       "lx": lx, "pad": 0})

    in_use = [True]  # slot 0 holds the input band

    def alloc() -> int:
        for i, used in enumerate(in_use):
            if not used:
                in_use[i] = True
                return i
        in_use.append(True)
        return len(in_use) - 1

    def step(**kw) -> dict:
        st = dict.fromkeys(_STEP_FIELDS, 0)
        st |= {"down": 1, "store": -1, "store2": -1, "dst": -1, "dst2": -1, "tmp": -1,
               "fd": -1, "fd2": -1}
        st.update(kw)
        return st

    steps, weights, maps = [], [], []
    slot_of = {0: 0}
    if 0 in final:  # the input band is an output as it is
        rh, rw = lv.need[0] if resolved else (0, 0)
        steps.append(step(op=_STORE, rh=rh, rw=rw, store=final[0]))
    for k, (s, (op, mode, (hy, hx), *_rest), stage) in enumerate(zip(stages, resolved, walk.apps)):
        params = stage_params(s, mode, (hy, hx), weights, maps)
        params["down"] = params["down"] if k == last else 1
        rh, rw = lv.need[k]
        for srcs, dsts in stage:
            strided_last = params["down"] != 1
            dslots = [alloc() if walk.last_read[d] > k else -1 for d in dsts]
            tmp = alloc() if op in SEPARABLE_OPS or op == "pyr_up" else -1
            steps.append(step(
                src=slot_of[srcs[0]], src2=slot_of[srcs[-1]], dst=dslots[0], dst2=dslots[-1],
                tmp=tmp, fs=srcs[0], fs2=srcs[-1], fd=-1 if strided_last else dsts[0],
                fd2=-1 if strided_last else dsts[-1], rh=rh, rw=rw, ls=lv.lv_in[k],
                lo=lv.lv_out[k], store=final.get(dsts[0], -1),
                store2=final.get(dsts[-1], -1) if len(dsts) > 1 else -1,
                pk=int(walk.meta[dsts[0]][0] == torch.uint8), **params,
            ))
            if tmp >= 0:
                in_use[tmp] = False
            slot_of.update((d, sl) for d, sl in zip(dsts, dslots) if sl >= 0)
            for i in srcs:  # a map's source is replaced: free it at once
                if walk.last_read[i] <= k and slot_of.get(i, -1) >= 0:
                    in_use[slot_of.pop(i)] = False
        for i in [i for i, sl in slot_of.items() if walk.last_read[i] <= k]:
            in_use[slot_of.pop(i)] = False
    ph_acc, pw_acc = chain_accumulated_halo(stages)
    down_y, down_x = stride_product(stages)
    halo = (aligned_pad(ph_acc, down_y), aligned_pad(pw_acc, down_x))
    bands = tuple(walk.meta[i] for i in walk.outs)
    return ChainProgram(tuple(steps), tuple(frames), tuple(weights), len(in_use), bands, halo, lv,
                        (down_y, down_x))


@dataclass(frozen=True)
class WindowGeometry:
    """One launch: the tile, the floats of a slot, the dynamic shared memory
    of a block (the program's table, then the slots), its threads and the
    blocks one SM holds (`plan.chain_threads`)."""

    tile_h: int
    tile_w: int
    slot: int
    smem_bytes: int
    threads: int
    per_sm: int


def pick_tile(prog: ChainProgram, lc: LaunchConfig, shape: tuple | None = None) -> tuple:
    """Largest tile (halving from the configured one) whose table and slots
    fit the block's shared-memory budget, for (N, H, W) planes (``shape``;
    None: frames nothing cuts).  Returns (tile_h, tile_w, bytes of dynamic
    shared memory).  A tile is a multiple of the chain's stride product,
    so that every level's tile is whole and starts on an image-even row
    and column above a stride."""
    g = window_geometry(prog, lc, shape)
    return g.tile_h, g.tile_w, g.smem_bytes


def window_geometry(prog: ChainProgram, lc: LaunchConfig, shape: tuple | None = None,
                    sms: int = 132) -> WindowGeometry:
    """`pick_tile`'s tile, then the threads and blocks an SM by
    `plan.chain_threads` for the launch's blocks (one per plane and tile)."""
    key = (lc, None if shape is None else tuple(shape), sms)
    hit = prog._memo.get(key)
    if hit is None:
        hit = prog._memo[key] = _window_geometry(prog, lc, shape, sms)
    return hit


def _window_geometry(prog, lc, shape, sms) -> WindowGeometry:
    uy, ux = prog.unit
    th, tw = lc.tile_rows, lc.tile_cols
    if th % uy or tw % ux:
        raise ValueError(
            f"stencil_chain: a {th}x{tw} tile is not a multiple of the stride product {prog.unit}"
        )
    hw = None if shape is None else tuple(shape[-2:])
    while True:
        slot, strips = prog.areas(th, tw, hw)
        smem = prog.table_smem() + prog.n_slots * slot * 4
        if smem <= lc.smem_budget:
            break
        if th == uy and tw == ux:
            raise PlanOverBudget(
                f"stencil_chain: a {th}x{tw} tile under the halo {prog.halo} needs "
                f"{smem} bytes of shared memory, over the budget of {lc.smem_budget}"
            )
        th, tw = max(uy, th // 2 // uy * uy), max(ux, tw // 2 // ux * ux)
    n_blocks = 1 if shape is None else shape[0] * -(-shape[1] // th) * -(-shape[2] // tw)
    threads, per_sm = chain_threads(n_blocks, smem, strips, sms)
    return WindowGeometry(th, tw, slot, smem, threads, per_sm)


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


# (chain, carrier, device) -> (ChainProgram, its packed program on the device)
_PROGRAMS: dict = {}
# (the stage objects' ids, ...) -> (the stages, the value): the last chains
# seen, so a caller that passes the same stage objects again skips keying
# their weights (`chain_key`); holding the stages keeps their ids unique
_BY_STAGES: dict = {}
_BY_STAGES_MAX = 256


def by_stages(stages, extra: tuple, build):
    """`build()` for a chain, memoised on the identity of its stage objects
    (and `extra`) for the last `_BY_STAGES_MAX` chains."""
    key = (tuple(map(id, stages)),) + extra
    hit = _BY_STAGES.get(key)
    if hit is None:
        if len(_BY_STAGES) >= _BY_STAGES_MAX:
            _BY_STAGES.pop(next(iter(_BY_STAGES)))
        hit = _BY_STAGES[key] = (tuple(stages), build())
    return hit[1]


def _program(stages, carrier: torch.dtype, device: torch.device) -> tuple:
    """The chain's compiled program, and its packed table copied to
    `device` once per chain (not once per launch)."""

    def build():
        key = (chain_key(stages), carrier, str(device))
        hit = _PROGRAMS.get(key)
        if hit is None:
            prog = compile_chain(stages, carrier)
            table = torch.frombuffer(bytearray(prog.packed()), dtype=torch.uint8).to(device)
            hit = _PROGRAMS[key] = (prog, table)
        return hit

    return by_stages(stages, ("window", carrier, str(device)), build)


@functools.cache
def _launcher():
    lib = _build.library("stencil_chain")
    sizes = (ctypes.c_int * 3)()
    lib.stencil_chain_layout(sizes)
    want = [4 * HEADER_INTS, 4 * len(_FRAME_FIELDS), 4 * len(_STEP_FIELDS)]
    if list(sizes) != want:
        raise RuntimeError(f"stencil_chain: program layout {list(sizes)} in C, {want} in Python")
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


# (bands, levels, H, W, tile) -> (a `Bands` with every size filled in, the
# bands grouped by dtype and size)
_BAND_TABLES: dict = {}


def band_outputs(planes: torch.Tensor, bands, stages, levels: Levels, tile=(1, 1)) -> tuple:
    """One buffer per output band, (N, h_b, w_b) of the band's dtype ((H,
    W), or `plan.band_hw` of the resolution ops that made it), and the
    `Bands` table the kernel takes: those buffers, the remap stages' map
    planes, which must lie on the planes' device as contiguous f32 planes
    of their level's size, and each level's image size and tile for an
    input tile of `tile` (rows, cols)."""
    N, H, W = planes.shape
    key = (bands, levels, H, W, tuple(tile))
    hit = _BAND_TABLES.get(key)
    if hit is None:  # the sizes and levels of a launch shape, once
        table = Bands()
        for lv in range(levels.n_levels):
            table.lh[lv], table.lw[lv] = levels.size(lv, H, W)
            table.th[lv], table.tw[lv] = levels.tile(lv, *tile)
        shapes = [(dt, *band_hw(ops, H, W)) for dt, ops in bands]
        for b, (dt, h, w) in enumerate(shapes):
            table.u8[b], table.h[b], table.w[b] = dt == torch.uint8, h, w
        groups = {}  # bands of one dtype and size share one allocation
        for b, sh in enumerate(shapes):
            groups.setdefault(sh, []).append(b)
        hit = _BAND_TABLES[key] = (bytes(table), tuple(groups.items()))
    raw, groups = hit
    table = Bands.from_buffer_copy(raw)
    outs = [None] * len(bands)
    for (dt, h, w), ids in groups:
        for b, o in zip(ids, torch.empty((len(ids), N, h, w), dtype=dt,
                                         device=planes.device).unbind(0)):
            outs[b] = o
            table.out[b] = o.data_ptr()
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
    g = window_geometry(prog, lc, tuple(planes.shape), _sms(planes.device))
    N, H, W = planes.shape
    outs, table = band_outputs(planes, prog.bands, stages, prog.levels, (g.tile_h, g.tile_w))
    with _build.on_device(planes.device):
        err = fn(
            planes.data_ptr(),
            ctypes.addressof(table),
            dev_prog.data_ptr(),
            prog.table_bytes,
            N,
            H,
            W,
            g.tile_h,
            g.tile_w,
            g.slot,
            prog.n_slots,
            g.threads,
            int(planes.dtype == torch.uint8),
            _build.cuda_stream(planes.device),
        )
    _build.check(err, "stencil_chain")
    counters.LAUNCHES["stencil_chain"] += 1
    return outs


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count

