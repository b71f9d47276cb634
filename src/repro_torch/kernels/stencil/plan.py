"""Chain geometry: the counterpart of `repro.kernels.stencil.plan`, reduced
to what the port's two kernels need.

  * `chain_accumulated_halo` — the halo the input is padded by;
  * `chain_iface` / `chain_stream_plan` — the exact backward row walk and
    the streaming carry plan, as the JAX planner computes them;
  * `stream_layout` — the rings of one `stencil_stream` block: which
    stream each stage reads and writes, how many rows each ring keeps and
    in which dtype, which stages run register strips, and the row-pass
    scratch of the others;
  * `pick_tile_plan`, `pick_stream_tile` — the tiled2d column-tile width,
    charging one tile's rings against a block's share of shared memory
    (the JAX planner's `pick_tile_plan` / `pick_tile_w` charge a working
    set against VMEM), two blocks an SM where that costs little column
    work;
  * `blocks_per_sm`, `row_segments` — how many blocks of a launch an SM
    holds at once, and how many row segments of a plane run as blocks of
    their own;
  * `band_walk` — which stage reads and makes which band, and its dtype;
  * `stage_out_hw`, `band_meta`, `band_hw`, `stride_product`,
    `check_strides` and `aligned_pad` — the geometry of a strided or
    upsampling stage and of each output band (the JAX planner's
    `build_chain_geom` and `_band_meta`): each band's dtype, resolution
    changes and output size, the stride product that step rows and column
    tiles must be multiples of, and a left pad that puts local-even
    columns on image-even ones;
  * `kernel_walk` and `chain_levels` — the resolutions a kernel walks
    through: a strided last stage is planned at its input's resolution
    (the kernels decimate it as they store), every other strided or
    upsampling map stage starts a new level, with its own frame (tile,
    pad, image size) for the stages after it; `pyr_up_metas` states a
    pyrUp's phase meta as the JAX planner does;
  * `gather_metas` — the gather stages' absolute origins (row step, row
    offset, column origin, column-origin step) and the check that each
    declared displacement bound covers the halo ring later stages read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .ir import GATHER_OPS, _affine_disp_over, _gather_halo, resolve_chain


class PlanOverBudget(ValueError):
    """A kernel plan that does not fit a block's shared memory even at its
    smallest tile: the mode cannot take this shape (full-width streaming
    rings, the narrowest tiled2d column tile, the smallest window tile).
    A `ValueError`, so `fused_chain` raises it from every mode; the serving
    engine and dispatcher move to their next rung on it."""

# ops whose body runs a row pass, then a column pass
SEPARABLE_OPS = frozenset({"sep_filter", "box", "erode", "dilate", "pyr_down"})
# the square kernel sizes stencil_stream runs as register strips, by op
# (csrc/stencil_stream.cu `run_strip`); a strip needs no row-pass scratch
STRIP_SIZES = {
    "filter2d": (3, 5, 7, 9, 11, 13),
    "sep_filter": (3, 5, 7, 9, 11, 13, 15),
    "erode": (3, 5, 7),
    "dilate": (3, 5, 7),
    "box": (3, 5, 7),
    "threshold": (1,),
    "affine": (1,),
}
# tile-width step of the tiled2d candidates: one warp of columns
LANE = 32
F32 = 4
# ring rows and ring starts are aligned to this many bytes, and each row has
# as many bytes of slack after it (csrc/stencil_stream.cu kAlign)
RING_ALIGN = 16
# an H100 SM: shared memory for all its resident blocks (228 KB), the part
# the system keeps for each of them, its threads and its registers
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
SM_THREADS = 2048
SM_REGS = 65_536
# registers a `stencil_stream` thread takes: the cap that its
# ``__launch_bounds__(256, 2)`` sets, which ptxas reaches (chip_smoke.py
# prints its report)
STREAM_REGS = SM_REGS // (2 * 256)


def blocks_per_sm(smem_bytes: int, threads: int, regs: int = STREAM_REGS) -> int:
    """Blocks of `threads` threads taking `smem_bytes` of shared memory each
    (static and dynamic) and `regs` registers a thread (a `stencil_stream`
    thread's by default) that one SM holds at once: the least of what its
    threads, its shared memory and its registers allow."""
    return min(SM_THREADS // threads, SM_SMEM // (smem_bytes + BLOCK_RESERVED),
               SM_REGS // (regs * threads))


# registers a `stencil_chain` thread may take: the cap of its
# ``__launch_bounds__(512, 2)`` (csrc/stencil_chain.cu kMaxThreads)
CHAIN_REGS = SM_REGS // (2 * 512)
# the block sizes `chain_threads` chooses from, widest first, and how much
# more than the least cost a narrower one may take
CHAIN_THREADS = (512, 256, 128)
CHAIN_COST_SLACK = 1.05


def chain_threads(n_blocks: int, smem_bytes: int, items: int, sms: int = 132) -> tuple:
    """Threads of a `stencil_chain` block, and the blocks an SM holds.  Each
    size of `CHAIN_THREADS` costs its waves of blocks (``n_blocks`` over
    ``sms`` times the blocks an SM holds) times the rounds of a block's
    largest pass (``items`` strips of 4 outputs over its threads); the
    narrowest size within `CHAIN_COST_SLACK` of the least cost wins (more
    blocks an SM hide one block's barriers).  So the 256 planes of a BoW
    request (one 32x32 tile each, 64x64 frames) take 512 threads, two
    blocks an SM: one wave with 32 warps an SM; the single ops and pyrUp on
    32x32 tiles of large images take 128 (measured on an H100, PERF.md
    §6)."""
    costs = []
    for t in CHAIN_THREADS:
        per_sm = blocks_per_sm(smem_bytes, t, CHAIN_REGS)
        if per_sm:
            costs.append((-(-n_blocks // (sms * per_sm)) * -(-items // t), t, per_sm))
    if not costs:
        raise ValueError(f"stencil_chain: {smem_bytes} bytes of shared memory a block exceed an SM")
    least = min(c for c, _t, _n in costs)
    _c, t, per_sm = min((c for c in costs if c[0] <= least * CHAIN_COST_SLACK), key=lambda c: c[1])
    return t, per_sm


# the most shared memory a block may take (static and dynamic) and still
# have a second one beside it on the SM
TWO_BLOCK_SMEM = SM_SMEM // 2 - BLOCK_RESERVED
# how much more column work (tiles recomputing their halo) a tiled2d plan
# may take to keep two blocks an SM rather than one
TWO_BLOCK_WORK = 1.5


def stage_taps(s) -> tuple[int, int]:
    """(kh, kw): a filter's own tap extents, odd or even (halo k // 2); for
    the other stencils 2 * halo + 1."""
    if s.op == "filter2d":
        return tuple(s.weights[0].shape)
    if s.op == "sep_filter":
        return len(s.weights[1]), len(s.weights[0])
    hy, hx = s.halo
    return 2 * hy + 1, 2 * hx + 1


def strip_stage(op: str, kh: int, kw: int) -> bool:
    """Does `stencil_stream` run this stage as a register strip?"""
    return kh == kw and kh in STRIP_SIZES.get(op, ())


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


def stage_out_hw(op: str | None, h: int, w: int) -> tuple[int, int]:
    """Output (h, w) of one stage applied to an (h, w) image: pyrDown is
    ceil-half (OpenCV), resize2 floor-half, pyrUp doubles, every other op
    keeps the size (JAX `plan.stage_out_hw`)."""
    if op == "pyr_down":
        return (h + 1) // 2, (w + 1) // 2
    if op == "resize2":
        return h // 2, w // 2
    if op == "pyr_up":
        return 2 * h, 2 * w
    return h, w


@dataclass(frozen=True)
class BandWalk:
    """The chain's bands, each with an id in order of creation (0 is the
    input): ``apps[k]`` lists stage k's applications ``(source ids,
    destination ids)``: one per band of a map, one for a tap, a Sobel's
    two destinations, the pair reduction's two sources.  ``outs[b]`` is
    the id of output band b; ``last_read[i]`` the last stage that reads
    band i (-1: none); ``meta[i]`` its ``(dtype, resolution ops)``, the
    strided and upsampling ops that made it or its sources, in order."""

    apps: tuple
    outs: tuple
    last_read: dict
    meta: dict


def band_walk(stages, carrier: torch.dtype = torch.float32) -> BandWalk:
    """Walk the chain's band arity: a map replaces every band, a tap
    appends one, a Sobel replaces the last band with an f32 pair and the
    pair reduction the last two with their magnitude in the carrier.  A
    band's resolution ops are the pyrDowns, resize2s and pyrUps that made
    it or its sources (JAX `_band_meta` names the op of a tapped band)."""
    ids, apps, last_read, meta = [0], [], {0: -1}, {0: (carrier, ())}
    for k, (op, mode, _h, stride, up, _n_in, _n_out, tap) in enumerate(resolve_chain(stages)):
        if mode == "map":
            groups = [((b,), 1) for b in ids]
        elif mode == "tap":
            groups = [((ids[tap],), 1)]
        elif mode == "emit":
            groups = [((ids[-1],), 2)]
        else:
            groups = [((ids[-2], ids[-1]), 1)]
        stage, news = [], []
        for srcs, n_dst in groups:
            dt, ops = meta[srcs[0]]
            dt = torch.float32 if mode == "emit" else carrier if mode == "reduce" else dt
            ops = ops + (op,) if stride != (1, 1) or up != (1, 1) else ops
            dsts = tuple(range(len(meta), len(meta) + n_dst))
            for d in dsts:
                last_read[d], meta[d] = -1, (dt, ops)
            for src in srcs:
                last_read[src] = k
            stage.append((srcs, dsts))
            news.extend(dsts)
        apps.append(tuple(stage))
        if mode == "map":
            ids = news
        elif mode == "tap":
            ids = ids + news
        elif mode == "emit":
            ids = ids[:-1] + news
        else:
            ids = ids[:-2] + news
    return BandWalk(tuple(apps), tuple(ids), last_read, meta)


def band_meta(stages, carrier: torch.dtype = torch.float32) -> list:
    """Per output band, ``(dtype, ops)``: the carrier, or f32 for a band of a
    Sobel pair; and the resolution ops that made it ("pyr_down", "resize2",
    "pyr_up"), in order, () for a band at the input's resolution."""
    walk = band_walk(stages, carrier)
    return [walk.meta[i] for i in walk.outs]


def band_hw(ops, h: int, w: int) -> tuple[int, int]:
    """(h, w) of a band made by resolution ops `ops` from an (h, w) input."""
    for op in ops:
        h, w = stage_out_hw(op, h, w)
    return h, w


def stride_product(stages) -> tuple[int, int]:
    """(row, col) stride product of the chain: the map strides times the
    largest tap stride (JAX `build_chain_geom`'s down_y, down_x)."""
    resolved = resolve_chain(stages)
    ny = nx = 1
    dy = dx = 1
    for _op, mode, _h, stride, *_rest in resolved:
        if mode == "map":
            ny, nx = ny * stride[0], nx * stride[1]
        else:
            dy, dx = max(dy, stride[0]), max(dx, stride[1])
    return ny * dy, nx * dx


def check_strides(down: tuple, rows: int, width: int, tile_w: int | None = None) -> None:
    """JAX's geometry errors for a chain of stride product `down`: it must
    divide the rows of a step, and a column tile narrower than the plane
    must be a multiple of its column part (tile seams land on image-even
    columns)."""
    down_y, down_x = down
    if rows % down_y:
        raise ValueError(
            f"chain stride product ({down_y}, {down_x}) must divide the band rows ({rows})"
        )
    if tile_w is not None and tile_w < width and tile_w % down_x:
        raise ValueError(
            f"fused_chain: tile_w={tile_w} must be divisible by the chain's column stride "
            f"product {down_x} (tile seams must land on image-aligned decimation coordinates)"
        )


def aligned_pad(pad: int, down: int) -> int:
    """A left pad rounded up to a multiple of the stride product, so that
    local-even columns are image-even ones (JAX's ``pw_l``)."""
    return pad + (-pad) % down


def gather_metas(stages, shape: tuple, rows: int, tile_w: int | None = None) -> list:
    """Per stage, the gather's ``(row step, row offset, column origin,
    column-origin step)`` meta, else None (JAX `build_chain_geom`'s forward
    walk, for `rows` rows a step and column tiles of `tile_w`): step i of
    tile t reads the stage's input rows from image row ``i*mult + off`` and
    columns from image column ``co0 + t*cstep``.  The kernels recover the
    same origins from their own geometry (the window's, or the stream's
    absolute rows).  Raises `ValueError` where a declared displacement
    bound undershoots what the chain evaluates, the image rectangle
    extended by the halo later stages read (outputs beyond it are slack
    the stores discard, so their clamped gathers need no budget), or where
    remap's map planes do not match the image."""
    resolved = resolve_chain(stages)
    H, W = shape
    h_fin = H
    for op, mode, *_rest in resolved:
        if mode == "map":
            h_fin = stage_out_hw(op, h_fin, 1)[0]
    iface = chain_iface(resolved, rows)
    n_bands = max(1, -(-h_fin // rows))
    down_x = stride_product(stages)[1]
    n_tiles = 1 if tile_w is None or tile_w >= W else -(-W // tile_w)
    # (row, col) halo still needed after each stage, at its output resolution
    needr = [0] * (len(resolved) + 1)
    needc = [0] * (len(resolved) + 1)
    for k in range(len(resolved) - 1, -1, -1):
        _op, mode, halo, stride, up, *_rest = resolved[k]
        r, c = needr[k + 1], needc[k + 1]
        if mode == "map":
            r = -(-r // up[0]) * stride[0]
            c = -(-c // up[1]) * stride[1]
        needr[k], needc[k] = halo[0] + r, halo[1] + c
    metas = []
    co = -aligned_pad(chain_accumulated_halo(stages)[1], down_x)
    cstep = tile_w if n_tiles > 1 else 0
    h_cur, w_cur = H, W
    for k, (op, mode, halo, stride, up, *_rest) in enumerate(resolved):
        mult_k, off_k, r_k = iface[k]
        if op not in GATHER_OPS:
            metas.append(None)
        else:
            metas.append((mult_k, off_k, co, cstep))
            hy, hx = halo
            cya, cxa = needr[k + 1], needc[k + 1]
            min_y = max(off_k + hy, -cya)
            max_y = min((n_bands - 1) * mult_k + off_k + r_k - hy - 1, h_cur - 1 + cya)
            min_x, max_x = -cxa, w_cur - 1 + cxa
            st = stages[k].static
            if op == "warp_affine":
                req_y, req_x = _affine_disp_over((st[0:3], st[3:6]), min_y, max_y, min_x, max_x)
            else:
                hw = tuple(stages[k].weights[1].shape)
                if hw != (h_cur, w_cur):
                    raise ValueError(
                        f"remap stage: map planes are {hw}, but the image at this stage is "
                        f"{(h_cur, w_cur)}"
                    )
                req_y = st[0] + max(0, -min_y, max_y - (h_cur - 1))
                req_x = st[1] + max(0, -min_x, max_x - (w_cur - 1))
            req_hy, req_hx = _gather_halo(req_y, req_x)
            if req_hy > hy or req_hx > hx:
                raise ValueError(
                    f"{op} stage: declared displacement bound gives halo ({hy}, {hx}) but the "
                    f"fused window evaluates outputs over rows [{min_y}, {max_y}] x cols "
                    f"[{min_x}, {max_x}], needing displacement ({req_y:.2f}, {req_x:.2f}) — "
                    "declare it via bound=/extend= (downstream stages consume the halo ring)"
                )
        if mode == "map":
            h_cur, w_cur = stage_out_hw(op, h_cur, w_cur)
            if stride[1] > 1:
                co, cstep = co // stride[1], cstep // stride[1]
            elif up[1] > 1:
                co, cstep = co * up[1], cstep * up[1]
    return metas


def check_gathers(stages, shape: tuple, rows: int, tile_w: int | None = None) -> None:
    """`gather_metas`'s checks, for a chain with a gather stage."""
    if any(s.op in GATHER_OPS for s in stages):
        gather_metas(stages, shape, rows, tile_w)


def kernel_walk(stages) -> list:
    """`resolve_chain` as the kernels plan it: a strided last stage (a map
    pyrDown or resize2, or a terminal tap of one) is planned at its input's
    resolution (stride 1), because the kernels decimate it as they store;
    every other strided or upsampling map stage changes the resolution of
    the stages after it (`chain_levels`)."""
    resolved = resolve_chain(stages)
    if resolved and resolved[-1][3] != (1, 1):
        op, mode, halo, _stride, *rest = resolved[-1]
        resolved[-1] = (op, mode, halo, (1, 1), *rest)
    return resolved


@dataclass(frozen=True)
class Levels:
    """The resolutions a kernel walks through a chain (`kernel_walk`).

    Level 0 is the input's; every strided or upsampling map stage but a
    strided last one starts a new level.  ``lv_in[k]`` / ``lv_out[k]``:
    the levels of stage k's input and output.  ``steps[l]``: the
    resolution changes from the input to level l, as ``(op, stride, up)``.
    ``need[k]``: the (rows, cols) around the tile that stage k's input
    must hold at its own level, so that every final band covers the tile:
    the backward walk ``n -> s*n + h`` through a stride s, ``ceil(n/u) +
    h`` through an upsample u, ``n + h`` otherwise (symmetric: a stride's
    window is one row shorter below, which costs one row of work).
    ``pads[l]``: the most any stage input of level l needs (the first
    one's), 0 for a level that only the last stage writes."""

    lv_in: tuple
    lv_out: tuple
    steps: tuple
    need: tuple
    pads: tuple

    @property
    def n_levels(self) -> int:
        return len(self.steps)

    def need_out(self, k: int) -> tuple:
        """(rows, cols) stage k's output must cover around the tile."""
        return self.need[k + 1] if k + 1 < len(self.need) else (0, 0)

    def size(self, level: int, h: int, w: int) -> tuple:
        """Image (h, w) at `level` for an (h, w) input (`stage_out_hw`)."""
        for op, _stride, _up in self.steps[level]:
            h, w = stage_out_hw(op, h, w)
        return h, w

    def tile(self, level: int, th: int, tw: int) -> tuple:
        """A (th, tw) input tile at `level`: divided by each stride (rounded
        up: exact for tiles that are multiples of the stride product, and
        covering for the one full-width tile), multiplied by each upsample."""
        for _op, (sy, sx), (uy, ux) in self.steps[level]:
            th, tw = -(-th // sy) * uy, -(-tw // sx) * ux
        return th, tw


def chain_levels(stages) -> Levels:
    """`Levels` of a chain of stages."""
    walk = kernel_walk(stages)
    steps, lv_in, lv_out = [()], [], []
    for op, mode, _halo, stride, up, *_rest in walk:
        lv_in.append(len(steps) - 1)
        if mode == "map" and (stride != (1, 1) or up != (1, 1)):
            steps.append(steps[-1] + ((op, tuple(stride), tuple(up)),))
        lv_out.append(len(steps) - 1)
    need = [(0, 0)] * len(walk)
    ny = nx = 0
    for k in range(len(walk) - 1, -1, -1):
        _op, mode, (hy, hx), (sy, sx), (uy, ux), *_rest = walk[k]
        if mode == "map":
            ny, nx = -(-ny // uy) * sy + hy, -(-nx // ux) * sx + hx
        else:
            ny, nx = ny + hy, nx + hx
        need[k] = (ny, nx)
    pads = [(0, 0)] * len(steps)
    for k in range(len(walk) - 1, -1, -1):
        pads[lv_in[k]] = need[k]
    return Levels(tuple(lv_in), tuple(lv_out), tuple(steps), tuple(need), tuple(pads))


def pyramid_plan(chains, shape, dtype=torch.float32, lc=None) -> list[dict]:
    """Per link of a pyramid (`driver.chained_launches`), what it launches:
    ``{"shape": (h, w)`` of its input planes, ``"halo"``: its chain's
    accumulated halo, ``"mode"``: the mode `driver.resolve_mode` gives it
    (every link launches; planes no larger than the halo take
    "window")``}`` (JAX `plan.pyramid_plan`, whose no-launch fallback links
    the port does not have).  Link k+1's input is link k's next base."""
    from ...core.device import DEFAULT
    from .driver import resolve_mode

    lc = DEFAULT if lc is None else lc
    h, w = int(shape[0]), int(shape[1])
    out = []
    for k, stages in enumerate(chains):
        stages = tuple(stages)
        out.append({"shape": (h, w), "halo": chain_accumulated_halo(stages),
                     "mode": resolve_mode(stages, (1, h, w), dtype, lc)})
        if k < len(chains) - 1:
            hc, wc = h, w
            for op, mode, *_rest in resolve_chain(stages):
                if mode == "map":
                    hc, wc = stage_out_hw(op, hc, wc)
            h, w = stage_out_hw(stages[-1].op, hc, wc)
    return out


def pyr_up_metas(stages, rows: int) -> list:
    """Per stage, a pyrUp's ``(p2, r_out)`` phase meta for `rows` rows a
    step, else None (JAX `build_chain_geom`): the window kernel's pyrUp
    output starts ``p2`` rows into the interleaved phases of its input
    (``p2 = off_o - 2*off_k - 2``, the parity of the output origin) and
    keeps ``r_out`` rows.  The kernels compute the phase of each output
    row from its absolute image row instead; this is the planner's
    statement of the same geometry."""
    walk = resolve_chain(stages)
    iface = chain_iface(walk, rows)
    out = []
    for k, (op, *_rest) in enumerate(walk):
        if op == "pyr_up":
            _, off_o, r_o = iface[k + 1]
            out.append((off_o - 2 * iface[k][1] - 2, r_o))
        else:
            out.append(None)
    return out


def chain_halo(stages) -> tuple[int, int]:
    """Accumulated (row, col) halo of the whole chain (alias kept for the
    JAX package's name)."""
    return chain_accumulated_halo(stages)


def chain_iface(plan, rows: int) -> list:
    """Exact backward row walk in image coordinates: ``iface[k] = (mult,
    off, r)`` means step i consumes image rows ``[i*mult + off, i*mult +
    off + r)`` at stage k's input resolution; ``iface[-1]`` is the final
    output band of `rows` rows.  `plan` is a `resolve_chain` record list."""
    iface = [(rows, 0, rows)]
    for op, mode, halo, stride, up, _, _, _ in reversed(plan):
        mult, off, r = iface[0]
        h = halo[0]
        if mode == "map" and up[0] > 1:
            if mult % up[0]:
                raise ValueError(
                    f"chain upsample {op!r}: band step {mult} is not divisible by {up[0]}"
                )
            off2 = off // up[0] - h
            end2 = (off + r - 1) // up[0] + h + 1
            iface.insert(0, (mult // up[0], off2, end2 - off2))
        elif mode == "map":
            s = stride[0]
            iface.insert(0, (mult * s, s * off - h, s * r + 2 * h))
        else:
            iface.insert(0, (mult, off - h, r + 2 * h))
    return iface


def chain_stream_plan(plan, iface) -> list:
    """Streaming carry plan: per stage ``(sin_off, sin_r, ring_rows,
    d_rows)``.  Stage k's body input at step i is rows ``[i*mult_k +
    sin_off, ... + sin_r)``, of which its ring carries the first
    ``ring_rows`` (= 2*halo) and the upstream stage's current step supplies
    the last ``mult_k``; ``d_rows`` (= the stage halo) is how far the
    pass-through bands of a tap stage lag, so the band state stays
    row-aligned."""
    out = []
    for k, (op, mode, halo, stride, up, n_in, n_out, tap) in enumerate(plan):
        mult_k, off_k, r_k = iface[k]
        mult_o, off_o, r_o = iface[k + 1]
        top_o = off_o + r_o
        h = halo[0]
        if mode == "map" and up[0] > 1:
            sin_off = (top_o - mult_o) // up[0] - h
            sin_r = (top_o - 1) // up[0] + h + 1 - sin_off
        elif mode == "map":
            s = stride[0]
            sin_off = s * (top_o - mult_o) - h
            sin_r = s * mult_o + 2 * h
        else:
            sin_off = (top_o - mult_o) - h
            sin_r = mult_o + 2 * h
        ring_rows = sin_r - mult_k
        if sin_off + sin_r != off_k + r_k or not 0 <= ring_rows <= r_k:
            raise AssertionError(
                f"chain_stream_plan: stage {k} ({op}) carry window "
                f"[{sin_off}, {sin_off + sin_r}) misaligned with window "
                f"interface [{off_k}, {off_k + r_k})"
            )
        out.append((sin_off, sin_r, ring_rows, h if mode != "map" else 0))
    return out


@dataclass(frozen=True)
class StreamLayout:
    """The rings of one `stencil_stream` block.

    A stream is the rows of one band after one stage (stream 0 is the
    input), at that stage's level (`chain_levels`).  At step i it holds
    its newest rows up to ``Y0 + (i+1)*mult + lead``, where ``mult`` is
    the rows a step adds at its level (``rows`` at the last level, twice
    that above a stride, half below an upsample) and ``Y0`` the segment's
    first row at its level; ``depth`` rows of it are kept in a ring
    indexed by the absolute row modulo the depth.  A stream's depth is
    ``mult`` plus the most any reader lags behind its newest row: a
    stage's ring of ``2*halo`` rows (``2*halo + 1`` below an odd-phase
    upsample), plus the delay of every tap stage it passes through on the
    way, plus, for an output band, its lead over the stored rows.  ``lead``
    is also how far above ``Y0`` the stream's rows start: a segment primes
    each ring from that row on.  A final band with lead 0 that nothing
    else reads has depth 0: it is stored from registers.  A launch that
    loads stream 0 a step ahead gives it ``mults[0]`` more rows.

    ``apps`` lists one record per stage application in launch order:
    ``(stage index, source streams, destination streams)``: one source and
    one destination, but two destinations for a Sobel (its dx and dy) and
    two sources for the pair reduction.  ``outs[b]`` is the stream of
    output band b.  ``esizes[s]`` is the bytes of one value of stream s's
    ring: 1 for a u8 band (the input of a u8 chain, every packed result),
    4 for an f32 one.  Columns: every stream of a level shares its frame,
    the level's tile width plus ``col_pads[level]`` per side: the need of
    the level's stages, rounded up to 4 columns (level 0: the accumulated
    halo, aligned to the stride product and rounded up to 16 bytes of the
    input, so that a row's copy from device memory aligns).  ``strips[k]``
    says whether stage k runs a register strip (`strip_stage`); the others
    of ``SEPARABLE_OPS`` and pyrUp need row-pass scratch, listed in
    ``scratch`` as ``(rows, level of its row width)``; ``scratch_rows`` is
    the most rows of them.  ``rd0`` is the last application that reads
    stream 0 (``len(apps)`` when stream 0 is an output band, which the
    stores read).
    """

    rows: int
    halo: tuple
    leads: tuple
    depths: tuple
    apps: tuple
    outs: tuple
    scratch_rows: int
    mults: tuple = ()
    levels: tuple = ()
    col_pads: tuple = ()
    scratch: tuple = ()
    lv: Levels | None = None
    esizes: tuple = ()
    strips: tuple = ()
    rd0: int = 0
    # (tile width, ahead) -> bytes: the tiled2d planner asks for every
    # candidate width on every call
    _memo: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def smem_rows(self) -> int:
        """Ring and scratch rows (without stream 0's rows loaded ahead)."""
        return sum(self.depths) + self.scratch_rows

    @property
    def prime_steps(self) -> int:
        """Steps a segment runs before its first output rows: each ring must
        start at its lead above the segment, ``2*lead`` below its newest
        row at step 0."""
        return max(-(-2 * ld // m) for ld, m in zip(self.leads, self.mults))

    def width(self, level: int, tile_w: int) -> int:
        """Columns of a level's frame for an input column tile of `tile_w`."""
        return self.lv.tile(level, 1, tile_w)[1] + 2 * self.col_pads[level]

    def row_bytes(self, stream: int, tile_w: int) -> int:
        """A ring row of `stream`: its frame's values, rounded up to
        `RING_ALIGN` bytes, and `RING_ALIGN` bytes of slack."""
        row = self.width(self.levels[stream], tile_w) * self.esizes[stream]
        return -(-row // RING_ALIGN) * RING_ALIGN + RING_ALIGN

    def smem_bytes(self, tile_w: int, ahead: bool = False) -> int:
        """Shared memory of the rings and scratch for one column tile: the
        slack before the first ring, each ring's depth (stream 0's with
        its rows loaded ahead, if `ahead`) times its row bytes, then the
        f32 scratch."""
        key = (tile_w, ahead)
        hit = self._memo.get(key)
        if hit is None:
            rings = RING_ALIGN + sum(
                (d + (self.mults[0] if ahead and s == 0 else 0)) * self.row_bytes(s, tile_w)
                for s, d in enumerate(self.depths))
            scratch = max([r * self.width(lv, tile_w) * F32 for r, lv in self.scratch], default=0)
            hit = self._memo[key] = rings + scratch
        return hit


def stream_layout(stages, rows: int, carrier: torch.dtype = torch.float32) -> StreamLayout:
    """Plan the streams, their leads, ring depths and dtypes for `rows` per
    step at the last level (a strided last stage planned at its input's
    resolution, `kernel_walk`), for input planes of `carrier`.  The column
    pad of level 0 is aligned to the column stride product and to 16 bytes
    of the input."""
    walk = kernel_walk(stages)
    lv = chain_levels(stages)
    iface = chain_iface(walk, rows)
    sp = chain_stream_plan(walk, iface)
    bw = band_walk(stages, carrier)

    def lead_of(k):  # the newest row's offset above a step's last one
        mult, off, r = iface[k]
        return off + r - mult

    leads, mults, levels = [lead_of(0)], [iface[0][0]], [0]
    lags = [0]
    op_read = [False]
    apps = []
    rd0 = -1
    for k, stage in enumerate(bw.apps):
        sin_off = sp[k][0]
        for srcs, dsts in stage:
            for src in srcs:
                # the reader's oldest row at step i is Y0 + i*mult + sin_off
                lags[src] = max(lags[src], leads[src] - sin_off)
                op_read[src] = True
            if 0 in srcs:
                rd0 = len(apps)
            leads.extend([lead_of(k + 1)] * len(dsts))
            mults.extend([iface[k + 1][0]] * len(dsts))
            levels.extend([lv.lv_out[k]] * len(dsts))
            lags.extend([0] * len(dsts))
            op_read.extend([False] * len(dsts))
            apps.append((k, srcs, dsts))
    bands = bw.outs
    if 0 in bands:
        rd0 = len(apps)
    depths = []
    for s, (lead, lag) in enumerate(zip(leads, lags)):
        if s in bands:
            lag = max(lag, lead)  # the store reads rows y0 + i*rows on
        direct = s in bands and s != 0 and lead == 0 and not op_read[s]
        depths.append(0 if direct else mults[s] + lag)
    esizes = tuple(1 if bw.meta[s][0] == torch.uint8 else F32 for s in range(len(depths)))
    strips, scratch = [], []
    for k, (st, (op, _mode, (hy, hx), _stride, _up, *_rest)) in enumerate(zip(stages, walk)):
        mult_o, li, lo = iface[k + 1][0], lv.lv_in[k], lv.lv_out[k]
        strips.append(li == lo and strip_stage(op, *stage_taps(st)))
        if op == "pyr_up":
            scratch.append((mult_o, li))
        elif op in SEPARABLE_OPS and li != lo:
            scratch.append((2 * (mult_o - 1) + 2 * hy + 1, lo))
        elif op in SEPARABLE_OPS and not strips[-1]:
            scratch.append((mult_o + 2 * hy, li))
    ph, pw = chain_accumulated_halo(stages)
    halo = (ph, aligned_pad(pw, stride_product(stages)[1]))
    vals = RING_ALIGN // esizes[0]
    col_pads = (-(-halo[1] // vals) * vals,) + tuple(-(-p[1] // 4) * 4 for p in lv.pads[1:])
    return StreamLayout(
        rows, halo, tuple(leads), tuple(depths), tuple(apps), tuple(bands),
        max([r for r, _ in scratch], default=0), tuple(mults), tuple(levels), col_pads,
        tuple(scratch), lv, esizes, tuple(strips), rd0,
    )


def _tile_candidates(width: int, lane: int = LANE, down: int = 1) -> list[int]:
    """Tile-width candidates: the full width (one tile, the streaming
    geometry) plus every lane multiple below it that the column stride
    product divides."""
    cands = [width]
    tw = lane
    while tw < width:
        if tw % down == 0:
            cands.append(tw)
        tw += lane
    return cands


def pick_tile_plan(
    layout: StreamLayout, width: int, budget: int, fixed: int, down: int = 1
) -> int | None:
    """Tile width of the tiled2d plan: among the candidates whose rings fit,
    the least padded column work (``n_tiles * (tile + 2*pw)``: each tile
    recomputes its column halo), then the wider tile.  None means one
    full-width tile.  `down`: the column stride product, which a tile
    narrower than the plane must be a multiple of."""
    pw = layout.halo[1]
    best = None
    for cand in _tile_candidates(width, down=down):
        if layout.smem_bytes(cand) + fixed > budget:
            continue
        n_tiles = -(-width // cand)
        key = (-n_tiles * (cand + 2 * pw), cand)
        if best is None or key > best[0]:
            best = (key, cand)
    if best is None:
        narrow = min(LANE, width)
        raise PlanOverBudget(
            f"stencil_stream: a {narrow}-column tile needs {layout.smem_bytes(narrow) + fixed} "
            f"bytes of shared memory, over the budget of {budget}"
        )
    return None if best[1] >= width else best[1]


def pick_stream_tile(layout: StreamLayout, width: int, budget: int, fixed: int,
                     down: int = 1) -> int | None:
    """The tiled2d tile `stencil_stream` takes: `pick_tile_plan`'s under
    `TWO_BLOCK_SMEM` (two blocks an SM), unless that tile's column work
    exceeds `TWO_BLOCK_WORK` times the work of the tile that fits `budget`
    (one block an SM: a chain with a wide halo, whose narrow tiles would
    mostly recompute it), then that one."""
    one = pick_tile_plan(layout, width, budget, fixed, down)
    try:
        two = pick_tile_plan(layout, width, min(budget, TWO_BLOCK_SMEM), fixed, down)
    except ValueError:
        return one

    def work(tile):
        tile = width if tile is None else tile
        return -(-width // tile) * (tile + 2 * layout.halo[1])

    return two if work(two) <= TWO_BLOCK_WORK * work(one) else one


def row_segments(n_planes: int, n_tiles: int, height: int, rows: int, sms: int,
                 per_sm: int = 2, prime: int = 0) -> tuple[int, int]:
    """(segments per plane, rows per segment) of a `stencil_stream` launch.

    One block per (plane, tile) leaves most SMs idle on a single large
    plane, so each plane's rows are cut into segments of whole steps, each
    priming its own rings from the real rows above it.  The rule: aim for
    `per_sm` blocks per SM (the blocks one SM holds at once, up to 4;
    `blocks_per_sm`), with at least two steps (``2*rows`` rows) a segment,
    or one step where two-step segments give fewer than two blocks an SM
    and the chain primes in at most two steps (`prime`,
    `StreamLayout.prime_steps`).  `height` and `rows` are at the chain's
    last level.  Priming costs a segment about ``2*halo`` extra rows of its
    first stage (fewer for each later one); on the H100 the parallelism is
    worth more than that even for the octave's 34-row halo (PERF.md §6)."""
    blocks = max(1, n_planes * n_tiles)
    want = -(-per_sm * sms // blocks)
    cap = max(1, height // (2 * rows))
    if cap * blocks < 2 * sms and prime <= 2:
        cap = max(1, height // rows)
    return fix_segments(max(1, min(want, cap)), height, rows)


def fix_segments(n: int, height: int, rows: int) -> tuple[int, int]:
    """About `n` segments of whole steps: (segments, rows per segment), the
    rows per segment a multiple of `rows`, the count nearest `n` (ties to
    fewer segments).  Every segment starts on a multiple of `rows`, which
    `check_strides` makes even for a pyrDown chain, so each segment's
    decimation stays on image-even rows."""
    per_seg = -(-height // max(1, n))
    lo = max(rows, per_seg // rows * rows)
    hi = -(-per_seg // rows) * rows
    options = [(abs(-(-height // r) - n), -r) for r in (lo, hi)]
    seg_rows = -min(options)[1]
    return -(-height // seg_rows), seg_rows
