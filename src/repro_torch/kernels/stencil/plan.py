"""Chain geometry: the counterpart of `repro.kernels.stencil.plan`, reduced
to what the port's two kernels need.

  * `chain_accumulated_halo` — the halo the input is padded by;
  * `chain_iface` / `chain_stream_plan` — the exact backward row walk and
    the streaming carry plan, as the JAX planner computes them;
  * `stream_layout` — the rings of one `stencil_stream` block: which
    stream each stage reads and writes, how many rows each ring keeps,
    and the row-pass scratch;
  * `pick_tile_plan` — the tiled2d column-tile width, charging one tile's
    rings against `LaunchConfig.smem_budget` (the JAX planner's
    `pick_tile_plan` / `pick_tile_w` charge a working set against VMEM);
  * `row_segments` — how many row segments of a plane run as blocks of
    their own;
  * `stage_out_hw`, `band_downs`, `stride_product`, `check_strides` and
    `aligned_pad` — the geometry of a strided stage (the JAX planner's
    `build_chain_geom`): each band's own decimation and output size, the
    stride product that step rows and column tiles must be multiples of,
    and a left pad that puts local-even columns on image-even ones.

The kernels run a strided stage only as the chain's last stage (a map
pyrDown, or the octave's terminal next-base tap): they compute it at full
resolution and keep its image-even rows and columns as they store them,
so they plan its rows as those of a stride-1 stage (`kernel_walk`).
"""

from __future__ import annotations

from dataclasses import dataclass

from .ir import STRIDES, resolve_chain

# ops whose body runs a row pass into scratch, then a column pass
SEPARABLE_OPS = frozenset({"sep_filter", "box", "erode", "dilate", "pyr_down"})
# tile-width step of the tiled2d candidates: one warp of columns
LANE = 32
F32 = 4


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


def _band_sources(resolved) -> list:
    """Per final band, the op of the tap that made it, or None for a band
    at the state's resolution."""
    bands = [None]
    for op, mode, *_rest in resolved:
        if mode == "tap":
            bands.append(op)
    return bands


def band_downs(stages) -> list:
    """Per output band, its decimation against the input: 2 for a band a
    pyrDown made (its size is `stage_out_hw("pyr_down", H, W)`), else 1."""
    resolved = resolve_chain(stages)
    ny = 1
    for _op, mode, _h, stride, *_rest in resolved:
        if mode == "map":
            ny *= stride[0]
    divs = [STRIDES.get(src, (1, 1))[0] for src in _band_sources(resolved)]
    return [ny * d for d in divs]


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


def kernel_walk(stages) -> list:
    """`resolve_chain` as the kernels plan it: a strided stage must be the
    last one (else `NotImplementedError`), and its rows are planned at full
    resolution (stride 1); the kernels decimate as they store."""
    resolved = resolve_chain(stages)
    for k, (op, mode, halo, stride, *rest) in enumerate(resolved):
        if stride != (1, 1) and k != len(resolved) - 1:
            raise NotImplementedError(
                f"stencil kernels: a strided {op!r} stage before the chain's last is not ported yet"
            )
    return [(op, mode, halo, (1, 1), *rest) for op, mode, halo, _stride, *rest in resolved]


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
    input).  At step i it holds its newest rows up to
    ``y0 + (i+1)*rows + lead``; ``depth`` rows of it are kept in a ring
    indexed by the absolute row modulo the depth.  A stream's depth is
    ``rows`` plus the most any reader lags behind its newest row: a
    stage's ring of ``2*halo`` rows, plus the delay (``d_rows``) of every
    tap stage it passes through on the way, plus, for an output band, its
    lead over the stored rows.  A final band with lead 0 that nothing
    else reads has depth 0: it is stored from registers.

    ``apps`` lists one record per stage application in launch order:
    ``(stage index, source stream, destination stream)``.
    ``outs[b]`` is the stream of output band b.
    """

    rows: int
    halo: tuple
    leads: tuple
    depths: tuple
    apps: tuple
    outs: tuple
    scratch_rows: int

    @property
    def smem_rows(self) -> int:
        return sum(self.depths) + self.scratch_rows

    def smem_bytes(self, tile_w: int) -> int:
        """Shared memory of the rings and scratch for one column tile."""
        return self.smem_rows * (tile_w + 2 * self.halo[1]) * F32


def stream_layout(stages, rows: int) -> StreamLayout:
    """Plan the streams, their leads and ring depths for `rows` per step
    (a strided last stage planned at full resolution, `kernel_walk`).  The
    column pad is aligned to the column stride product."""
    plan = kernel_walk(stages)
    iface = chain_iface(plan, rows)
    sp = chain_stream_plan(plan, iface)
    leads = [-iface[0][1]]
    lags = [0]
    op_read = [False]
    bands = [0]
    apps = []
    for k, (op, mode, halo, *_rest, tap) in enumerate(plan):
        sin_off = sp[k][0]
        lead_out = -iface[k + 1][1]
        news = []
        for src in bands if mode == "map" else [bands[tap]]:
            # the reader's oldest row at step i is y0 + i*rows + sin_off
            lags[src] = max(lags[src], leads[src] - sin_off)
            op_read[src] = True
            dst = len(leads)
            leads.append(lead_out)
            lags.append(0)
            op_read.append(False)
            apps.append((k, src, dst))
            news.append(dst)
        bands = news if mode == "map" else bands + news
    depths = []
    for s, (lead, lag) in enumerate(zip(leads, lags)):
        if s in bands:
            lag = max(lag, lead)  # the store reads rows y0 + i*rows on
        direct = s in bands and s != 0 and lead == 0 and not op_read[s]
        depths.append(0 if direct else rows + lag)
    sep_halo = [halo[0] for op, _, halo, *_ in plan if op in SEPARABLE_OPS]
    scratch = rows + 2 * max(sep_halo) if sep_halo else 0
    ph, pw = chain_accumulated_halo(stages)
    halo = (ph, aligned_pad(pw, stride_product(stages)[1]))
    return StreamLayout(
        rows, halo, tuple(leads), tuple(depths), tuple(apps), tuple(bands), scratch,
    )


def _tile_candidates(width: int, lane: int = LANE) -> list[int]:
    """Tile-width candidates: the full width (one tile, the streaming
    geometry) plus every lane multiple below it."""
    cands = [width]
    tw = lane
    while tw < width:
        cands.append(tw)
        tw += lane
    return cands


def pick_tile_plan(layout: StreamLayout, width: int, budget: int, fixed: int) -> int | None:
    """Tile width of the tiled2d plan: among the candidates whose rings fit,
    the least padded column work (``n_tiles * (tile + 2*pw)``: each tile
    recomputes its column halo), then the wider tile.  None means one
    full-width tile."""
    pw = layout.halo[1]
    best = None
    for cand in _tile_candidates(width):
        if layout.smem_bytes(cand) + fixed > budget:
            continue
        n_tiles = -(-width // cand)
        key = (-n_tiles * (cand + 2 * pw), cand)
        if best is None or key > best[0]:
            best = (key, cand)
    if best is None:
        narrow = min(LANE, width)
        raise ValueError(
            f"stencil_stream: a {narrow}-column tile needs {layout.smem_bytes(narrow) + fixed} "
            f"bytes of shared memory, over the budget of {budget}"
        )
    return None if best[1] >= width else best[1]


def row_segments(n_planes: int, n_tiles: int, height: int, rows: int, sms: int) -> tuple[int, int]:
    """(segments per plane, rows per segment) of a `stencil_stream` launch.

    One block per (plane, tile) leaves most SMs idle on a single large
    plane, so each plane's rows are cut into segments of whole steps, each
    priming its own rings from the real rows above it.  The rule: aim for
    two blocks per SM, with at least two steps (``2*rows`` rows) a segment.
    Priming costs a segment about ``2*halo`` extra rows of its first stage
    (fewer for each later one); on the H100 the parallelism is worth more
    than that even for the octave's 34-row halo (PERF.md §6)."""
    want = -(-2 * sms // max(1, n_planes * n_tiles))
    cap = max(1, height // (2 * rows))
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
