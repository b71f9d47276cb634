"""The port's fused stencil chain against the JAX package's `chain_ref` oracle.

The JAX side runs `repro.kernels.ref.chain_ref` (its Pallas stencil plans
do not lower on every jax release; the oracle always runs).  The port runs
`fused_chain` on the CPU, which is the `stencil_chain` kernel's plain
version.  Tolerance: the repo's f32 oracle tolerance, rtol 2e-5 and atol
2e-3 (tests/test_pyramid.py), because XLA may contract a multiply and add
into one FMA where PyTorch rounds twice.

`_emulate_kernel` replays the CUDA kernel's block loop in numpy from the
step table `exec_window.compile_chain` plans (window load with clamped
reads, shared-memory slots, per-step regions, stores), so the planner and
the kernel's indexing are checked here without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.cv import features as jfeatures
from repro.kernels import ref as jref
from repro.kernels import stencil as jstencil

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features as tfeatures
from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import exec_streaming, exec_window

RTOL, ATOL = 2e-5, 2e-3


def _preprocess(pkg):
    return (pkg.gaussian_stage(5), pkg.erode_stage(1), pkg.grad_stage())


def _level_chains(pkg):
    """Chains that change resolution before their last stage, or upsample."""
    return {
        "pyr_up": (pkg.pyr_up_stage(),),
        "down_up": (pkg.pyr_down_stage(), pkg.pyr_up_stage()),
        "gauss_down_erode": (pkg.gaussian_stage(5), pkg.pyr_down_stage(), pkg.erode_stage(1)),
        "resize_gauss": (pkg.resize2_stage(), pkg.gaussian_stage(3)),
        "up_gauss": (pkg.pyr_up_stage(), pkg.gaussian_stage(3)),
        "up_gauss_down_tap": (pkg.pyr_up_stage(), pkg.gaussian_stage(3),
                              pkg.pyr_down_stage(tap=0)),
        "down_sobel_grad": (pkg.pyr_down_stage(), pkg.sobel_stage(), pkg.grad_stage()),
    }


def _chains():
    """(name, JAX chain, port chain) for the BoW path's two chains, the
    octave with its next base, the lone pyrDown as a map stage, and the
    chains of `_level_chains`."""
    jo = jfeatures.octave_chain(4, with_next_base=False)
    to = tfeatures.octave_chain(4, with_next_base=False)
    jl, tl = _level_chains(jstencil), _level_chains(tstencil)
    return {
        "preprocess": (_preprocess(jstencil), _preprocess(tstencil)),
        "octave": (jo, to),
        "octave_nb": (jfeatures.octave_chain(4), tfeatures.octave_chain(4)),
        "pyr_down": ((jstencil.pyr_down_stage(),), (tstencil.pyr_down_stage(),)),
        **{k: (jl[k], tl[k]) for k in tl},
    }


CASES = [
    ("preprocess", (2, 40, 48, 3)),
    ("octave", (3, 48, 56)),
    ("octave", (2, 32, 32)),  # planes no larger than the octave's halo of 34
    ("octave_nb", (2, 45, 39)),  # odd sizes, two tiles each way
    ("octave_nb", (1, 35, 33)),  # planes no larger than the next base's halo of 36
    ("pyr_down", (2, 37, 53)),
    ("pyr_up", (2, 19, 23)),  # 38x46 out: two 16-row tiles of 32x32 output each way
    ("down_up", (1, 45, 39)),
    ("gauss_down_erode", (2, 45, 39)),
    ("resize_gauss", (1, 37, 53)),
    ("up_gauss", (1, 21, 35)),
    ("up_gauss_down_tap", (1, 23, 19)),
    ("down_sobel_grad", (1, 37, 29)),
]


def _input(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) * 255.0


def _jax_planes(chain, x):
    """JAX chain_ref over (N, H, W) planes, one (H, W) plane at a time."""
    outs = [jref.chain_ref(jnp.asarray(p), chain) for p in x]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(len(outs[0]))]


@pytest.mark.parametrize("name,shape", CASES)
def test_fused_chain_matches_jax_chain_ref(name, shape):
    jc, tc = _chains()[name]
    x = _input(shape)
    if len(shape) == 4:
        want = jref.chain_ref(jnp.asarray(x), jc)
    else:  # (N, H, W) gray planes: the octave runs them as (B, H, W, 1)
        want = tuple(_jax_planes(jc, x))
    xt = torch.from_numpy(x)
    got = tstencil.fused_chain(xt[..., None] if len(shape) == 3 else xt, tc)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()[..., 0] if len(shape) == 3 else g.numpy()
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["hw", "hwc", "bhwc"])
def test_chain_ref_layouts_match_jax(layout):
    jc, tc = _chains()["preprocess"]
    shape = {"hw": (20, 24), "hwc": (20, 24, 3), "bhwc": (2, 20, 24, 3)}[layout]
    x = _input(shape, seed=1)
    want = np.asarray(jref.chain_ref(jnp.asarray(x), jc))
    got = tref.chain_ref(torch.from_numpy(x), tc).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mode_ref_and_window_agree_on_cpu():
    _, tc = _chains()["octave"]
    x = torch.from_numpy(_input((2, 24, 20, 1), seed=2))
    a = tstencil.fused_chain(x, tc, mode="ref")
    b = tstencil.fused_chain(x, tc, mode="window")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tstencil.fused_chain(torch.zeros((8, 8)), (tstencil.erode_stage(1),), mode="bogus")


def test_cpu_dispatch_counts_plain_calls_only():
    """8x8 planes under the preprocess chain's 4-row halo resolve to the
    streaming kernel; its plain version runs once and nothing launches."""
    _, tc = _chains()["preprocess"]
    counters.reset()
    tstencil.fused_chain(torch.zeros((2, 8, 8, 3)), tc)
    assert counters.PLAIN_CALLS["stencil_stream"] == 1
    assert counters.PLAIN_CALLS["stencil_chain"] == 0
    assert sum(counters.LAUNCHES.values()) == 0
    counters.LAUNCHES["stencil_chain"] = 3
    counters.reset()
    assert counters.LAUNCHES["stencil_chain"] == counters.PLAIN_CALLS["stencil_chain"] == 0


def test_accumulated_halo_matches_jax():
    for (jc, tc) in _chains().values():
        assert tstencil.chain_accumulated_halo(tc) == jstencil.chain_accumulated_halo(jc)
    assert tstencil.chain_halo(_chains()["octave"][1]) == (34, 34)
    assert tstencil.chain_halo(_chains()["octave_nb"][1]) == (36, 36)


def test_resolve_chain_matches_jax():
    for (jc, tc) in _chains().values():
        want = [(op, mode, halo, n_in, n_out, tap)
                for op, mode, halo, _, _, n_in, n_out, tap in jstencil.resolve_chain(jc)]
        got = [(op, mode, halo, n_in, n_out, tap)
               for op, mode, halo, _, _, n_in, n_out, tap in tstencil.resolve_chain(tc)]
        assert got == want


def test_gaussian_kernel_matches_jax():
    for k in (5, 7, 11, 15):
        np.testing.assert_allclose(tref.gaussian_kernel1d(k).numpy(),
                                   np.asarray(jref.gaussian_kernel1d(k)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["resize2", "resize2_stream", "pyr_up"])
def test_unported_stage_ops_raise(case):
    """What the kernels once refused now plans: a strided stage before the
    chain's last (resize2 here) compiles for both kernels into two levels,
    and pyrUp is a stage of its own; the plain version of each equals
    JAX's `chain_ref`.  What is still refused is JAX's refusal: pyrUp as a
    tap."""
    if case == "pyr_up":
        assert tstencil.Stage("pyr_up").upsample == (2, 2)
        with pytest.raises(ValueError, match="tap"):
            tstencil.resolve_chain((tstencil.gaussian_stage(3), tstencil.Stage("pyr_up", tap=0)))
        chain = (tstencil.pyr_up_stage(), tstencil.gaussian_stage(3))
        jchain = (jstencil.pyr_up_stage(), jstencil.gaussian_stage(3))
    else:
        chain = (tstencil.resize2_stage(), tstencil.gaussian_stage(3))
        jchain = (jstencil.resize2_stage(), jstencil.gaussian_stage(3))
    compile_ = (exec_window.compile_chain if case == "resize2"
                else lambda c: exec_streaming.compile_stream(c, 8))
    prog = compile_(chain)
    assert [st["lo"] for st in prog.steps] == [1, 1]
    x = torch.from_numpy(_input((12, 10)))
    got = tstencil.fused_chain(x, chain, mode="ref")
    want = jref.chain_ref(jnp.asarray(x.numpy()), jchain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_grad_pair_reduction_not_ported():
    """The grad_mag pair reduction (the name dates from before it was
    ported): over two live bands it reduces the last two to their
    magnitude, in the plain version and in both kernels' step tables, equal
    to JAX's `chain_ref` on u8 and f32."""
    chain = (tstencil.gaussian_stage(3), tstencil.gaussian_stage(3, tap=-1), tstencil.grad_stage())
    jchain = (jstencil.gaussian_stage(3), jstencil.gaussian_stage(3, tap=-1), jstencil.grad_stage())
    assert tstencil.resolve_chain(chain)[-1][1] == "reduce"
    prog = exec_window.compile_chain(chain)
    assert prog.steps[-1]["op"] == exec_window.GRAD_PAIR and prog.n_bands == 1
    assert exec_streaming.compile_stream(chain, 8).steps[-1]["op"] == exec_window.GRAD_PAIR
    rng = np.random.default_rng(9)
    for x in (rng.integers(0, 256, (2, 19, 23, 2), dtype=np.uint8), _input((2, 19, 23, 2))):
        want = np.asarray(jref.chain_ref(jnp.asarray(x), jchain))
        for mode in (None, "window", "streaming", "tiled2d"):
            got = tstencil.fused_chain(torch.from_numpy(x), chain, mode=mode).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            if x.dtype == np.uint8:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The kernel's block loop, replayed in numpy from the planned step table
# ---------------------------------------------------------------------------

F32 = np.float32


def _pack(v, pk):
    return np.clip(np.rint(v), 0, 255).astype(F32) if pk else np.asarray(v, F32)


def _bilinear(X, sy, sx, oy, ox, rlo, rhi, clo, chi):
    """`bilinear_at` of csrc/stencil_ops.cuh on a numpy band X whose local
    (row, col) sits at image (row + oy, col + ox); taps clamped into [rlo,
    rhi - 2] x [clo, chi - 2] (local)."""
    iy, ix = np.floor(sy), np.floor(sx)
    fy, fx = (sy - iy).astype(F32), (sx - ix).astype(F32)
    ly = np.clip(iy.astype(np.int64) - oy, rlo, rhi - 2)
    lx = np.clip(ix.astype(np.int64) - ox, clo, chi - 2)
    v00, v01, v10, v11 = X[ly, lx], X[ly, lx + 1], X[ly + 1, lx], X[ly + 1, lx + 1]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _gather_coords(op, w0, maps, wx, yy, xx, H, W):
    """Source (sy, sx) of a gather step at integer image coordinates."""
    if op == 13:
        yf, xf = yy.astype(F32), xx.astype(F32)
        return (xf * w0[3] + yf * w0[4]) + w0[5], (xf * w0[0] + yf * w0[1]) + w0[2]
    mx, my = maps[wx]
    yc, xc = np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)
    return my[yc, xc], mx[yc, xc]


def _sobel(X):
    """`sobel_at` over the interior of a numpy band: (dx, dy)."""
    cd = X[:, 2:] - X[:, :-2]
    cs = (X[:, :-2] + X[:, 2:]) + F32(2) * X[:, 1:-1]
    return (cd[:-2] + F32(2) * cd[1:-1]) + cd[2:], cs[2:] - cs[:-2]


def _floor2(v):
    return np.floor_divide(v, 2)


def _row_pass(op, X, kx, kw):
    """`row_pass` over the last axis: X holds kw + n - 1 columns -> n."""
    n = X.shape[-1] - kw + 1
    taps = [X[..., q:q + n] for q in range(kw)]
    acc = kx[0] * taps[0] if op in (0, 9) else taps[0]
    for q in range(1, kw):
        acc = (acc + kx[q] * taps[q] if op in (0, 9) else acc + taps[q] if op == 6
               else np.minimum(acc, taps[q]) if op == 1 else np.maximum(acc, taps[q]))
    return acc


def _col_pass(op, T, ky, kh, scale):
    """`col_pass` over the first axis: T holds kh + n - 1 rows -> n."""
    n = T.shape[0] - kh + 1
    acc = ky[0] * T[0:n] if op in (0, 9) else T[0:n]
    for q in range(1, kh):
        c = T[q:q + n]
        acc = (acc + ky[q] * c if op in (0, 9) else acc + c if op == 6
               else np.minimum(acc, c) if op == 1 else np.maximum(acc, c))
    return acc * scale if op == 6 else acc


def _pyr_even(a, b, c):
    return ((a + F32(6) * b) + c) * F32(0.125)


def _pyr_odd(b, c):
    return (b + c) * F32(0.5)


class _Frame:
    """A band frame of one block in the replay: image rows [y0, y1) x
    columns [x0, x1) in a slot (None: a band that only goes out), at a row
    stride of its columns rounded up to odd, as csrc/stencil_chain.cu lays
    it out; reads clamp into the frame."""

    def __init__(self, sm, slot, y0, y1, x0, x1):
        self.y0, self.y1, self.x0, self.x1 = int(y0), int(y1), int(x0), int(x1)
        rows, cols = self.y1 - self.y0, self.x1 - self.x0
        ld = cols | 1
        assert rows > 0 and cols > 0
        self.a = None
        if slot is not None and slot >= 0:
            assert rows * ld <= sm.shape[1], "a frame larger than its slot"
            self.a = sm[slot, :rows * ld].reshape(rows, ld)[:, :cols]

    def at(self, Y, X):
        """Values at image rows Y, columns X (broadcast), clamped into the frame."""
        Y = np.clip(Y, self.y0, self.y1 - 1) - self.y0
        X = np.clip(X, self.x0, self.x1 - 1) - self.x0
        return self.a[Y, X]

    def rows(self):
        return np.arange(self.y0, self.y1)

    def cols(self):
        return np.arange(self.x0, self.x1)


def _emulate_kernel(planes: np.ndarray, prog, th: int, tw: int, maps=()) -> list:
    """Replay of `stencil_chain_kernel`: per (plane, tile) block, the input
    band's frame loaded with clamped reads, then each step from the frames
    of its sources to its output frame (cut frames read through a clamp
    into the frame), the row-pass scratch in its own frame, and each output
    band stored from the tile's part of the step's values.  Every frame and
    scratch must fit the planned slot; slots start as NaN, so a read of a
    value no step wrote propagates.  `maps`: each remap stage's (map_x,
    map_y), in chain order."""
    N, H, W = planes.shape
    lv = prog.levels
    wts = np.asarray(prog.weights, F32)
    outs = [np.full((N, *tstencil.plan.band_hw(ops, H, W)), np.nan, F32)
            for _dt, ops in prog.bands]
    slot = prog.slot_floats(th, tw, (H, W))

    def frame_of(b, sm, sl, ti, tj):
        fr = prog.frames[b]
        lth, ltw = lv.tile(fr["level"], th, tw)
        lh, lw = lv.size(fr["level"], H, W)
        ty, tx = ti * lth, tj * ltw
        return _Frame(sm, sl, max(ty - fr["ry"], -fr["ly"]), min(ty + lth + fr["ry"], lh + fr["ly"]),
                      max(tx - fr["rx"], -fr["lx"]), min(tx + ltw + fr["rx"], lw + fr["lx"]))

    def put(f, band, level, ti, tj, n, Y, X, v):
        """Write v (rows Y x cols X) to the frame's slot and the tile's part
        of `band`."""
        if f.a is not None:
            f.a[np.ix_(Y - f.y0, X - f.x0)] = v
        if band >= 0:
            o = outs[band]
            lth, ltw = lv.tile(level, th, tw)
            ry = (Y >= ti * lth) & (Y < min(ti * lth + lth, o.shape[1]))
            rx = (X >= tj * ltw) & (X < min(tj * ltw + ltw, o.shape[2]))
            o[n][np.ix_(Y[ry], X[rx])] = v[ry][:, rx]

    for n in range(N):
        for ti in range(-(-H // th)):
            for tj in range(-(-W // tw)):
                sm = np.full((prog.n_slots, slot), np.nan, F32)
                f0 = frame_of(0, sm, 0, ti, tj)
                ys, xs = np.clip(f0.rows(), 0, H - 1), np.clip(f0.cols(), 0, W - 1)
                f0.a[:] = planes[n][np.ix_(ys, xs)]
                for s in prog.steps:
                    op, pk = s["op"], s["pk"]
                    fs = frame_of(s["fs"], sm, s["src"], ti, tj)
                    hy, hx, kh, kw = s["kh"] // 2, s["kw"] // 2, s["kh"], s["kw"]
                    w0, ky = wts[s["wx"]:], wts[s["wy"]:]
                    sth, stw = lv.tile(s["ls"], th, tw)
                    sty, stx = ti * sth, tj * stw
                    if op == 3:  # the input band as it is
                        o = outs[s["store"]]
                        Y = np.arange(sty, min(sty + sth, o.shape[1]))
                        X = np.arange(stx, min(stx + stw, o.shape[2]))
                        o[n][np.ix_(Y, X)] = fs.at(Y[:, None], X[None, :])
                        continue
                    if s["down"] == 2:  # strided last: the tile's even rows and columns
                        o = outs[s["store"]]
                        Y, X = np.arange(sty, sty + sth, 2), np.arange(stx, stx + stw, 2)
                        if op == 9:
                            tmp = _Frame(sm, s["tmp"], sty - hy, sty + sth + hy, 0, len(X))
                            q = tmp.rows()
                            acc = w0[0] * fs.a[np.ix_(q - fs.y0, X - hx - fs.x0)]
                            for d in range(1, kw):
                                acc = acc + w0[d] * fs.a[np.ix_(q - fs.y0, X - hx + d - fs.x0)]
                            tmp.a[:] = acc
                            v = ky[0] * tmp.a[Y - hy - tmp.y0]
                            for d in range(1, kh):
                                v = v + ky[d] * tmp.a[Y - hy + d - tmp.y0]
                        else:
                            a, b = fs.a[np.ix_(Y - fs.y0, X - fs.x0)], fs.a[np.ix_(Y + 1 - fs.y0, X - fs.x0)]
                            c = fs.a[np.ix_(Y - fs.y0, X + 1 - fs.x0)]
                            d = fs.a[np.ix_(Y + 1 - fs.y0, X + 1 - fs.x0)]
                            v = ((a + b) + (c + d)) * F32(0.25)
                        ky_, kx_ = Y // 2 < o.shape[1], X // 2 < o.shape[2]
                        o[n][np.ix_(Y[ky_] // 2, X[kx_] // 2)] = _pack(v, pk)[ky_][:, kx_]
                        continue
                    fd = frame_of(s["fd"], sm, s["dst"], ti, tj)
                    Y, X = fd.rows(), fd.cols()
                    YY, XX = Y[:, None], X[None, :]

                    def out(v, f=fd, band=s["store"]):
                        put(f, band, s["lo"], ti, tj, n, Y, X, v)

                    if op in (0, 1, 5, 6):  # separable: row pass -> scratch, column pass
                        tmp = _Frame(sm, s["tmp"], max(fd.y0 - hy, fs.y0),
                                     min(fd.y1 - 1 - hy + kh - 1, fs.y1 - 1) + 1, fd.x0, fd.x1)
                        T = tmp.rows()[:, None]
                        tmp.a[:] = _row_pass(op, fs.at(T, np.arange(fd.x0 - hx, fd.x1 - hx + kw - 1)[None, :]),
                                             w0, kw)
                        C = tmp.at(np.arange(fd.y0 - hy, fd.y1 - hy + kh - 1)[:, None], XX)
                        out(_pack(_col_pass(op, C, ky, kh, w0[0] if op == 6 else None), pk))
                    elif op == 4:  # filter2d, taps row-major from -0
                        v = np.full((len(Y), len(X)), -0.0, F32)
                        for a in range(kh):
                            for b in range(kw):
                                v = v + w0[a * kw + b] * fs.at(YY - hy + a, XX - hx + b)
                        out(_pack(v, pk))
                    elif op == 2:
                        dy = (fs.at(YY + 1, XX) - fs.at(YY - 1, XX)) * F32(0.5)
                        dx = (fs.at(YY, XX + 1) - fs.at(YY, XX - 1)) * F32(0.5)
                        out(_pack(np.sqrt(dx * dx + dy * dy), pk))
                    elif op == 10:
                        src3 = fs.at(np.arange(fd.y0 - 1, fd.y1 + 1)[:, None],
                                     np.arange(fd.x0 - 1, fd.x1 + 1)[None, :])
                        dx, dy = _sobel(src3)
                        out(dx)
                        f2 = frame_of(s["fd2"], sm, s["dst2"], ti, tj)
                        put(f2, s["store2"], s["lo"], ti, tj, n, Y, X, dy)
                    elif op == 11:
                        fs2 = frame_of(s["fs2"], sm, s["src2"], ti, tj)
                        a, b = fs.at(YY, XX), fs2.at(YY, XX)
                        out(_pack(np.sqrt(a * a + b * b), pk))
                    elif op in (13, 14):
                        lh, lw = lv.size(s["ls"], H, W)
                        yy, xx = np.meshgrid(Y, X, indexing="ij")
                        sy, sx = _gather_coords(op, w0, maps, s["wx"], yy, xx, lh, lw)
                        v = _bilinear(fs.a, sy, sx, fs.y0, fs.x0, sty - s["rh"] - fs.y0,
                                      sty + sth + s["rh"] - fs.y0, stx - s["rw"] - fs.x0,
                                      stx + stw + s["rw"] - fs.x0)
                        out(_pack(v, pk))
                    elif op == 7:
                        out(_pack(np.where(fs.at(YY, XX) > w0[0], w0[1], F32(0)), pk))
                    elif op == 8:
                        out(_pack(fs.at(YY, XX) * w0[0] + w0[1], pk))
                    elif op == 15:  # pyrUp: row phases -> scratch, then column phases
                        tmp = _Frame(sm, s["tmp"], fd.y0, fd.y1, _floor2(fd.x0) - 1,
                                     _floor2(fd.x1 - 1) + 2)
                        q = _floor2(Y)[:, None]
                        xs_ = tmp.cols()[None, :] - fs.x0
                        a, b, c = (fs.a[q + d - fs.y0, xs_] for d in (-1, 0, 1))
                        tmp.a[:] = np.where((Y & 1)[:, None] == 1, _pyr_odd(b, c), _pyr_even(a, b, c))
                        qc = _floor2(X) - tmp.x0
                        Tm = tmp.a
                        v = np.where((X & 1)[None, :] == 1, _pyr_odd(Tm[:, qc], Tm[:, qc + 1]),
                                     _pyr_even(Tm[:, qc - 1], Tm[:, qc], Tm[:, qc + 1]))
                        out(_pack(v, pk))
                    elif op == 9:  # a pyrDown before the last stage
                        tmp = _Frame(sm, s["tmp"], 2 * fd.y0 - hy, 2 * (fd.y1 - 1) + hy + 1,
                                     fd.x0, fd.x1)
                        q = tmp.rows()[:, None]
                        acc = w0[0] * fs.a[q - fs.y0, 2 * XX - hx - fs.x0]
                        for d in range(1, kw):
                            acc = acc + w0[d] * fs.a[q - fs.y0, 2 * XX - hx + d - fs.x0]
                        tmp.a[:] = acc
                        v = ky[0] * tmp.a[2 * Y - hy - tmp.y0]
                        for d in range(1, kh):
                            v = v + ky[d] * tmp.a[2 * Y - hy + d - tmp.y0]
                        out(_pack(v, pk))
                    elif op == 12:  # a resize2 before the last stage
                        r, c = 2 * YY - fs.y0, 2 * XX - fs.x0
                        a, b = fs.a[r, c], fs.a[r + 1, c]
                        c_, d = fs.a[r, c + 1], fs.a[r + 1, c + 1]
                        out(_pack(((a + b) + (c_ + d)) * F32(0.25), pk))
                    else:
                        raise AssertionError(f"op {op}")
    return outs


@pytest.mark.parametrize("name,shape", CASES)
@pytest.mark.parametrize("tile", [32, 16])
def test_kernel_step_table_reproduces_plain_version(name, shape, tile):
    """Every band of the planned step table, replayed block by block, equals
    the plain version bit for bit, stores cover every pixel, and no step
    reads a value the window never held (NaN would propagate)."""
    _, tc = _chains()[name]
    x = torch.from_numpy(_input(shape, seed=3))
    planes = tref.to_planes(x if len(shape) == 4 else x[..., None])
    prog = exec_window.compile_chain(tc)
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig(tile_rows=tile, tile_cols=tile),
                                         tuple(planes.shape))
    assert (th, tw) == (tile, tile)
    assert smem <= LaunchConfig().smem_budget
    got = _emulate_kernel(planes.numpy(), prog, th, tw)
    want = tref.chain_ref_planes(planes, tc)
    assert len(want) == prog.n_bands
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[k], w.numpy())


def test_compile_chain_slot_plan_for_the_octave():
    """The octave ladder needs three shared-memory slots (source band, new
    band, row-pass scratch; the last band only goes out) and stores each of
    its seven bands once.  On a request's 32x32 planes every frame is cut
    to the rows and columns that are distinct: 64x64 at most (100x100
    uncut), so three 16.6 KB slots, and 256 planes take one wave of 512
    threads, two blocks an SM."""
    prog = exec_window.compile_chain(tfeatures.octave_chain(4, with_next_base=False))
    assert prog.n_slots == 3 and prog.n_bands == 7 and prog.halo == (34, 34)
    stores = [s["store"] for s in prog.steps if s["store"] >= 0]
    assert stores == list(range(7))
    assert [f["ly"] for f in prog.frames] == [0, 5, 8, 12, 16, 21, 27, 34]
    assert [r for r, _c in prog.frame_spans(32, 32, (32, 32))] == [32, 42, 48, 56, 64, 58, 46, 32]
    assert prog.steps[-1]["dst"] == -1
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig(), (256, 32, 32))
    assert (th, tw) == (32, 32) and smem == prog.table_smem() + 3 * 64 * 65 * 4
    g = exec_window.window_geometry(prog, LaunchConfig(), (256, 32, 32))
    assert (g.threads, g.per_sm) == (512, 2) and 256 <= 132 * g.per_sm
    # uncut (an interior tile of a large plane): the full 100x100 window
    assert prog.slot_floats(32, 32) == 100 * 101


def test_compile_chain_slot_plan_for_the_octave_with_next_base():
    """The next-base tap keeps scale 4's slot alive to the end and stores
    straight to the half-resolution output (no slot of its own), as the last
    scale does (three slots); scale 4, which the pyrDown reads, keeps its
    full frame (62x62 on a 32x32 plane), the other bands are cut."""
    prog = exec_window.compile_chain(tfeatures.octave_chain(4))
    assert prog.n_slots == 3 and prog.halo == (36, 36)
    assert [ops for _dt, ops in prog.bands] == [()] * 7 + [("pyr_down",)]
    last = prog.steps[-1]
    assert (last["op"], last["down"], last["dst"], last["store"]) == (9, 2, -1, 7)
    assert [s["store"] for s in prog.steps[:-1]] == list(range(7))
    cut = [f["ly"] < exec_window.UNCUT for f in prog.frames]
    assert cut == [True] * 5 + [False] + [True] * 2 + [False]
    assert prog.frame_spans(32, 32, (32, 32))[5] == (62, 62)
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig(), (1, 32, 32))
    assert (th, tw) == (32, 32) and prog.slot_floats(32, 32, (32, 32)) == 64 * 65
    assert smem == prog.table_smem() + 3 * 64 * 65 * 4


def test_strided_chains_need_even_tiles_and_a_last_pyr_down():
    """A strided chain's tiles are multiples of its stride product.  A
    pyrDown before the last stage no longer has to be the last: it starts a
    second level, whose frame is the half-size tile plus the blur's halo."""
    prog = exec_window.compile_chain((tstencil.gaussian_stage(3), tstencil.pyr_down_stage()))
    assert prog.halo == (4, 4)  # the 3-pixel halo aligned to the stride
    with pytest.raises(ValueError, match="stride"):
        exec_window.pick_tile(prog, LaunchConfig(tile_rows=15, tile_cols=16))
    prog = exec_window.compile_chain((tstencil.pyr_down_stage(), tstencil.gaussian_stage(3)))
    assert prog.unit == (2, 2) and prog.levels.pads == ((4, 4), (1, 1))
    assert [f["level"] for f in prog.frames] == [0, 1, 1]
    assert prog.frame_spans(32, 32) == [(40, 40), (18, 18), (16, 16)]


def test_pick_tile_halves_under_a_small_budget():
    prog = exec_window.compile_chain(tfeatures.octave_chain(4, with_next_base=False))
    budget = prog.table_smem() + 3 * (16 + 68) * (16 + 68 + 1) * 4
    th, tw, _ = exec_window.pick_tile(prog, LaunchConfig(smem_budget=budget))
    assert (th, tw) == (16, 16)


def test_tap_only_chain_stores_the_input_band():
    chain = (tstencil.gaussian_stage(3, tap=0), tstencil.gaussian_stage(5, tap=-1))
    prog = exec_window.compile_chain(chain)
    assert prog.steps[0]["op"] == 3 and prog.steps[0]["store"] == 0
    x = torch.from_numpy(_input((2, 12, 10), seed=4))
    got = _emulate_kernel(x.numpy(), prog, 8, 8)
    for k, w in enumerate(tref.chain_ref_planes(x, chain)):
        np.testing.assert_array_equal(got[k], w.numpy())


@pytest.mark.parametrize("chain", ["map", "tap", "gauss_map"])
@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 5, 5), (1, 64, 48)])
def test_pyr_down_step_table_on_u8(chain, shape):
    """The lone pyrDown as a map stage, as a tap beside the input band, and
    after a blur, on a u8 carrier, odd and even sizes, 16x16 tiles."""
    stages = {
        "map": (tstencil.pyr_down_stage(),),
        "tap": (tstencil.pyr_down_stage(tap=0),),
        "gauss_map": (tstencil.gaussian_stage(3), tstencil.pyr_down_stage()),
    }[chain]
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8))
    prog = exec_window.compile_chain(stages, torch.uint8)
    got = _emulate_kernel(x.numpy(), prog, 16, 16)
    want = tref.chain_ref_planes(x, stages)
    assert [tuple(w.shape) for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float32))


@pytest.mark.parametrize("chain", ["pyr_up", "down_up", "gauss_down_erode", "resize_gauss",
                                   "up_gauss_down_tap"])
@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 5, 5), (1, 34, 18)])
def test_level_chains_step_table_on_u8(chain, shape):
    """pyrUp and a stride before the chain's last stage on a u8 carrier, odd
    and even sizes, 16x16 tiles: the packed row phases, the frames of each
    level, bit for bit against the plain version."""
    stages = _level_chains(tstencil)[chain]
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8))
    prog = exec_window.compile_chain(stages, torch.uint8)
    got = _emulate_kernel(x.numpy(), prog, 16, 16)
    want = tref.chain_ref_planes(x, stages)
    assert [tuple(w.shape) for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# Chains the TPU kernels take that the card's tables refused: even taps and
# chains past the old fixed tables (32 steps, 512 weights, 8 levels, 16
# bands, 4 remaps)
# ---------------------------------------------------------------------------

def _taps(seed, *shape):
    """Seeded positive taps that sum to 1 (a u8 chain stays in range)."""
    w = np.random.default_rng(seed).random(shape, dtype=np.float32) + np.float32(0.25)
    return (w / w.sum()).astype(np.float32)


def _smooth_maps(h, w, a, b):
    """An identity map plus a smooth field under a pixel (chip_smoke.py's)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (xx + np.float32(a) * np.cos(yy / np.float32(5.0))).astype(np.float32), \
        (yy + np.float32(b) * np.sin(xx / np.float32(7.0))).astype(np.float32)


def table_chain(pkg, name, hw=None):
    """One chain of the card's former refusals, built with either package
    (`hw`: the image size, for the remap chain's map planes)."""
    def f2(*shape, seed):
        k = _taps(seed, *shape)
        return pkg.filter_stage(k if pkg is jstencil else torch.from_numpy(k))

    def sep(nx, ny, seed, **kw):
        kx, ky = _taps(seed, nx), _taps(seed + 1, ny)
        if pkg is not jstencil:
            kx, ky = torch.from_numpy(kx), torch.from_numpy(ky)
        return pkg.sep_filter_stage(kx, ky, **kw)

    if name == "even2":
        return (f2(2, 2, seed=1),)
    if name == "even4":
        return (f2(4, 4, seed=2),)
    if name == "even6":
        return (sep(6, 6, seed=3),)
    if name == "odd_even":
        return (f2(3, 4, seed=4), sep(5, 2, seed=5), f2(4, 5, seed=6))
    if name == "even_mix":
        return (pkg.gaussian_stage(3), sep(4, 6, seed=7, tap=0), pkg.erode_stage(1),
                f2(2, 6, seed=8, ), sep(2, 2, seed=9, tap=-2))
    if name == "weights676":  # four 13x13 filters: 676 weights
        return tuple(f2(13, 13, seed=10 + i) for i in range(4))
    if name == "stages33":
        ops = (lambda: pkg.gaussian_stage(3), lambda: pkg.affine_stage(0.9375, 3.0),
               lambda: pkg.erode_stage(1))
        return tuple(ops[i % 3]() for i in range(33))
    if name == "levels9":  # 9 resolution levels: pyrDown / pyrUp x 4, then a pyrDown
        return tuple(pkg.pyr_down_stage() if i % 2 == 0 else pkg.pyr_up_stage() for i in range(8)) \
            + (pkg.pyr_down_stage(),)
    if name == "bands17":  # 16 taps of the input beside it: 17 output bands
        return tuple(pkg.gaussian_stage(3 + 2 * (i % 3), tap=0) for i in range(16))
    if name == "remaps5":
        h, w = hw
        out = []
        for i, e in enumerate((15, 7, 3, 1, 0)):  # each budgets the later remaps' halo
            mx, my = _smooth_maps(h, w, 0.3 + 0.05 * i, 0.45 - 0.05 * i)
            if pkg is not jstencil:
                mx, my = torch.from_numpy(mx), torch.from_numpy(my)
            out.append(pkg.remap_stage(mx, my, extend=(e, e)))
        return tuple(out)
    if name == "pyr_down9":
        return tuple(pkg.pyr_down_stage() for _ in range(9))
    raise KeyError(name)


EVEN_CHAINS = ["even2", "even4", "even6", "odd_even", "even_mix"]
TABLE_CHAINS = ["weights676", "stages33", "levels9", "bands17", "remaps5"]


def _table_input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * np.float32(255.0)


@pytest.mark.parametrize("name", EVEN_CHAINS + TABLE_CHAINS)
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_table_chains_match_jax_fused_chain_ref(name, dtype):
    """The plain version (what both kernels are held to) against JAX's
    `fused_chain(mode="ref")`: u8 exact, f32 within the oracles' tolerance."""
    shape = (2, 41, 37) if name != "levels9" else (1, 64, 96)
    x = _table_input(shape, dtype, seed=20)
    jc, tc = table_chain(jstencil, name, shape[1:]), table_chain(tstencil, name, shape[1:])
    want = _tuple_np(jstencil.fused_chain(jnp.asarray(x[..., None]), jc, mode="ref"))
    got = _tuple_np(tstencil.fused_chain(torch.from_numpy(x[..., None]), tc, mode="ref"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if dtype == "u8":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _tuple_np(x):
    return [np.asarray(v) for v in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("name", EVEN_CHAINS + TABLE_CHAINS)
@pytest.mark.parametrize("dtype,shape,tile", [("u8", (1, 41, 37), 16), ("f32", (2, 29, 35), 32)])
def test_window_replay_of_table_chains(name, dtype, shape, tile):
    """`stencil_chain` takes every one of these chains: its step table,
    replayed block by block, equals the plain version bit for bit."""
    if name == "levels9":
        shape, tile = (1, 70, 45), 32
    x = torch.from_numpy(_table_input(shape, dtype, seed=21))
    chain = table_chain(tstencil, name, shape[1:])
    prog = exec_window.compile_chain(chain, x.dtype)
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig(tile_rows=tile, tile_cols=tile),
                                         tuple(x.shape))
    assert smem <= LaunchConfig().smem_budget
    maps = [tuple(w.numpy() for w in s.weights) for s in chain if s.op == "remap"]
    got = _emulate_kernel(x.numpy(), prog, th, tw, maps)
    want = tref.chain_ref_planes(x, chain)
    assert len(got) == len(want) == prog.n_bands
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float32))


def test_table_chains_pass_the_old_limits():
    """Each chain is past a limit of the old fixed tables, and now plans in
    both kernels: the program is sized per chain, and the per-launch tables
    hold 64 bands, 16 remaps and 16 levels."""
    hw = (41, 37)
    prog = {n: exec_window.compile_chain(table_chain(tstencil, n, hw)) for n in TABLE_CHAINS}
    assert len(prog["weights676"].weights) == 676
    assert len(prog["stages33"].steps) == 33
    assert prog["levels9"].levels.n_levels == 9
    assert prog["bands17"].n_bands == 17
    assert sum(s["op"] == exec_window.OP_CODES["remap"] for s in prog["remaps5"].steps) == 5
    for n in TABLE_CHAINS:
        sp = exec_streaming.compile_stream(table_chain(tstencil, n, hw), 32 if n == "levels9" else 8)
        assert sp.table_bytes == len(sp.packed())
    assert exec_window.MAX_BANDS == 64 and exec_window.MAX_LEVELS == 16


def test_even_taps_plan_as_their_own_extents():
    """Even taps keep their extents in the step tables (no zero tap added):
    halo k // 2, the taps' own kh, kw."""
    chain = table_chain(tstencil, "odd_even")
    prog = exec_window.compile_chain(chain)
    assert [(s["kh"], s["kw"]) for s in prog.steps] == [(3, 4), (2, 5), (4, 5)]
    assert len(prog.weights) == 12 + 7 + 20
    sp = exec_streaming.compile_stream(chain, 8)
    assert [(s["kh"], s["kw"], s["strip"]) for s in sp.steps] == [(3, 4, 0), (2, 5, 0), (4, 5, 0)]


def test_nine_pyr_downs_are_refused_by_the_geometry_not_a_table():
    """Nine pyrDowns on a 600x700 plane: the levels fit the tables, but a
    tile (and a step) must be a multiple of the stride product 512, and a
    512-row tile's window (512 + 2 x 1022 rows) is far over a block's shared
    memory; both kernels say which limit, by ValueError.  The plain version
    runs it, equal to JAX's."""
    chain = table_chain(tstencil, "pyr_down9")
    prog = exec_window.compile_chain(chain, torch.uint8)
    assert prog.levels.n_levels == 9 and prog.unit == (512, 512)
    with pytest.raises(ValueError, match="stride product"):
        exec_window.pick_tile(prog, LaunchConfig(), (1, 600, 700))
    with pytest.raises(ValueError, match="shared memory"):
        exec_window.pick_tile(prog, LaunchConfig(tile_rows=512, tile_cols=512), (1, 600, 700))
    with pytest.raises(ValueError, match="stride product"):
        exec_streaming.compile_stream(chain, 64, torch.uint8)
    x = np.random.default_rng(22).integers(0, 256, (600, 700), dtype=np.uint8)
    want = np.asarray(jstencil.fused_chain(jnp.asarray(x), table_chain(jstencil, "pyr_down9"),
                                           mode="ref"))
    got = tstencil.fused_chain(torch.from_numpy(x), chain, mode="ref").numpy()
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Cut frames: only the rows and columns that are distinct
# ---------------------------------------------------------------------------

def _uncut(prog):
    """The same program with every frame full (the tile plus what its
    readers need, nothing cut)."""
    import dataclasses

    frames = tuple(f | {"ly": exec_window.UNCUT, "lx": exec_window.UNCUT} for f in prog.frames)
    return dataclasses.replace(prog, frames=frames, _memo={})


@pytest.mark.parametrize("name", ["octave", "preprocess", "octave_nb"])
@pytest.mark.parametrize("shape,tile", [((2, 32, 32), 32), ((1, 45, 39), 16), ((1, 37, 53), 8),
                                        ((1, 50, 70), 16)])
def test_cut_frames_equal_the_full_window(name, shape, tile):
    """The cut frames' replay equals the full windows' bit for bit, band by
    band, on the BoW chains: one tile covering a 32x32 plane, odd sizes,
    and planes of several tiles, whose edge tiles are cut and interior
    ones not."""
    _, tc = _chains()[name]
    x = _input(shape, seed=31)
    if name == "preprocess":
        x = x[..., :1].copy() if x.ndim == 4 else x
    prog = exec_window.compile_chain(tc)
    assert any(f["ly"] < exec_window.UNCUT for f in prog.frames)
    full = _uncut(prog)
    cut = _emulate_kernel(x, prog, tile, tile)
    whole = _emulate_kernel(x, full, tile, tile)
    assert prog.slot_floats(tile, tile, shape[1:]) <= full.slot_floats(tile, tile, shape[1:])
    for a, b in zip(cut, whole, strict=True):
        np.testing.assert_array_equal(a, b)


def test_cut_frames_shrink_the_octave_work():
    """On a request's 32x32 planes the octave's frames hold 0.54 of the
    full windows' outputs (the window's arithmetic shrinks with them), and
    its largest frame is 64x64 instead of 100x100."""
    prog = exec_window.compile_chain(tfeatures.octave_chain(4, with_next_base=False))
    full = _uncut(prog)
    cut_f = exec_window.window_flops(prog, 32, 32, (32, 32))
    full_f = exec_window.window_flops(full, 32, 32, (32, 32))
    assert 0.5 < cut_f / full_f < 0.58
    assert max(r for r, _c in prog.frame_spans(32, 32, (32, 32))) == 64
    assert max(r for r, _c in full.frame_spans(32, 32, (32, 32))) == 100


@pytest.mark.parametrize("chain", [
    (tstencil.gaussian_stage(3), tstencil.pyr_down_stage(), tstencil.erode_stage(1)),
    (tstencil.gaussian_stage(5), tstencil.pyr_down_stage(tap=0)),
    (tstencil.gaussian_stage(3), tstencil.resize2_stage(), tstencil.gaussian_stage(3)),
    (tstencil.gaussian_stage(3), tstencil.pyr_up_stage(), tstencil.gaussian_stage(3)),
    (tstencil.gaussian_stage(3), tstencil.warp_affine_stage(
        np.array([[1.0, 0.02, 1.5], [-0.02, 1.0, -2.0]]), shape=(40, 40)), tstencil.erode_stage(1)),
])
def test_gathers_and_strides_keep_full_frames(chain):
    """A band a gather, a stride or a pyrUp reads keeps its full frame, as do
    the bands at a level past a resolution change and the bands after a
    gather; only bands of level-0, stride-1, position-independent lineage
    whose every reader clamps are cut."""
    prog = exec_window.compile_chain(chain)
    unclamped = {"warp_affine", "remap", "pyr_down", "resize2", "pyr_up"}
    walk = tstencil.plan.band_walk(chain)
    after_gather = False
    for k, (s, stage) in enumerate(zip(chain, walk.apps)):
        for srcs, dsts in stage:
            for i in srcs:
                if s.op in unclamped:
                    assert prog.frames[i]["ly"] == exec_window.UNCUT, (k, i)
            for d in dsts:
                if after_gather or s.op in unclamped or prog.frames[d]["level"] > 0:
                    assert prog.frames[d]["ly"] == exec_window.UNCUT, (k, d)
        after_gather = after_gather or s.op in ("warp_affine", "remap")
