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


def _emulate_kernel(planes: np.ndarray, prog, th: int, tw: int, maps=()) -> list:
    """Replay of `stencil_chain_kernel`: per (plane, tile) block, the window
    load with clamped reads, then each step on its slots, in the frames of
    its source and output levels, and the stores to each band's own
    buffer.  `maps`: each remap stage's (map_x, map_y), in chain order."""
    N, H, W = planes.shape
    lv = prog.levels
    wts = np.asarray(prog.weights, F32)
    outs = [np.full((N, *tstencil.plan.band_hw(ops, H, W)), np.nan, F32)
            for _dt, ops in prog.bands]
    slot = prog.slot_floats(th, tw)

    def frame(level, ti, tj):
        lth, ltw = lv.tile(level, th, tw)
        py, px = prog.pads[level]
        return lth, ltw, py, px, ltw + 2 * px, ti * lth - py, tj * ltw - px

    for n in range(N):
        for ti in range(-(-H // th)):
            for tj in range(-(-W // tw)):
                sm = np.full((prog.n_slots, slot), np.nan, F32)

                def view(k, WW):
                    return sm[k, :slot // WW * WW].reshape(-1, WW)

                th0, tw0, py0, px0, WW0, oy0, ox0 = frame(0, ti, tj)
                ys = np.clip(oy0 + np.arange(th0 + 2 * py0), 0, H - 1)
                xs = np.clip(ox0 + np.arange(WW0), 0, W - 1)
                view(0, WW0)[:th0 + 2 * py0] = planes[n][ys][:, xs]
                for s in prog.steps:
                    op, pk = s["op"], s["pk"]
                    sth, stw, spy, spx, WW, oy, ox = frame(s["ls"], ti, tj)
                    dth, dtw, dpy, dpx, WWd, oyd, oxd = frame(s["lo"], ti, tj)
                    r0, r1 = spy - s["rh"], spy + sth + s["rh"]
                    c0, c1 = spx - s["rw"], spx + stw + s["rw"]
                    i0, i1 = dpy - s["oh"], dpy + dth + s["oh"]
                    j0, j1 = dpx - s["ow"], dpx + dtw + s["ow"]
                    hy, hx = s["kh"] // 2, s["kw"] // 2
                    src, src2 = view(s["src"], WW).copy(), view(s["src2"], WW).copy()
                    dst = view(s["dst"], WWd) if s["dst"] >= 0 else None
                    w0 = wts[s["wx"]:]
                    I, J = slice(r0 + hy, r1 - hy), slice(c0 + hx, c1 - hx)
                    nr, nc = r1 - r0 - 2 * hy, c1 - c0 - 2 * hx
                    if op == 15:  # pyrUp: row phases -> tmp, then column phases
                        ii, jj = np.arange(i0, i1), np.arange(j0, j1)
                        x0 = _floor2(oxd + j0) - 1 - ox
                        x1 = _floor2(oxd + j1 - 1) + 2 - ox
                        Y = oyd + ii
                        q = _floor2(Y) - oy
                        a, b, c = (src[q + d][:, x0:x1] for d in (-1, 0, 1))
                        t = np.where((Y & 1)[:, None] == 1, _pyr_odd(b, c), _pyr_even(a, b, c))
                        tmp = view(s["tmp"], WW)
                        tmp[i0:i1, x0:x1] = t
                        X = oxd + jj
                        qc = _floor2(X) - ox
                        T = tmp[i0:i1]
                        v = np.where((X & 1)[None, :] == 1, _pyr_odd(T[:, qc], T[:, qc + 1]),
                                     _pyr_even(T[:, qc - 1], T[:, qc], T[:, qc + 1]))
                        dst[i0:i1, j0:j1] = _pack(v, pk)
                    elif op in (9, 12) and s["down"] == 1:  # a stride mid-chain
                        ii, jj = np.arange(i0, i1), np.arange(j0, j1)
                        qs, xs_ = 2 * (oyd + ii) - oy, 2 * (oxd + jj) - ox
                        if op == 9:
                            q0, q1 = qs[0] - hy, qs[-1] + hy + 1
                            kx, ky = wts[s["wx"]:s["wx"] + 5], wts[s["wy"]:s["wy"] + 5]
                            tmp = view(s["tmp"], WWd)
                            acc = kx[0] * src[q0:q1][:, xs_ - hx]
                            for d in range(1, 5):
                                acc = acc + kx[d] * src[q0:q1][:, xs_ - hx + d]
                            tmp[q0:q1, j0:j1] = acc
                            T = tmp[:, j0:j1]
                            v = ky[0] * T[qs - hy]
                            for d in range(1, 5):
                                v = v + ky[d] * T[qs - hy + d]
                        else:
                            a, b = src[qs][:, xs_], src[qs + 1][:, xs_]
                            c, d = src[qs][:, xs_ + 1], src[qs + 1][:, xs_ + 1]
                            v = ((a + b) + (c + d)) * F32(0.25)
                        dst[i0:i1, j0:j1] = _pack(v, pk)
                    elif op in (9, 12):  # strided last: image-even rows and columns -> own band
                        band = outs[s["store"]]
                        e0 = r0 + hy + (oy + r0 + hy) % 2
                        f0 = c0 + hx + (ox + c0 + hx) % 2
                        if op == 9:
                            rows, cols = np.arange(e0, r1 - hy, 2), np.arange(f0, c1 - hx, 2)
                            kx, ky = wts[s["wx"]:s["wx"] + 5], wts[s["wy"]:s["wy"] + 5]
                            acc = kx[0] * src[r0:r1][:, cols - hx]
                            for q in range(1, 5):
                                acc = acc + kx[q] * src[r0:r1][:, cols - hx + q]
                            v = ky[0] * acc[rows - hy - r0]
                            for q in range(1, 5):
                                v = v + ky[q] * acc[rows - hy - r0 + q]
                        else:
                            rows, cols = np.arange(e0, r1 - 1, 2), np.arange(f0, c1 - 1, 2)
                            a, b = src[rows][:, cols], src[rows + 1][:, cols]
                            c, d = src[rows][:, cols + 1], src[rows + 1][:, cols + 1]
                            v = ((a + b) + (c + d)) * F32(0.25)
                        ys, xs = (oy + rows) // 2, (ox + cols) // 2
                        ky_, kx_ = ys < band.shape[1], xs < band.shape[2]
                        band[n, ys[ky_][:, None], xs[kx_][None, :]] = _pack(v, pk)[ky_][:, kx_]
                        continue
                    elif op in (0, 1, 5, 6):  # separable: row pass -> tmp, column pass
                        tmp = view(s["tmp"], WW)
                        tmp[r0:r1, J] = _row_pass(op, src[r0:r1, c0:c1], w0, s["kw"])
                        v = _col_pass(op, tmp[r0:r1, J], wts[s["wy"]:], s["kh"],
                                      w0[0] if op == 6 else None)
                        dst[I, J] = _pack(v, pk)
                    elif op == 4:  # filter2d, taps row-major
                        v = w0[0] * src[r0:r0 + nr, c0:c0 + nc]
                        for a in range(s["kh"]):
                            for b in range(s["kw"]):
                                if a or b:
                                    v = v + w0[a * s["kw"] + b] * src[r0 + a:r0 + a + nr,
                                                                      c0 + b:c0 + b + nc]
                        dst[I, J] = _pack(v, pk)
                    elif op == 2:
                        dy = (src[r0 + 2:r1, J] - src[r0:r1 - 2, J]) * F32(0.5)
                        dx = (src[I, c0 + 2:c1] - src[I, c0:c1 - 2]) * F32(0.5)
                        dst[I, J] = _pack(np.sqrt(dx * dx + dy * dy), pk)
                    elif op == 10:
                        dx, dy = _sobel(src[r0:r1, c0:c1])
                        dst[I, J], view(s["dst2"], WW)[I, J] = dx, dy
                    elif op == 11:
                        a, b = src[I, J], src2[I, J]
                        dst[I, J] = _pack(np.sqrt(a * a + b * b), pk)
                    elif op in (13, 14):
                        ii, jj = np.meshgrid(np.arange(r0 + hy, r1 - hy), np.arange(c0 + hx, c1 - hx),
                                             indexing="ij")
                        lh, lw = lv.size(s["ls"], H, W)
                        sy, sx = _gather_coords(op, w0, maps, s["wx"], oy + ii, ox + jj, lh, lw)
                        v = _bilinear(src, sy, sx, oy, ox, r0, r1, c0, c1)
                        dst[I, J] = _pack(v, pk)
                    elif op == 7:
                        v = np.where(src[I, J] > w0[0], w0[1], F32(0))
                        dst[I, J] = _pack(v, pk)
                    elif op == 8:
                        dst[I, J] = _pack(src[I, J] * w0[0] + w0[1], pk)
                    for key, slot_k in (("store", "dst"), ("store2", "dst2")):
                        if s[key] >= 0:
                            band = outs[s[key]]
                            hh = min(dth, band.shape[1] - ti * dth)
                            ww = min(dtw, band.shape[2] - tj * dtw)
                            if hh > 0 and ww > 0:
                                band[n, ti * dth:ti * dth + hh, tj * dtw:tj * dtw + ww] = \
                                    view(s[slot_k], WWd)[dpy:dpy + hh, dpx:dpx + ww]
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
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig(tile_rows=tile, tile_cols=tile))
    assert (th, tw) == (tile, tile)
    assert smem + exec_window.PROGRAM_BYTES <= LaunchConfig().smem_budget
    got = _emulate_kernel(planes.numpy(), prog, th, tw)
    want = tref.chain_ref_planes(planes, tc)
    assert len(want) == prog.n_bands
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[k], w.numpy())


def test_compile_chain_slot_plan_for_the_octave():
    """The octave ladder needs three shared-memory slots (source band, new
    band, row-pass scratch) and stores each of its seven bands once."""
    prog = exec_window.compile_chain(tfeatures.octave_chain(4, with_next_base=False))
    assert prog.n_slots == 3 and prog.n_bands == 7 and prog.halo == (34, 34)
    stores = [s["store"] for s in prog.steps if s["store"] >= 0]
    assert stores == list(range(7))
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig())
    assert (th, tw) == (32, 32) and smem == 3 * 100 * 100 * 4


def test_compile_chain_slot_plan_for_the_octave_with_next_base():
    """The next-base tap keeps scale 4's slot alive to the end (four slots)
    and stores straight to the half-resolution output (no slot of its
    own); the window pad is the 36-pixel halo, even already."""
    prog = exec_window.compile_chain(tfeatures.octave_chain(4))
    assert prog.n_slots == 4 and prog.halo == (36, 36)
    assert [ops for _dt, ops in prog.bands] == [()] * 7 + [("pyr_down",)]
    last = prog.steps[-1]
    assert (last["op"], last["down"], last["dst"], last["store"]) == (9, 2, -1, 7)
    assert [s["store"] for s in prog.steps[:-1]] == list(range(7))
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig())
    assert (th, tw) == (32, 32) and smem == 4 * 104 * 104 * 4


def test_strided_chains_need_even_tiles_and_a_last_pyr_down():
    """A strided chain's tiles are multiples of its stride product.  A
    pyrDown before the last stage no longer has to be the last: it starts a
    second level, whose frame is the half-size tile plus the blur's halo."""
    prog = exec_window.compile_chain((tstencil.gaussian_stage(3), tstencil.pyr_down_stage()))
    assert prog.halo == (4, 4)  # the 3-pixel halo aligned to the stride
    with pytest.raises(ValueError, match="stride"):
        exec_window.pick_tile(prog, LaunchConfig(tile_rows=15, tile_cols=16))
    prog = exec_window.compile_chain((tstencil.pyr_down_stage(), tstencil.gaussian_stage(3)))
    assert prog.unit == (2, 2) and prog.pads == ((4, 4), (1, 1))
    assert prog.frame(1, 32, 32) == (18, 18)


def test_pick_tile_halves_under_a_small_budget():
    prog = exec_window.compile_chain(tfeatures.octave_chain(4, with_next_base=False))
    budget = exec_window.PROGRAM_BYTES + 3 * (16 + 68) ** 2 * 4
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
