"""The filter2D / erode image path of the port against the JAX package.

The JAX side runs its oracles (`repro.kernels.ref.filter2d_ref`,
`sep_filter2d_ref`, `erode_ref`, `dilate_ref`, `chain_ref`): its Pallas
stencil plans do not lower on every jax release, and the oracles always
run.  The port runs `fused_chain` and the ops on the CPU, which is the
plain version of whichever kernel the mode names.  Inputs are made from a
numpy seed and handed to both packages.

Tolerances: f32 rtol 2e-5 and atol 2e-3 (the repo's f32 oracle tolerance,
tests/test_pyramid.py), because XLA may contract a multiply and add into one
FMA where the port rounds twice; u8 |diff| <= 1, with the off-by-one pixels
counted and held under 1% (such a contraction can move a .5 rounding tie);
erode, dilate and threshold-only chains exact.

`_emulate_stream` replays the `stencil_stream` CUDA kernel's block loop in
numpy from the program `exec_streaming.compile_stream` plans (segment
priming, ring rotation, the delay of pass-through bands, the H tail,
column tiles, direct stores), so the planner and the kernel's indexing are
checked here, bit for bit, without a card.
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
from repro_torch.cv import imgproc as timgproc
from repro_torch.kernels import counters
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import driver, exec_streaming, exec_window, plan

RTOL, ATOL = 2e-5, 2e-3
U8_OFF_BY_ONE = 0.01  # largest share of u8 pixels allowed one apart from JAX

_K53 = np.random.default_rng(7).random((5, 3), dtype=np.float32) / 15.0
_KX = np.asarray([0.25, 0.5, 0.25], np.float32)
_KY = np.asarray([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)


def _stages(pkg, name):
    """One chain, built with either package's stage builders."""
    K, KX, KY = ((jnp.asarray(a) for a in (_K53, _KX, _KY)) if pkg is jstencil
                 else (torch.from_numpy(a) for a in (_K53, _KX, _KY)))
    return {
        "filter2d": (pkg.filter_stage(K),),
        "sep_filter": (pkg.sep_filter_stage(KX, KY),),
        "box": (pkg.box_stage(2),),
        "erode": (pkg.erode_stage(2),),
        "dilate": (pkg.dilate_stage(1),),
        "threshold": (pkg.threshold_stage(100.5, 200.0),),
        "affine": (pkg.affine_stage(1.7, -20.3),),
        "gaussian_filter2d_k13": (pkg.filter_stage(_outer(pkg, 13)),),
        "erode_r3": (pkg.erode_stage(3),),
        "acceptance": (pkg.gaussian_stage(5), pkg.erode_stage(1), pkg.threshold_stage(100.0)),
        "preprocess": (pkg.gaussian_stage(5), pkg.erode_stage(1), pkg.grad_stage()),
        "octave": (jfeatures.octave_chain(4, with_next_base=False) if pkg is jstencil
                   else tfeatures.octave_chain(4, with_next_base=False)),
        "octave_nb": (jfeatures if pkg is jstencil else tfeatures).octave_chain(4),
        "pyr_down": (pkg.pyr_down_stage(),),
        "pyr_down_tap": (pkg.gaussian_stage(3), pkg.pyr_down_stage(tap=0)),
        "mixed": (pkg.box_stage(1), pkg.gaussian_stage(3, tap=0), pkg.dilate_stage(1),
                  pkg.affine_stage(0.5, 3.25), pkg.filter_stage(K, tap=-1)),
    }[name]


def _outer(pkg, k):
    if pkg is jstencil:
        k1 = jref.gaussian_kernel1d(k)
        return jnp.outer(k1, k1)
    k1 = tref.gaussian_kernel1d(k)
    return torch.outer(k1, k1)


SINGLE_OPS = ["filter2d", "sep_filter", "box", "erode", "dilate", "threshold", "affine"]
EXACT = {"erode", "dilate", "threshold", "erode_r3"}
SLICE_CHAINS = ["gaussian_filter2d_k13", "erode_r3", "acceptance", "preprocess", "octave",
                "octave_nb", "pyr_down", "pyr_down_tap"]
LAYOUTS = {"hw": (37, 53), "hwc": (37, 53, 3), "bhwc": (2, 40, 72, 3)}


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * 255.0


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _assert_like_jax(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= U8_OFF_BY_ONE, f"{int((diff > 0).sum())} pixels off by one"
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Parity with the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("layout", ["hw", "hwc"])
@pytest.mark.parametrize("fn", ["filter2d", "sep_filter2d", "erode", "dilate"])
def test_per_op_refs_match_jax(fn, layout, dtype):
    x = _input(LAYOUTS[layout], dtype, seed=1)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if fn == "filter2d":
        want, got = jref.filter2d_ref(j, jnp.asarray(_K53)), tref.filter2d_ref(t, _K53)
    elif fn == "sep_filter2d":
        want = jref.sep_filter2d_ref(j, jnp.asarray(_KX), jnp.asarray(_KY))
        got = tref.sep_filter2d_ref(t, _KX, _KY)
    elif fn == "erode":
        want, got = jref.erode_ref(j, 2), tref.erode_ref(t, 2)
    else:
        want, got = jref.dilate_ref(j, 1), tref.dilate_ref(t, 1)
    _assert_like_jax(got.numpy(), want, fn in ("erode", "dilate"))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("op", SINGLE_OPS)
def test_single_op_chains_match_jax(op, layout, dtype):
    x = _input(LAYOUTS[layout], dtype, seed=2)
    want = jref.chain_ref(jnp.asarray(x), _stages(jstencil, op))
    got = tstencil.fused_chain(torch.from_numpy(x), _stages(tstencil, op))
    _assert_like_jax(got.numpy(), want, op in EXACT)


SLICE_CASES = [
    ("gaussian_filter2d_k13", "u8", (37, 53)),
    ("gaussian_filter2d_k13", "f32", (37, 53)),
    ("erode_r3", "u8", (37, 53)),
    ("erode_r3", "f32", (37, 53)),
    ("acceptance", "u8", (2, 40, 72, 3)),
    ("acceptance", "f32", (2, 40, 72, 3)),
    ("preprocess", "f32", (2, 40, 72, 3)),
    ("preprocess", "u8", (2, 40, 72, 3)),
    ("octave", "f32", (48, 56)),
    ("mixed", "u8", (2, 21, 30, 2)),
    ("mixed", "f32", (2, 21, 30, 2)),
    ("octave_nb", "f32", (45, 39)),
    ("pyr_down", "u8", (2, 37, 53, 3)),
    ("pyr_down", "f32", (37, 53)),
    ("pyr_down_tap", "u8", (2, 21, 30, 2)),
]


@pytest.mark.parametrize("name,dtype,shape", SLICE_CASES)
@pytest.mark.parametrize("mode", [None, "window", "streaming", "tiled2d", "ref"])
def test_slice_chains_match_jax_in_every_mode(name, dtype, shape, mode):
    x = _input(shape, dtype, seed=3)
    want = _tuple(jref.chain_ref(jnp.asarray(x), _stages(jstencil, name)))
    got = _tuple(tstencil.fused_chain(torch.from_numpy(x), _stages(tstencil, name), mode=mode))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_like_jax(g.numpy(), w, name in EXACT)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_ops_and_imgproc_aliases_match_jax(dtype):
    x = _input((2, 23, 31, 3), dtype, seed=4)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    k1 = jref.gaussian_kernel1d(7)
    cases = [
        (tops.gaussian_filter2d(t, 7), jref.chain_ref(j, (jstencil.filter_stage(jnp.outer(k1, k1)),)),
         False),
        (tops.gaussian_blur(t, 7), jref.chain_ref(j, (jstencil.gaussian_stage(7),)), False),
        (tops.filter2d(t, _K53), jref.chain_ref(j, (jstencil.filter_stage(jnp.asarray(_K53)),)),
         False),
        (tops.sep_filter2d(t, _KX, _KY),
         jref.chain_ref(j, (jstencil.sep_filter_stage(jnp.asarray(_KX), jnp.asarray(_KY)),)),
         False),
        (tops.erode(t, 1), jref.chain_ref(j, (jstencil.erode_stage(1),)), True),
        (tops.dilate(t, 2), jref.chain_ref(j, (jstencil.dilate_stage(2),)), True),
        (tops.threshold(t, 127.5), jref.chain_ref(j, (jstencil.threshold_stage(127.5),)), True),
        (tops.box_blur(t, 1), jref.chain_ref(j, (jstencil.box_stage(1),)), False),
    ]
    for got, want, exact in cases:
        _assert_like_jax(got.numpy(), want, exact)
    for name in ("filter2d", "sep_filter2d", "gaussian_blur", "gaussian_filter2d", "erode",
                 "dilate", "threshold", "box_blur"):
        assert getattr(timgproc, name) is getattr(tops, name)
    assert timgproc.fused_chain is tstencil.fused_chain


def test_threshold_binds_a_fractional_threshold_on_u8():
    x = torch.arange(120, 136, dtype=torch.uint8).reshape(4, 4)
    got = tops.threshold(x, 127.5, 300.0)
    assert torch.equal(got, torch.where(x >= 128, 255, 0).to(torch.uint8))


# ---------------------------------------------------------------------------
# Plans: the port's row walk and carry plan equal JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SLICE_CHAINS)
@pytest.mark.parametrize("rows", [8, 16, 32])
def test_chain_iface_and_stream_plan_match_jax(name, rows):
    jp = jstencil.resolve_chain(_stages(jstencil, name))
    tp = tstencil.resolve_chain(_stages(tstencil, name))
    ji = jstencil.chain_iface(jp, rows)
    ti = tstencil.chain_iface(tp, rows)
    assert ti == ji
    assert tstencil.chain_stream_plan(tp, ti) == jstencil.chain_stream_plan(jp, ji)


def test_stream_layout_of_the_preprocess_chain():
    """Input ring 8 + 2*2 rows, the blur's and the erosion's 8 + 2*1; the
    magnitude is stored from registers; scratch for the 5-tap row pass."""
    lay = plan.stream_layout(_stages(tstencil, "preprocess"), 8)
    assert lay.leads == (4, 2, 1, 0)
    assert lay.depths == (12, 10, 10, 0)
    assert lay.outs == (3,) and lay.scratch_rows == 12
    assert lay.smem_bytes(32) == 44 * 40 * 4


def test_stream_layout_delays_the_octave_bands():
    """Each ladder band is read by the next tap 2*halo rows behind its newest
    row, and stored `lead` rows behind it: its ring is rows + lead deep,
    the delay FIFOs of the tap stages it passes folded into that depth."""
    chain = _stages(tstencil, "octave")
    lay = plan.stream_layout(chain, 8)
    assert lay.halo == (34, 34) and len(lay.outs) == 7
    walk = tstencil.resolve_chain(chain)
    for b, s in enumerate(lay.outs[:-1]):
        ring = 2 * walk[b + 1][2][0]  # the next tap reads 2*halo rows back
        assert lay.depths[s] == 8 + max(lay.leads[s], ring)
    assert lay.depths[lay.outs[-1]] == 0
    # the sum of the tap delays a band crosses is its lead
    d_rows = [d for *_, d in tstencil.chain_stream_plan(walk, tstencil.chain_iface(walk, 8))]
    assert lay.leads[lay.outs[0]] == sum(d_rows[1:])


# ---------------------------------------------------------------------------
# Mode resolution
# ---------------------------------------------------------------------------

def test_mode_resolution_rules():
    pre = _stages(tstencil, "preprocess")
    f32 = torch.float32
    assert driver.resolve_mode(pre, (768, 32, 32), f32) == "streaming"
    assert driver.resolve_mode(pre, (2, 4, 40), f32) == "window"  # planes <= halo
    assert driver.resolve_mode(_stages(tstencil, "threshold"), (1, 64, 64), f32) == "window"
    assert driver.resolve_mode(_stages(tstencil, "octave"), (1, 32, 32), f32) == "window"
    assert driver.resolve_mode(_stages(tstencil, "octave"), (1, 512, 512), f32) == "tiled2d"
    assert driver.resolve_mode(_stages(tstencil, "octave_nb"), (1, 512, 512), f32) == "tiled2d"
    assert driver.resolve_mode(_stages(tstencil, "octave_nb"), (1, 36, 36), f32) == "window"
    assert driver.resolve_mode(_stages(tstencil, "octave_nb"), (1, 37, 37), f32) == "streaming"
    pyr = _stages(tstencil, "pyr_down")
    assert driver.resolve_mode(pyr, (1, 1080, 1920), torch.uint8) == "streaming"
    assert driver.resolve_mode(pyr, (1, 2160, 3840), torch.uint8) == "tiled2d"
    k13 = _stages(tstencil, "gaussian_filter2d_k13")
    assert driver.resolve_mode(k13, (1, 1080, 1920), torch.uint8) == "streaming"
    assert driver.resolve_mode(k13, (1, 2160, 3840), torch.uint8) == "tiled2d"
    assert driver.resolve_mode(_stages(tstencil, "erode_r3"), (1, 4320, 7680), torch.uint8) \
        == "tiled2d"


def test_mode_none_on_cpu_runs_the_resolved_kernels_plain_version():
    counters.reset()
    tstencil.fused_chain(torch.zeros((2, 32, 32, 3)), _stages(tstencil, "preprocess"))
    tstencil.fused_chain(torch.zeros((32, 32)), _stages(tstencil, "octave"))
    assert counters.PLAIN_CALLS["stencil_stream"] == 1
    assert counters.PLAIN_CALLS["stencil_chain"] == 1
    assert sum(counters.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", [None, "window", "streaming", "ref"])
def test_tile_w_outside_tiled2d_raises(mode):
    with pytest.raises(ValueError, match="tile_w"):
        tstencil.fused_chain(torch.zeros((16, 16)), _stages(tstencil, "erode"), mode=mode,
                             tile_w=8)


def test_streaming_over_the_budget_raises_naming_the_bytes():
    """An explicit full-width streaming plan never shrinks its geometry."""
    x = torch.zeros((2160, 3840), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"full-width rings .* need \d+ bytes"):
        tstencil.fused_chain(x, _stages(tstencil, "gaussian_filter2d_k13"), mode="streaming")
    small = LaunchConfig(smem_budget=16 * 1024)
    with pytest.raises(ValueError, match="bytes"):
        tstencil.fused_chain(torch.zeros((40, 300)), _stages(tstencil, "preprocess"),
                             mode="streaming", lc=small)
    counters.reset()
    tstencil.fused_chain(torch.zeros((40, 300)), _stages(tstencil, "preprocess"),
                         mode="tiled2d", lc=small)
    assert counters.PLAIN_CALLS["stencil_stream"] == 1


def test_launch_config_stream_knobs_validate():
    for bad in ({"stream_rows": 0}, {"stream_rows": 65}, {"tile2d_cols": 0},
                {"row_segments": -1}, {"row_segments": 2.5}):
        with pytest.raises(ValueError):
            LaunchConfig(**bad)


def test_row_segment_rule():
    # one 1080p plane: segments of two 8-row steps, 68 blocks
    assert plan.row_segments(1, 1, 1080, 8, 132) == (68, 16)
    # 768 small planes already fill the card: one segment each
    assert plan.row_segments(768, 1, 32, 8, 132) == (1, 32)
    # an octave plane in 3 tiles: 32 segments, whatever its 34-row halo
    assert plan.row_segments(1, 3, 512, 8, 132) == (32, 16)
    # an 8K plane in 30 tiles: about two blocks per SM
    assert plan.row_segments(1, 30, 4320, 8, 132) == (9, 480)
    assert plan.fix_segments(4, 37, 8) == (3, 16)
    assert plan.fix_segments(1, 5, 8) == (1, 8)


# ---------------------------------------------------------------------------
# The kernel's block loop, replayed in numpy from the planned program
# ---------------------------------------------------------------------------

def _emulate_stream(planes: np.ndarray, prog, geom) -> np.ndarray:
    N, H, W = planes.shape
    lay = prog.layout
    m = lay.rows
    ph, pw = lay.halo
    WW = geom.tile_w + 2 * pw
    wts = np.asarray(prog.weights, np.float32)
    u8 = planes.dtype == np.uint8
    streams = prog.streams
    n_half = sum(d > 1 for d in prog.downs)
    out = np.full((prog.n_bands - n_half, N, H, W), np.nan)
    half = np.full((n_half, N, (H + 1) // 2, (W + 1) // 2), np.nan)

    def pack(v):
        return np.clip(np.rint(v), 0, 255).astype(np.float32) if u8 else v

    def rr(s, rows):
        return streams[s]["offset"] + np.mod(rows, streams[s]["depth"])

    for n in range(N):
        for t in range(geom.n_tiles):
            for sg in range(geom.n_seg):
                sm = np.full((prog.smem_rows, WW), np.nan, np.float32)
                tx0, y0 = t * geom.tile_w, sg * geom.seg_rows
                tw, y1 = min(geom.tile_w, W - tx0), min(y0 + geom.seg_rows, H)
                xs = np.clip(tx0 - pw + np.arange(WW), 0, W - 1)
                for i in range((-2 * ph) // m, -(-(y1 - y0) // m)):
                    rows = np.arange(max(y0 + i * m + ph, y0 - ph), y0 + (i + 1) * m + ph)
                    sm[rr(0, rows)] = planes[n][np.clip(rows, 0, H - 1)][:, xs]
                    for st in prog.steps:
                        lo = max(y0 + i * m + st["lead"], y0 - st["lead"])
                        hi = y0 + (i + 1) * m + st["lead"]
                        if lo >= hi:
                            continue
                        hy, hx, op = st["kh"] // 2, st["kw"] // 2, st["op"]
                        c0, c1 = pw - st["rw"] + hx, pw + geom.tile_w + st["rw"] - hx
                        nr = hi - lo
                        X = sm[rr(st["src"], np.arange(lo - hy, hi + hy))]
                        w0 = wts[st["wx"]:]
                        if st["down"] > 1:  # pyrDown: image-even rows and columns -> half
                            ox = tx0 - pw  # image column of local column 0
                            cols = np.arange(c0 + (ox + c0) % 2, c1, 2)
                            rows_e = np.arange(lo + lo % 2, hi, 2)
                            ky = wts[st["wy"]:]
                            acc = w0[0] * X[:, cols - hx]
                            for q in range(1, 5):
                                acc = acc + w0[q] * X[:, cols - hx + q]
                            v = ky[0] * acc[rows_e - lo]
                            for q in range(1, 5):
                                v = v + ky[q] * acc[rows_e - lo + q]
                            v = pack(v)
                            keep_r = (rows_e >= y0) & (rows_e < y1)
                            keep_c = (ox + cols >= tx0) & (ox + cols < tx0 + tw)
                            half[st["store"], n, rows_e[keep_r][:, None] // 2,
                                 (ox + cols[keep_c])[None, :] // 2] = v[keep_r][:, keep_c]
                            continue
                        if op in (0, 1, 5, 6):  # separable: row pass -> scratch
                            taps = [X[:, c0 - hx + q:c1 - hx + q] for q in range(st["kw"])]
                            acc = w0[0] * taps[0] if op == 0 else taps[0]
                            for q in range(1, st["kw"]):
                                acc = (acc + w0[q] * taps[q] if op == 0 else acc + taps[q]
                                       if op == 6 else np.minimum(acc, taps[q]) if op == 1
                                       else np.maximum(acc, taps[q]))
                            sm[prog.scratch:prog.scratch + nr + 2 * hy, c0:c1] = acc
                            T = sm[prog.scratch:prog.scratch + nr + 2 * hy, c0:c1]
                            ky = wts[st["wy"]:]
                            acc = ky[0] * T[0:nr] if op == 0 else T[0:nr]
                            for q in range(1, st["kh"]):
                                c = T[q:q + nr]
                                acc = (acc + ky[q] * c if op == 0 else acc + c if op == 6
                                       else np.minimum(acc, c) if op == 1 else np.maximum(acc, c))
                            v = acc * w0[0] if op == 6 else acc
                        elif op == 4:  # filter2d, taps row-major
                            kw = st["kw"]
                            v = w0[0] * X[0:nr, c0 - hx:c1 - hx]
                            for a in range(st["kh"]):
                                for b in range(kw):
                                    if a or b:
                                        v = v + w0[a * kw + b] * X[a:a + nr, c0 - hx + b:c1 - hx + b]
                        elif op == 2:
                            dy = (X[2:, c0:c1] - X[:-2, c0:c1]) * np.float32(0.5)
                            dx = (X[1:-1, c0 + 1:c1 + 1] - X[1:-1, c0 - 1:c1 - 1]) * np.float32(0.5)
                            v = np.sqrt(dx * dx + dy * dy)
                        elif op == 7:
                            v = np.where(X[:, c0:c1] > w0[0], w0[1], np.float32(0)).astype(np.float32)
                        else:
                            v = X[:, c0:c1] * w0[0] + w0[1]
                        v = pack(v)
                        if st["dst"] >= 0:
                            sm[rr(st["dst"], np.arange(lo, hi)), c0:c1] = v
                        else:
                            for a, r in enumerate(range(lo, hi)):
                                if y0 <= r < y1:
                                    out[st["store"], n, r, tx0:tx0 + tw] = v[a, pw - c0:pw - c0 + tw]
                    if i >= 0:
                        rows = np.arange(y0 + i * m, min(y0 + (i + 1) * m, y1))
                        for s, stream in enumerate(streams):
                            if stream["store"] >= 0:
                                out[stream["store"], n, rows, tx0:tx0 + tw] = \
                                    sm[rr(s, rows), pw:pw + tw]
    slots = exec_window.store_slots(prog.downs)
    return [(out if d == 1 else half)[i] for d, i in zip(prog.downs, slots)]


REPLAY = [
    ("preprocess", "f32", (3, 37, 29), {}),
    ("preprocess", "u8", (2, 37, 29), {"tiled": True, "tile_w": 8}),
    ("acceptance", "u8", (2, 45, 40), {"segments": 3}),
    ("gaussian_filter2d_k13", "u8", (1, 37, 53), {"segments": 4, "rows": 4}),
    ("erode_r3", "f32", (1, 37, 53), {"tiled": True, "tile_w": 16, "segments": 2}),
    ("octave", "f32", (1, 75, 40), {"segments": 2}),
    ("octave", "f32", (1, 40, 70), {"tiled": True, "tile_w": 32}),
    ("mixed", "u8", (2, 21, 30), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 3}),
    ("threshold", "u8", (1, 9, 11), {"rows": 4}),
    ("octave_nb", "f32", (1, 75, 41), {"segments": 2}),
    ("octave_nb", "f32", (1, 41, 71), {"tiled": True, "tile_w": 32, "segments": 2}),
    ("pyr_down", "u8", (2, 37, 53), {"tiled": True, "tile_w": 16, "segments": 3}),
    ("pyr_down", "f32", (1, 5, 5), {"rows": 2}),
    ("pyr_down_tap", "u8", (1, 39, 45), {"tiled": True, "tile_w": 8, "segments": 2,
                                         "rows": 4}),
]


@pytest.mark.parametrize("name,dtype,shape,opts", REPLAY)
def test_kernel_loop_reproduces_plain_version(name, dtype, shape, opts):
    """Every band of the planned program, replayed block by block with the
    rings primed per segment, equals the plain version bit for bit; stores
    cover every pixel once and no step reads a row its ring never held
    (the NaN the rings start with would propagate)."""
    chain = _stages(tstencil, name)
    x = torch.from_numpy(_input(shape, dtype, seed=5))
    lc = LaunchConfig(stream_rows=opts.get("rows", 8), row_segments=opts.get("segments", 1))
    prog, _ = exec_streaming.program(chain, lc.stream_rows, x.dtype, x.device)
    geom = exec_streaming.stream_geometry(prog, tuple(x.shape), lc,
                                          tiled=opts.get("tiled", False),
                                          tile_w=opts.get("tile_w"))
    assert (geom.n_seg > 1) == ("segments" in opts)
    got = _emulate_stream(x.numpy(), prog, geom)
    want = exec_streaming.stencil_stream_plain(x, chain)
    assert len(want) == prog.n_bands
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[k], w.numpy().astype(np.float64))


def test_compile_stream_for_the_acceptance_chain():
    prog = exec_streaming.compile_stream(_stages(tstencil, "acceptance"), 8, torch.uint8)
    ops = [st["op"] for st in prog.steps]
    assert ops == [0, 1, 7]
    assert [st["dst"] for st in prog.steps] == [1, 2, -1]  # threshold stored from registers
    assert prog.weights[-2:] == (100.0, 255.0)
    assert prog.smem_rows == sum(s["depth"] for s in prog.streams) + prog.layout.scratch_rows
    assert exec_streaming.PROGRAM_BYTES <= 48 * 1024  # static shared memory


@pytest.mark.parametrize("shape,threads", [((768, 32, 32), 256), ((1, 64, 8), 64),
                                           ((1, 1080, 960), 1024)])
def test_stream_threads_follow_one_steps_work(shape, threads):
    """A block takes `MAX_THREADS`, halved while they are at least as
    many as one step's values (8 rows of a 40-column window: 256)."""
    prog, _ = exec_streaming.program(_stages(tstencil, "preprocess"), 8, torch.float32,
                                     torch.device("cpu"))
    geom = exec_streaming.stream_geometry(prog, shape, LaunchConfig(), tiled=False)
    assert geom.threads == threads
