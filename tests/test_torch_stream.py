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
from repro_torch.kernels.stencil import driver, exec_streaming, plan

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
        # pyrUp and strides before a chain's last stage (tests/test_streaming.py:56-80, :224)
        "pyr_up": (pkg.pyr_up_stage(),),
        "up_gauss5": (pkg.pyr_up_stage(), pkg.gaussian_stage(5)),
        "down_up": (pkg.pyr_down_stage(), pkg.pyr_up_stage()),
        "pyr_down_map": (pkg.gaussian_stage(5), pkg.pyr_down_stage(), pkg.erode_stage(1)),
        "resize2_mid": (pkg.resize2_stage(), pkg.gaussian_stage(3)),
        "up_down_tap": (pkg.pyr_up_stage(), pkg.gaussian_stage(3), pkg.pyr_down_stage(tap=0)),
        "down_sobel_grad": (pkg.pyr_down_stage(), pkg.sobel_stage(), pkg.grad_stage()),
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
LEVEL_CHAINS = ["pyr_up", "up_gauss5", "down_up", "pyr_down_map", "resize2_mid", "up_down_tap",
                "down_sobel_grad"]
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
    magnitude is stored from registers; the blur and the erosion run
    register strips, so no stage needs row-pass scratch."""
    lay = plan.stream_layout(_stages(tstencil, "preprocess"), 8)
    assert lay.leads == (4, 2, 1, 0)
    assert lay.depths == (12, 10, 10, 0)
    assert lay.outs == (3,) and lay.scratch_rows == 0
    assert lay.strips == (True, True, False) and lay.rd0 == 0
    assert lay.esizes == (4, 4, 4, 4) and lay.col_pads == (4,)
    # 16 bytes before the first ring; rows of 32 + 2*4 f32 values and 16 bytes of slack
    assert lay.smem_bytes(32) == 16 + 32 * (40 * 4 + 16)


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
    assert driver.resolve_mode(pyr, (1, 2160, 3840), torch.uint8) == "tiled2d"  # f32 scratch
    k13 = _stages(tstencil, "gaussian_filter2d_k13")
    assert driver.resolve_mode(k13, (1, 1080, 1920), torch.uint8) == "streaming"
    # u8 rings: a quarter of the f32 bytes, so 4K and 8K u8 stream at full width
    assert driver.resolve_mode(k13, (1, 2160, 3840), torch.uint8) == "streaming"
    assert driver.resolve_mode(k13, (1, 2160, 3840), f32) == "tiled2d"
    assert driver.resolve_mode(_stages(tstencil, "erode_r3"), (1, 4320, 7680), torch.uint8) \
        == "streaming"


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
    x = torch.zeros((2160, 3840), dtype=torch.float32)
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
    # one 1080p plane: two-step segments would give 67 blocks, under two an
    # SM, so segments of one 8-row step
    assert plan.row_segments(1, 1, 1080, 8, 132) == (135, 8)
    # one 4K plane: 264 blocks wanted, 270 one-step segments
    assert plan.row_segments(1, 1, 2160, 8, 132) == (270, 8)
    # 768 small planes already fill the card: one segment each
    assert plan.row_segments(768, 1, 32, 8, 132) == (1, 32)
    # an octave plane in 3 tiles: 64 one-step segments where the chain
    # primes in a step or two; 32 two-step ones under its 34-row halo (9
    # priming steps)
    assert plan.row_segments(1, 3, 512, 8, 132) == (64, 8)
    assert plan.row_segments(1, 3, 512, 8, 132, prime=9) == (32, 16)
    # an 8K plane in 30 tiles: about two blocks per SM
    assert plan.row_segments(1, 30, 4320, 8, 132) == (9, 480)
    # 24 planes where an SM holds four blocks: 528 blocks
    assert plan.row_segments(24, 1, 512, 8, 132, 4) == (22, 24)
    assert plan.fix_segments(4, 37, 8) == (3, 16)
    assert plan.fix_segments(1, 5, 8) == (1, 8)


# ---------------------------------------------------------------------------
# The kernel's block loop, replayed in numpy from the planned program
# ---------------------------------------------------------------------------

F32 = np.float32


def _pack(v, pk):
    return np.clip(np.rint(v), 0, 255).astype(F32) if pk else np.asarray(v, F32)


def _strip_filter2d(X, w, K, nr, c0, c1):
    """The kernel's filter2d strip over output rows [0, nr) at columns [c0,
    c1): X holds the nr + K - 1 source rows; each source row in turn adds
    its taps to every output row that reads it, starting from -0."""
    H = K // 2
    acc = np.full((nr, c1 - c0), -0.0, F32)
    for s in range(nr + K - 1):
        for r in range(max(0, s - K + 1), min(nr, s + 1)):
            a = s - r
            for b in range(K):
                acc[r] = acc[r] + w[a * K + b] * X[s, c0 - H + b:c1 - H + b]
    return acc


def _strip_sep(op, X, kx, ky, K, nr, c0, c1):
    """The kernel's separable strip: each source row's row pass, then its
    turn in the column pass of every output row that reads it (sums from
    -0, erode from +inf, dilate from -inf); box scales at the end."""
    H = K // 2
    init = {0: -0.0, 6: -0.0, 1: np.inf, 5: -np.inf}[op]
    acc = np.full((nr, c1 - c0), init, F32)
    for s in range(nr + K - 1):
        taps = [X[s, c0 - H + q:c1 - H + q] for q in range(K)]
        rp = kx[0] * taps[0] if op == 0 else taps[0]
        for q in range(1, K):
            rp = (rp + kx[q] * taps[q] if op == 0 else rp + taps[q] if op == 6
                  else np.minimum(rp, taps[q]) if op == 1 else np.maximum(rp, taps[q]))
        for r in range(max(0, s - K + 1), min(nr, s + 1)):
            c = ky[s - r] * rp if op == 0 else rp
            acc[r] = (acc[r] + c if op in (0, 6) else np.minimum(acc[r], c) if op == 1
                      else np.maximum(acc[r], c))
    return acc * kx[0] if op == 6 else acc


def _emulate_stream(planes: np.ndarray, prog, geom, maps=()) -> list:
    """Replay of `stencil_stream_kernel`: per (plane, tile, segment) block,
    the steps from the priming ones on, each stage's new rows at its level
    from its ring(s), direct stores from registers and the stores of
    ring-held bands, into each band's own buffer.  Rings hold their
    stream's dtype (a u8 ring takes only integers in [0, 255]); the strip
    stages run the kernel's register-strip order; stream 0's rows of the
    next step are written when the kernel issues their copies (a step
    ahead, into the deeper ring, or once the last stage that reads stream 0
    is done), so a copy that overwrote a row still read would show; every
    read and ring write must fall in the rows the ring holds at that step,
    which the kernel's slot arithmetic assumes.  `maps`: each remap
    stage's (map_x, map_y), in chain order."""
    from test_torch_stencil import (
        _bilinear, _col_pass, _floor2, _gather_coords, _pyr_even, _pyr_odd, _row_pass, _sobel,
    )

    N, H, W = planes.shape
    lay = prog.layout
    lv = lay.lv
    m, last = lay.rows, lv.n_levels - 1
    wts = np.asarray(prog.weights, F32)
    streams = prog.streams
    outs = [np.full((N, *tstencil.plan.band_hw(ops, H, W)), np.nan) for _dt, ops in prog.bands]
    tws = [lv.tile(lvl, 1, geom.tile_w)[1] for lvl in range(lv.n_levels)]
    pads = lay.col_pads
    widths = [tws[lvl] + 2 * pads[lvl] for lvl in range(lv.n_levels)]
    HT, WT = lv.size(last, H, W)
    depths = [st["depth"] + (st["mult"] if geom.ahead and k == 0 else 0)
              for k, st in enumerate(streams)]

    for n in range(N):
        for t in range(geom.n_tiles):
            for sg in range(geom.n_seg):
                rings = [np.full((d, widths[st["level"]]), np.nan, F32)
                         for d, st in zip(depths, streams)]
                tx0 = t * tws[last]
                oxT = tx0 - pads[last]
                tw = min(tws[last], WT - tx0)
                y0 = sg * geom.seg_rows
                y1 = min(y0 + geom.seg_rows, HT)
                step0 = y0 // m
                n_last = -(-(y1 - y0) // m)
                i = -lay.prime_steps

                def origin(lvl):
                    return t * tws[lvl] - pads[lvl]

                def held(k, rows):
                    newest = (step0 + i + 1) * streams[k]["mult"] + streams[k]["lead"] - 1
                    rows = np.asarray(rows)
                    assert ((rows > newest - depths[k]) & (rows <= newest)).all(), \
                        f"stream {k} at step {i}: rows {rows} outside its ring"
                    return np.mod(rows, depths[k])

                def rr(k, rows):
                    return rings[k][held(k, rows)]

                def write(k, rows, c0, c1, val):
                    if streams[k]["u8"]:
                        assert np.all((val == np.rint(val)) & (val >= 0) & (val <= 255))
                        val = val.astype(np.uint8).astype(F32)
                    rings[k][held(k, rows), c0:c1] = val

                def load(step):  # stream 0's rows of `step`, clamped at the image's edges
                    st0 = streams[0]
                    Y0 = step0 * st0["mult"]
                    rows = np.arange(max(Y0 + step * st0["mult"] + st0["lead"], Y0 - st0["lead"]),
                                     Y0 + (step + 1) * st0["mult"] + st0["lead"])
                    xs = np.clip(origin(0) + np.arange(widths[0]), 0, W - 1)
                    rings[0][np.mod(rows, depths[0])] = planes[n][np.clip(rows, 0, H - 1)][:, xs]
                def step(st, lo, hi):
                    """One stage application's rows [lo, hi) at its level."""
                    hy, hx, op, pk = st["kh"] // 2, st["kw"] // 2, st["op"], st["pk"]
                    pw, oxd, ox = pads[st["lo"]], origin(st["lo"]), origin(st["ls"])
                    c0, c1 = pw - st["cw"], pw + tws[st["lo"]] + st["cw"]
                    nr = hi - lo
                    w0 = wts[st["wx"]:]
                    v2 = None
                    if op == 15:  # pyrUp: row phases, then column phases
                        Y = np.arange(lo, hi)
                        x0 = _floor2(oxd + c0) - 1 - ox
                        x1 = _floor2(oxd + c1 - 1) + 2 - ox
                        a, b, c = (rr(st["src"], _floor2(Y) + d)[:, x0:x1] for d in (-1, 0, 1))
                        T = np.full((nr, widths[st["ls"]]), np.nan, F32)
                        T[:, x0:x1] = np.where((Y & 1)[:, None] == 1, _pyr_odd(b, c),
                                               _pyr_even(a, b, c))
                        X = oxd + np.arange(c0, c1)
                        q = _floor2(X) - ox
                        v = np.where((X & 1)[None, :] == 1, _pyr_odd(T[:, q], T[:, q + 1]),
                                     _pyr_even(T[:, q - 1], T[:, q], T[:, q + 1]))
                        v = _pack(v, pk)
                    elif op in (9, 12) and st["down"] == 1:  # a stride before the last
                        Y = np.arange(lo, hi)
                        xs_ = 2 * (oxd + np.arange(c0, c1)) - ox
                        if op == 9:
                            ra = 2 * lo - hy
                            X = rr(st["src"], np.arange(ra, 2 * (hi - 1) + hy + 1))
                            cols = np.stack([X[:, x - hx:x + hx + 1] for x in xs_], axis=1)
                            acc = _row_pass(op, cols, w0, st["kw"])[..., 0]
                            v = np.stack([_col_pass(op, acc[2 * a:2 * a + st["kh"]],
                                                    wts[st["wy"]:], st["kh"], None)[0]
                                          for a in range(nr)])
                        else:
                            A, B = rr(st["src"], 2 * Y), rr(st["src"], 2 * Y + 1)
                            v = ((A[:, xs_] + B[:, xs_]) + (A[:, xs_ + 1] + B[:, xs_ + 1])) \
                                * F32(0.25)
                        v = _pack(v, pk)
                    elif op in (9, 12):  # strided last: image-even rows and columns -> own band
                        X = rr(st["src"], np.arange(lo - hy, hi + hy))
                        band = outs[st["store"]]
                        cols = np.arange(c0 + (ox + c0) % 2, c1 - (op == 12), 2)
                        rows_e = np.arange(lo + lo % 2, hi - (op == 12), 2)
                        if op == 9:
                            ky = wts[st["wy"]:]
                            acc = w0[0] * X[:, cols - hx]
                            for q in range(1, 5):
                                acc = acc + w0[q] * X[:, cols - hx + q]
                            v = ky[0] * acc[rows_e - lo]
                            for q in range(1, 5):
                                v = v + ky[q] * acc[rows_e - lo + q]
                        else:
                            a, b = X[rows_e - lo][:, cols], X[rows_e - lo + 1][:, cols]
                            c, d = X[rows_e - lo][:, cols + 1], X[rows_e - lo + 1][:, cols + 1]
                            v = ((a + b) + (c + d)) * F32(0.25)
                        v = _pack(v, pk)
                        keep_r = (rows_e >= y0) & (rows_e < y1) & (rows_e // 2 < band.shape[1])
                        keep_c = ((ox + cols >= tx0) & (ox + cols < tx0 + tw)
                                  & ((ox + cols) // 2 < band.shape[2]))
                        band[n, rows_e[keep_r][:, None] // 2,
                             (ox + cols[keep_c])[None, :] // 2] = v[keep_r][:, keep_c]
                        return
                    else:
                        X = rr(st["src"], np.arange(lo - hy, hi + hy))
                        if st["strip"] and op == 4:  # register strips
                            v = _pack(_strip_filter2d(X, w0, st["kh"], nr, c0, c1), pk)
                        elif st["strip"] and op in (0, 1, 5, 6):
                            v = _pack(_strip_sep(op, X, w0, wts[st["wy"]:], st["kh"], nr, c0,
                                                 c1), pk)
                        elif op in (0, 1, 5, 6):  # separable: row pass -> scratch
                            # (even taps read one column and row fewer than 2 * halo)
                            kw, kh = st["kw"], st["kh"]
                            acc = _row_pass(op, X[:nr + kh - 1, c0 - hx:c1 - hx + kw - 1], w0, kw)
                            v = _pack(_col_pass(op, acc, wts[st["wy"]:], kh,
                                                w0[0] if op == 6 else None), pk)
                        elif op == 4:  # filter2d, taps row-major
                            kw = st["kw"]
                            v = w0[0] * X[0:nr, c0 - hx:c1 - hx]
                            for a in range(st["kh"]):
                                for b in range(kw):
                                    if a or b:
                                        v = v + w0[a * kw + b] * X[a:a + nr,
                                                                   c0 - hx + b:c1 - hx + b]
                            v = _pack(v, pk)
                        elif op == 2:
                            dy = (X[2:, c0:c1] - X[:-2, c0:c1]) * F32(0.5)
                            dx = (X[1:-1, c0 + 1:c1 + 1] - X[1:-1, c0 - 1:c1 - 1]) * F32(0.5)
                            v = _pack(np.sqrt(dx * dx + dy * dy), pk)
                        elif op == 10:
                            v, v2 = _sobel(X[:, c0 - 1:c1 + 1])
                        elif op == 11:
                            Y2 = rr(st["src2"], np.arange(lo, hi))
                            a, b = X[:, c0:c1], Y2[:, c0:c1]
                            v = _pack(np.sqrt(a * a + b * b), pk)
                        elif op in (13, 14):
                            ii, jj = np.meshgrid(np.arange(lo, hi), np.arange(c0, c1),
                                                 indexing="ij")
                            lh, lw = lv.size(st["ls"], H, W)
                            sy, sx = _gather_coords(op, w0, maps, st["wx"], ii, ox + jj, lh, lw)
                            # X holds rows [lo - hy, hi + hy): local row 0 is image row lo - hy
                            v = _bilinear(X, sy, sx, lo - hy, ox, 0, nr + 2 * hy, c0 - hx,
                                          c1 + hx)
                            v = _pack(v, pk)
                        elif op == 7:
                            v = _pack(np.where(X[:, c0:c1] > w0[0], w0[1], F32(0)), pk)
                        else:
                            v = _pack(X[:, c0:c1] * w0[0] + w0[1], pk)
                    for val, dst, store in ((v, st["dst"], st["store"]),
                                            (v2, st["dst2"], st["store2"])):
                        if val is None:
                            continue
                        if dst >= 0:
                            write(dst, np.arange(lo, hi), c0, c1, val)
                        elif store >= 0:
                            for a, r in enumerate(range(lo, hi)):
                                if y0 <= r < y1:
                                    outs[store][n, r, tx0:tx0 + tw] = \
                                        val[a, pads[last] - c0:pads[last] - c0 + tw]

                load(i)
                for i in range(-lay.prime_steps, n_last):
                    if geom.ahead and i + 1 < n_last:
                        load(i + 1)
                    for si, st in enumerate(prog.steps):
                        Y0 = step0 * st["mult"]
                        lo = max(Y0 + i * st["mult"] + st["lead"], Y0 - st["lead"])
                        hi = Y0 + (i + 1) * st["mult"] + st["lead"]
                        if lo < hi:
                            step(st, lo, hi)
                        if not geom.ahead and si == lay.rd0 and i + 1 < n_last:
                            load(i + 1)
                    if i >= 0:
                        rows = np.arange(y0 + i * m, min(y0 + (i + 1) * m, y1))
                        for k, stream in enumerate(streams):
                            if stream["store"] >= 0 and stream["depth"] > 0:
                                outs[stream["store"]][n, rows, tx0:tx0 + tw] = \
                                    rr(k, rows)[:, pads[last]:pads[last] + tw]
                    if not geom.ahead and lay.rd0 >= len(prog.steps) and i + 1 < n_last:
                        load(i + 1)

    return outs
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
    ("pyr_up", "f32", (1, 19, 31), {"segments": 3, "rows": 4}),
    ("pyr_up", "u8", (2, 31, 31), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 6}),
    ("pyr_up", "f32", (1, 48, 31), {"rows": 2}),
    ("up_gauss5", "f32", (1, 19, 31), {"segments": 2, "rows": 6}),
    ("up_gauss5", "u8", (1, 31, 29), {"tiled": True, "tile_w": 8, "rows": 4}),
    ("down_up", "f32", (1, 48, 31), {"segments": 2}),
    ("down_up", "u8", (2, 37, 30), {"tiled": True, "tile_w": 8, "segments": 3, "rows": 4}),
    ("pyr_down_map", "u8", (1, 70, 61), {"segments": 3}),
    ("pyr_down_map", "f32", (1, 45, 53), {"tiled": True, "tile_w": 16, "segments": 2,
                                          "rows": 4}),
    ("resize2_mid", "u8", (1, 70, 61), {"segments": 2}),
    ("resize2_mid", "f32", (1, 37, 53), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 2}),
    ("up_down_tap", "f32", (1, 23, 19), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 4}),
    ("down_sobel_grad", "u8", (1, 37, 41), {"tiled": True, "tile_w": 16, "segments": 2}),
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
    # the table a block copies to shared memory: the chain's own size
    assert prog.table_bytes == 4 * (8 + 20 * 3 + 6 * 4 + 1 + len(prog.weights))
    assert prog.table_smem == -(-(prog.table_bytes + 4 * 9) // 16) * 16 <= 5744


@pytest.mark.parametrize("shape,threads", [((768, 32, 32), 32), ((1, 64, 8), 32),
                                           ((1, 1080, 960), 256)])
def test_stream_threads_follow_one_steps_work(shape, threads):
    """A block takes `STREAM_THREADS`, halved while they are at least four
    times the 4-column groups of its frame (a 40-column frame: 10 groups,
    32 threads; a 968-column one: 242 groups, 256)."""
    prog, _ = exec_streaming.program(_stages(tstencil, "preprocess"), 8, torch.float32,
                                     torch.device("cpu"))
    geom = exec_streaming.stream_geometry(prog, shape, LaunchConfig(), tiled=False)
    assert geom.threads == threads


# ---------------------------------------------------------------------------
# The planner's figures: ring bytes by dtype, full-width 4K, two blocks an SM
# ---------------------------------------------------------------------------

def test_ring_bytes_follow_the_dtype():
    """u8 rings take one byte a value, f32 rings four; a Sobel pair stays f32
    on a u8 chain and the pair's magnitude is packed to u8 again."""
    pre = _stages(tstencil, "preprocess")
    f32 = plan.stream_layout(pre, 8, torch.float32)
    u8 = plan.stream_layout(pre, 8, torch.uint8)
    assert f32.esizes == (4, 4, 4, 4) and u8.esizes == (1, 1, 1, 1)
    # level 0's pad is rounded up to 16 bytes of the input: 16 u8 columns, 4 f32 ones
    assert u8.col_pads == (16,) and f32.col_pads == (4,)
    assert u8.row_bytes(0, 32) == 64 + 16 and f32.row_bytes(0, 32) == 160 + 16
    assert u8.smem_bytes(32) == 16 + 32 * 80
    # loading stream 0 a step ahead adds a step's rows to its ring
    assert u8.smem_bytes(32, ahead=True) - u8.smem_bytes(32) == 8 * 80
    sob = plan.stream_layout(_stages(tstencil, "down_sobel_grad"), 8, torch.uint8)
    assert sob.esizes == (1, 1, 4, 4, 1)
    k13 = plan.stream_layout(_stages(tstencil, "gaussian_filter2d_k13"), 8, torch.uint8)
    k13f = plan.stream_layout(_stages(tstencil, "gaussian_filter2d_k13"), 8, torch.float32)
    assert k13.smem_bytes(3840) == 16 + 20 * (3840 + 32 + 16)
    assert k13f.smem_bytes(3840) == 16 + 20 * ((3840 + 16) * 4 + 16)  # pad 6 -> 8


@pytest.mark.parametrize("op,size", [("erode", r) for r in (1, 2, 3)]
                         + [("filter2d", k) for k in (3, 5, 7, 9, 11, 13)])
def test_4k_u8_image_ops_stream_at_full_width(op, size):
    if op == "erode":
        chain = (tstencil.erode_stage(size),)
    else:
        k1 = tref.gaussian_kernel1d(size)
        chain = (tstencil.filter_stage(torch.outer(k1, k1)),)
    assert driver.resolve_mode(chain, (1, 2160, 3840), torch.uint8) == "streaming"


def _image_path_shapes():
    """The 24 image-path shapes of chip_smoke.py, as (name, chain, planes,
    dtype)."""
    from repro_torch.cv import features as tfeat

    res = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}
    out = []
    for r in ("1080p", "4K"):
        for k in (3, 5, 7, 9, 11, 13):
            k1 = tref.gaussian_kernel1d(k)
            out.append((f"filter2d k={k} {r}", (tstencil.filter_stage(torch.outer(k1, k1)),),
                        (1, *res[r]), torch.uint8))
    for r in ("1080p", "4K", "8K"):
        for rad in (1, 2, 3):
            out.append((f"erode r={rad} {r}", (tstencil.erode_stage(rad),), (1, *res[r]),
                        torch.uint8))
    out.append(("acceptance", _stages(tstencil, "acceptance"), (24, 512, 512), torch.uint8))
    out.append(("preprocess", _stages(tstencil, "preprocess"), (24, 512, 512), torch.float32))
    out.append(("octave", tfeat.octave_chain(4, with_next_base=False), (1, 512, 512),
                torch.float32))
    return out


def test_two_blocks_fit_an_sm_on_every_image_path_shape():
    """By the planner's own figures (shared memory, static included, and
    threads; `plan.blocks_per_sm`), every image-path shape's
    `stencil_stream` launch leaves room for at least two blocks an SM, and
    the launch has at least 132 blocks."""
    shapes = _image_path_shapes()
    assert len(shapes) == 24
    for name, chain, shape, dtype in shapes:
        mode = driver.resolve_mode(chain, shape, dtype)
        prog, _ = exec_streaming.program(chain, 8, dtype, torch.device("cpu"))
        geom = exec_streaming.stream_geometry(prog, shape, LaunchConfig(),
                                              tiled=mode == "tiled2d")
        per_sm = plan.blocks_per_sm(geom.smem_bytes + prog.table_smem, geom.threads)
        assert per_sm == geom.per_sm >= 2, (name, geom)
        assert geom.smem_bytes + prog.table_smem <= plan.TWO_BLOCK_SMEM, name
        assert shape[0] * geom.n_tiles * geom.n_seg >= 132, (name, geom)
        assert mode == ("tiled2d" if name == "octave" else "streaming"), name


def test_loads_ahead_only_where_two_blocks_still_fit():
    """Stream 0 gets a step's rows more when its ring then still leaves
    room for a second block: 4K filter2d k=13 does, 8K erode does not."""
    k13 = _image_path_shapes()[11]
    assert k13[0] == "filter2d k=13 4K"
    for (name, chain, shape, dtype), ahead in ((k13, True), (_image_path_shapes()[18], False)):
        prog, _ = exec_streaming.program(chain, 8, dtype, torch.device("cpu"))
        geom = exec_streaming.stream_geometry(prog, shape, LaunchConfig(), tiled=False)
        assert geom.ahead is ahead, name
        assert geom.smem_bytes == prog.layout.smem_bytes(geom.tile_w, ahead)


def test_strip_sizes_match_the_kernel():
    """The planner marks as strips exactly the (op, size) pairs the kernel
    has a register-strip body for (csrc/stencil_stream.cu `run_strip`)."""
    import re
    from pathlib import Path

    src = (Path(tstencil.__file__).resolve().parents[2] / "csrc" / "stencil_stream.cu").read_text()
    names = {"kFilter2d": "filter2d", "kSep": "sep_filter", "kErode": "erode",
             "kDilate": "dilate", "kBox": "box", "kThreshold": "threshold", "kAffine": "affine"}
    got = {}
    for op, k in re.findall(r"STRIP_K\((k\w+), (\d+)\)", src):
        got.setdefault(names[op], []).append(int(k))
    assert {op: tuple(ks) for op, ks in got.items()} == plan.STRIP_SIZES


def test_tiled2d_keeps_two_blocks_unless_the_halo_costs_too_much():
    """The 512² octave keeps 64-column tiles (two blocks an SM, 1.35x the
    column work of the one-block 192-column tile); with its next base the
    two-block tile is 32 columns, over `plan.TWO_BLOCK_WORK` times the
    work of the 128-column one, so that one is taken."""
    from repro_torch.cv import features as tfeat

    for nb, tile, per_sm in ((False, 64, 2), (True, 128, 1)):
        prog, _ = exec_streaming.program(tfeat.octave_chain(4, with_next_base=nb), 8,
                                         torch.float32, torch.device("cpu"))
        geom = exec_streaming.stream_geometry(prog, (1, 512, 512), LaunchConfig(), tiled=True)
        assert (geom.tile_w, geom.per_sm) == (tile, per_sm), nb


# ---------------------------------------------------------------------------
# Even taps and chains past the old fixed tables, in stencil_stream
# ---------------------------------------------------------------------------

from test_torch_stencil import EVEN_CHAINS, TABLE_CHAINS, _table_input, table_chain  # noqa: E402

TABLE_REPLAY = [
    ("u8", (1, 45, 61), {"segments": 2}),
    ("f32", (2, 41, 70), {"tiled": True, "tile_w": 32, "segments": 2}),
]


@pytest.mark.parametrize("name", EVEN_CHAINS + TABLE_CHAINS)
@pytest.mark.parametrize("dtype,shape,opts", TABLE_REPLAY)
def test_kernel_loop_of_table_chains(name, dtype, shape, opts):
    """`stencil_stream` takes every one of these chains (even taps through
    the generic body, which reads kh and kw at run time; the program sized
    per chain): its block loop, replayed, equals the plain version bit for
    bit."""
    rows = {"levels9": 32, "bands17": 4}.get(name, 8)  # 17 bands' rings at 4 rows a step
    if opts.get("tiled") and name in ("levels9", "bands17"):
        opts = opts | {"tile_w": 64 if name == "levels9" else 16}
    x = torch.from_numpy(_table_input(shape, dtype, seed=23))
    chain = table_chain(tstencil, name, shape[1:])
    lc = LaunchConfig(stream_rows=rows, row_segments=opts["segments"])
    prog, _ = exec_streaming.program(chain, lc.stream_rows, x.dtype, x.device)
    geom = exec_streaming.stream_geometry(prog, tuple(x.shape), lc, tiled=opts.get("tiled", False),
                                          tile_w=opts.get("tile_w"))
    assert geom.smem_bytes + prog.table_smem <= lc.smem_budget
    maps = [tuple(w.numpy() for w in s.weights) for s in chain if s.op == "remap"]
    got = _emulate_stream(x.numpy(), prog, geom, maps)
    want = exec_streaming.stencil_stream_plain(x, chain)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float64))


def test_even_taps_never_run_a_strip():
    """A strip body is specialised on an odd square size; a 4x5 or 6x6
    filter runs the generic body (its extents at run time), and an odd
    square one keeps its strip."""
    k4 = torch.full((4, 5), 0.05)
    for chain, strip in (((tstencil.filter_stage(k4),), 0),
                         ((tstencil.sep_filter_stage(torch.full((6,), 1 / 6), torch.full((6,), 1 / 6)),), 0),
                         ((tstencil.gaussian_stage(5),), 1)):
        assert plan.stream_layout(chain, 8).strips == (bool(strip),)
        assert exec_streaming.compile_stream(chain, 8).steps[0]["strip"] == strip


# -- van Herk morphology (`cv.imgproc`, plain PyTorch as JAX's is jnp) -------------------------

VANHERK_SHAPES = ((37, 53), (1, 9), (20, 1), (33, 17, 3), (5, 8, 1))


@pytest.mark.parametrize("op", ["erode", "dilate"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("ksize", range(6))
def test_vanherk_matches_jax(op, dtype, ksize):
    from repro.cv import imgproc as jimgproc

    rng = np.random.default_rng(ksize * 7 + (op == "erode"))
    for shape in VANHERK_SHAPES:
        x = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
             else rng.standard_normal(shape).astype(dtype))
        want = np.asarray(getattr(jimgproc, f"{op}_vanherk")(jnp.asarray(x), ksize))
        got = getattr(timgproc, f"{op}_vanherk")(torch.from_numpy(x), ksize)
        assert got.dtype == torch.from_numpy(x).dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{op} {shape} k={ksize}")


@pytest.mark.parametrize("ksize", [1, 2, 3])
def test_vanherk_equals_the_erode_op(ksize):
    """As JAX's quickstart asserts: the direct erode equals van Herk on u8."""
    x = torch.from_numpy(np.random.default_rng(ksize).integers(0, 256, (45, 61), dtype=np.uint8))
    assert torch.equal(timgproc.erode_vanherk(x, ksize), tops.erode(x, ksize))
    assert torch.equal(timgproc.dilate_vanherk(x, ksize), tops.dilate(x, ksize))
