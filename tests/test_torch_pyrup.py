"""pyrUp and strides before a chain's last stage: the port against the JAX package.

The JAX side runs its oracle `repro.kernels.ref.chain_ref` (its Pallas
stencil plans do not lower on every jax release; the oracle always runs)
and its planner's pure functions (`chain_iface`, `chain_stream_plan`,
`build_chain_geom`'s pyrUp phase meta).  The port runs `fused_chain` on the
CPU, the plain version of whichever kernel the mode names.  Inputs are made
from a numpy seed and handed to both packages.

Tolerances: pyrUp alone is exact in u8 and f32 (two phases of rounded
products and sums, the same expression in both oracles); after a blur f32
holds the repo's oracle tolerance (rtol 2e-5, atol 2e-3) and u8 |diff| <= 1
(the blur's multiply-add may be contracted by XLA and move a .5 tie), with
the off-by-one pixels held under 1%.  The independent zero-insert
convolution pin holds rtol 1e-5, atol 1e-4 (an f64 convolution against f32
phases).  The kernels' own loops are replayed bit for bit against the plain
version in tests/test_torch_stencil.py and tests/test_torch_stream.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig
from repro.kernels import ref as jref
from repro.kernels import stencil as jstencil
from repro.kernels.stencil import plan as jplan

from repro_torch.core.device import LaunchConfig
from repro_torch.kernels import counters
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import exec_streaming, exec_window, plan

RTOL, ATOL = 2e-5, 2e-3
U8_OFF_BY_ONE = 0.01


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * 255.0


def _kinds(pkg):
    """The mid-chain stride kinds of tests/test_streaming.py:56-80, and
    pyrUp alone and around other stages."""
    return {
        "pyr_up": (pkg.pyr_up_stage(),),
        "blur_pyr_up": (pkg.gaussian_stage(3), pkg.pyr_up_stage()),
        "pyr_up_gauss5": (pkg.pyr_up_stage(), pkg.gaussian_stage(5)),
        "pyr_down_map": (pkg.gaussian_stage(5), pkg.pyr_down_stage(), pkg.erode_stage(1)),
        "pyr_down_tap": (pkg.gaussian_stage(5), pkg.gaussian_stage(5, tap=-1),
                         pkg.pyr_down_stage(tap=1)),
        "resize2": (pkg.resize2_stage(), pkg.gaussian_stage(3)),
        "pyr_up_pyr_down": (pkg.pyr_down_stage(), pkg.pyr_up_stage()),
        "up_up_gauss": (pkg.pyr_up_stage(), pkg.pyr_up_stage(), pkg.gaussian_stage(3)),
        "resize2_gauss_resize2": (pkg.resize2_stage(), pkg.gaussian_stage(3),
                                  pkg.resize2_stage()),
    }


KINDS = list(_kinds(tstencil))
EXACT = {"pyr_up", "pyr_up_pyr_down"}


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


@pytest.fixture(scope="module")
def jax_outs():
    """JAX `chain_ref` of every kind on both carriers at two odd sizes,
    computed once for the module."""
    out = {}
    for name, chain in _kinds(jstencil).items():
        for dtype in ("u8", "f32"):
            for shape in ((19, 31), (2, 33, 24, 2)):
                x = _input(shape, dtype, seed=len(name) + len(shape))
                out[name, dtype, shape] = (x, _tuple(jref.chain_ref(jnp.asarray(x), chain)))
    return out


@pytest.mark.parametrize("shape", [(19, 31), (2, 33, 24, 2)])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("name", KINDS)
def test_level_chains_match_jax_chain_ref(jax_outs, name, dtype, shape):
    """Every kind, every band, against JAX's oracle: pyrUp alone exact, the
    rest within the stated tolerance."""
    x, want = jax_outs[name, dtype, shape]
    got = _tuple(tstencil.fused_chain(torch.from_numpy(x), _kinds(tstencil)[name]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_like_jax(g.numpy(), w, name in EXACT)


@pytest.mark.parametrize("mode", [None, "window", "streaming", "tiled2d", "ref"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_ops_pyr_up_in_every_mode(jax_outs, mode, dtype):
    """`ops.pyr_up` and `imgproc.pyr_up`: (2H, 2W) of the input's dtype,
    exactly JAX's on the CPU whatever the mode names."""
    from repro_torch.cv import imgproc as timgproc

    x, (want,) = jax_outs["pyr_up", dtype, (19, 31)]
    got = tops.pyr_up(torch.from_numpy(x), mode=mode)
    assert tuple(got.shape) == (38, 62)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timgproc.pyr_up is tops.pyr_up


def test_pyr_up_matches_zero_insert_conv():
    """Independent pin (not chain_ref, tests/test_stencil.py:602): pyrUp is
    the zero-insert upsample convolved with 4x the 5-tap pyramid kernel
    (OpenCV's definition), replicate-extended at the source resolution."""
    img = _input((19, 31), "f32", seed=3)
    out = tops.pyr_up(torch.from_numpy(img)).numpy()
    x = np.asarray(img, np.float64)
    xp = np.pad(x, 2, mode="edge")
    up = np.zeros((2 * xp.shape[0], 2 * xp.shape[1]))
    up[0::2, 0::2] = xp
    k1 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    k = 4.0 * np.outer(k1, k1)
    conv = np.zeros_like(up)
    upp = np.pad(up, 2)
    for i in range(5):
        for j in range(5):
            conv += k[i, j] * upp[i:i + up.shape[0], j:j + up.shape[1]]
    want = conv[4:4 + 38, 4:4 + 62]
    assert out.shape == (38, 62)
    np.testing.assert_allclose(out.astype(np.float64), want, rtol=1e-5, atol=1e-4)


def test_pyr_up_down_roundtrip():
    """pyrUp o pyrDown restores the geometry (even sizes) and, on a smooth
    image, the values to low error, fused as one chain and as two ops
    (tests/test_stencil.py:626); the fused chain equals JAX's exactly."""
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    smooth = (100.0 + 50.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)).astype(np.float32)
    chain = (tstencil.pyr_down_stage(), tstencil.pyr_up_stage())
    x = torch.from_numpy(smooth)
    out = tstencil.fused_chain(x, chain).numpy()
    assert out.shape == (48, 64)
    want = jref.chain_ref(jnp.asarray(smooth), (jstencil.pyr_down_stage(), jstencil.pyr_up_stage()))
    np.testing.assert_array_equal(out, np.asarray(want))
    staged = tops.pyr_up(tops.pyr_down(x)).numpy()
    np.testing.assert_allclose(out[4:-4, 4:-4], staged[4:-4, 4:-4], rtol=1e-6)
    assert np.max(np.abs(out[4:-4, 4:-4] - smooth[4:-4, 4:-4])) < 2.0


def test_pyr_up_rejects_tap():
    """pyrUp is map-only, in the oracle and in every mode (JAX's refusal,
    tests/test_stencil.py:646)."""
    x = torch.from_numpy(_input((32, 32), "u8"))
    with pytest.raises(ValueError, match="tap"):
        tref.chain_ref(x, (tstencil.Stage("pyr_up", tap=0),))
    for mode in (None, "window", "streaming", "ref"):
        with pytest.raises(ValueError, match="tap"):
            tstencil.fused_chain(x, (tstencil.gaussian_stage(3), tstencil.Stage("pyr_up", tap=0)),
                                 mode=mode)


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("rows", [8, 16, 32])
def test_plans_match_jax(name, rows):
    """The port's halo, row walk, carry plan and pyrUp phase meta equal
    JAX's for every kind (the phase meta from `build_chain_geom`)."""
    tc, jc = _kinds(tstencil)[name], _kinds(jstencil)[name]
    assert tstencil.chain_accumulated_halo(tc) == jstencil.chain_accumulated_halo(jc)
    tp, jp = tstencil.resolve_chain(tc), jstencil.resolve_chain(jc)
    assert [r[:5] for r in tp] == [(op, m, tuple(h), tuple(s), tuple(u))
                                   for op, m, h, s, u, *_ in jp]
    ti, ji = tstencil.chain_iface(tp, rows), jstencil.chain_iface(jp, rows)
    assert ti == ji
    assert tstencil.chain_stream_plan(tp, ti) == jstencil.chain_stream_plan(jp, ji)
    vc = VectorConfig(lmul=rows // 8)
    geom = jplan.build_chain_geom(jc, (1, 64, 256), jnp.float32, vc)
    jrows = vc.rows(jnp.float32)
    metas = tstencil.pyr_up_metas(tc, jrows)
    for k, (op, *_rest) in enumerate(tp):
        if op == "pyr_up":
            assert metas[k] == tuple(geom.plan[k][5])
        else:
            assert metas[k] is None


@pytest.mark.parametrize("H", [19, 31, 48])
def test_upsample_phase_handoff(H):
    """pyrUp's phases interleave across step boundaries: the ring carries
    2*halo source rows, +1 on an odd-phase interface, the same every step
    (tests/test_streaming.py:224); each chain's plain version equals JAX's
    and the stream plan's ring rows are 2 or 3."""
    x = _input((H, 31), "f32", seed=H)
    for tc, jc in (((tstencil.pyr_up_stage(),), (jstencil.pyr_up_stage(),)),
                   ((tstencil.pyr_up_stage(), tstencil.gaussian_stage(5)),
                    (jstencil.pyr_up_stage(), jstencil.gaussian_stage(5))),
                   ((tstencil.pyr_down_stage(), tstencil.pyr_up_stage()),
                    (jstencil.pyr_down_stage(), jstencil.pyr_up_stage()))):
        got = tstencil.fused_chain(torch.from_numpy(x), tc, mode="streaming",
                                   lc=LaunchConfig(stream_rows=4, row_segments=3))
        want = jref.chain_ref(jnp.asarray(x), jc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        walk = tstencil.resolve_chain(tc)
        for rows in (4, 6, 8):
            sp = tstencil.chain_stream_plan(walk, tstencil.chain_iface(walk, rows))
            for (op, *_r), (_off, _r2, ring, _d) in zip(walk, sp):
                if op == "pyr_up":
                    assert ring in (2, 3)


def test_levels_of_a_mid_chain_stride():
    """gaussian(5) -> pyrDown -> erode(1): two levels; the blur's input needs
    6 rows around the tile (2*1 + 2 through the stride, + 2), the erosion's
    1 at half resolution; a stream above the stride adds twice the rows."""
    chain = (tstencil.gaussian_stage(5), tstencil.pyr_down_stage(), tstencil.erode_stage(1))
    lv = tstencil.chain_levels(chain)
    assert (lv.lv_in, lv.lv_out) == ((0, 0, 1), (0, 1, 1))
    assert lv.need == ((6, 6), (4, 4), (1, 1)) and lv.pads == ((6, 6), (1, 1))
    assert lv.size(1, 37, 53) == (19, 27) and lv.tile(1, 32, 64) == (16, 32)
    lay = plan.stream_layout(chain, 8)
    assert lay.mults == (16, 16, 8, 8) and lay.levels == (0, 0, 1, 1)
    assert lay.leads == (6, 4, 1, 0)
    prog = exec_window.compile_chain(chain, torch.uint8)
    assert [(st["ls"], st["lo"], st["down"]) for st in prog.steps] == [(0, 0, 1), (0, 1, 1),
                                                                       (1, 1, 1)]


def test_levels_of_pyr_up():
    """A lone pyrUp: its input level needs one row each way, the output
    level none; the window's slots hold the input frame and the row phases
    (the doubled tile's rows by the 34 source columns they read), the
    output goes out as it is made; the stream's input ring advances half
    the rows a step."""
    chain = (tstencil.pyr_up_stage(),)
    lv = tstencil.chain_levels(chain)
    assert lv.tile(1, 32, 32) == (64, 64) and lv.pads == ((1, 1), (0, 0))
    prog = exec_window.compile_chain(chain)
    assert prog.frame_spans(32, 32) == [(34, 34), (64, 64)]
    assert prog.n_slots == 2 and prog.slot_floats(32, 32) == 64 * 35
    lay = plan.stream_layout(chain, 8)
    assert lay.mults == (4, 8) and lay.depths[1] == 0  # stored from registers
    sprog = exec_streaming.compile_stream(chain, 8, torch.uint8)
    assert sprog.steps[0]["op"] == exec_window.OP_CODES["pyr_up"]
    with pytest.raises(ValueError, match="divisible"):
        exec_streaming.compile_stream(chain, 5)


def test_mid_chain_tiles_follow_the_stride_product():
    """A column tile of tiled2d narrower than the plane must be a multiple of
    the stride product (JAX's seam rule); the window tile likewise."""
    x = torch.zeros((40, 70))
    chain = (tstencil.resize2_stage(), tstencil.gaussian_stage(3))
    with pytest.raises(ValueError, match="tile_w=33"):
        tstencil.fused_chain(x, chain, mode="tiled2d", tile_w=33)
    with pytest.raises(ValueError, match="stride product"):
        exec_window.pick_tile(exec_window.compile_chain(chain), LaunchConfig(tile_rows=15))
    counters.reset()
    tstencil.fused_chain(x, chain, mode="tiled2d", tile_w=32)
    assert counters.PLAIN_CALLS["stencil_stream"] == 1
