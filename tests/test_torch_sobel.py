"""The Sobel pair, the grad_mag pair reduction and resize2 in the port,
against the JAX package, on the CPU.

The JAX side runs `repro.kernels.ref.chain_ref` eagerly and
`fused_chain(..., mode="ref")` (jitted; its Pallas stencil plans do not
lower on every jax release).  The port runs `fused_chain`, `ops.sobel` and
`imgproc.resize_half` on the CPU, which is the plain version of whichever
kernel the mode names.  Inputs are made from a numpy seed.

Tolerances: exact for the chains of Sobel, the pair reduction and resize2
alone (their products are by 2 and 0.25, exact in f32, so no contraction
can round them apart).  Where a filter stage joins them, XLA may contract
a product and a sum into one FMA (ROADMAP Notes): u8 |diff| <= 1 on at most
1% of the pixels (counted), f32 rtol 1e-5 and atol 1e-4.

A u8 chain with a Sobel carries bands of two dtypes: the pair is f32, the
pair's magnitude is packed back to u8 (JAX's `_band_meta`).  The numpy
replays of both kernels' loops run these chains across several tiles and
row segments, bit for bit against the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels import stencil as jstencil
from repro.kernels.stencil import plan as jplan

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import imgproc as timgproc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import exec_streaming, exec_window
from repro_torch.kernels.stencil import plan as tplan
from test_torch_stencil import _emulate_kernel
from test_torch_stream import _emulate_stream

U8_OFF_BY_ONE = 0.01
RTOL, ATOL = 1e-5, 1e-4
MODES = [None, "window", "streaming", "tiled2d", "ref"]


def chain(pkg, name):
    """One chain, built with either package's stage builders."""
    return {
        "sobel": (pkg.sobel_stage(),),
        "sobel_grad": (pkg.sobel_stage(), pkg.grad_stage()),
        "gauss_sobel_grad": (pkg.gaussian_stage(3), pkg.sobel_stage(), pkg.grad_stage()),
        "tap_sobel": (pkg.gaussian_stage(3, tap=0), pkg.sobel_stage()),
        "sobel_box": (pkg.sobel_stage(), pkg.box_stage(1)),
        "sobel_thresh": (pkg.gaussian_stage(3, tap=0), pkg.sobel_stage(),
                         pkg.threshold_stage(20.0, 300.0)),
        "resize2": (pkg.resize2_stage(),),
        "resize2_tap": (pkg.gaussian_stage(3), pkg.resize2_stage(tap=0)),
        "sobel_resize2": (pkg.sobel_stage(), pkg.resize2_stage()),
        "grad_sobel_tap_resize2": (pkg.sobel_stage(), pkg.grad_stage(), pkg.resize2_stage(tap=0)),
    }[name]


CHAINS = ["sobel", "sobel_grad", "gauss_sobel_grad", "tap_sobel", "sobel_box", "sobel_thresh",
          "resize2", "resize2_tap", "sobel_resize2", "grad_sobel_tap_resize2"]
EXACT = {"sobel", "sobel_grad", "resize2", "sobel_resize2", "grad_sobel_tap_resize2"}


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * 255.0


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _near(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= U8_OFF_BY_ONE, int((diff > 0).sum())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Builders, plans and band dtypes equal JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHAINS)
def test_plans_and_band_meta_match_jax(name):
    jc, tc = chain(jstencil, name), chain(tstencil, name)
    for j, t in zip(jc, tc):
        assert (t.op, t.tap, t.halo, t.stride, t.static) == \
            (j.op, j.tap, tuple(j.halo), tuple(j.stride), j.static)
    assert tstencil.chain_accumulated_halo(tc) == jstencil.chain_accumulated_halo(jc)
    jp, tp = jstencil.resolve_chain(jc), tstencil.resolve_chain(tc)
    assert [r[:3] + r[5:] for r in tp] == [(op, m, tuple(h), a, b, tap)
                                           for op, m, h, _s, _u, a, b, tap in jp]
    for rows in (8, 16):
        ji, ti = jstencil.chain_iface(jp, rows), tstencil.chain_iface(tp, rows)
        assert ti == ji
        assert tstencil.chain_stream_plan(tp, ti) == jstencil.chain_stream_plan(jp, ji)
    for jdt, tdt in ((jnp.uint8, torch.uint8), (jnp.float32, torch.float32)):
        want = jplan._band_meta(jp, jdt)
        got = tplan.band_meta(tc, tdt)
        assert [str(dt).split(".")[-1] for dt, _ in got] == [jnp.dtype(dt).name for dt, _ in want]
        # JAX names the op of a tapped band only; the port names every
        # resolution op that made a band, in order (a map stride's too)
        for (_, t_ops), (_, j_op) in zip(got, want):
            assert j_op is None or t_ops[-1:] == (j_op,)


def test_sobel_rejects_tap():
    for pkg in (jstencil, tstencil):
        with pytest.raises(ValueError, match="tap="):
            pkg.resolve_chain((pkg.gaussian_stage(3), pkg.Stage("sobel", tap=0)))


def test_strided_tap_must_be_last():
    for pkg in (jstencil, tstencil):
        with pytest.raises(ValueError, match="final stage"):
            pkg.resolve_chain((pkg.resize2_stage(tap=0), pkg.gaussian_stage(3)))


# ---------------------------------------------------------------------------
# The plain version against JAX's oracle
# ---------------------------------------------------------------------------

SHAPES = [(37, 53), (21, 30, 3), (2, 19, 26, 2)]


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", CHAINS)
def test_chains_equal_jax_chain_ref(name, shape, dtype):
    x = _input(shape, dtype, seed=len(shape) + 1)
    want = _tuple(jref.chain_ref(jnp.asarray(x), chain(jstencil, name)))
    first = None
    for mode in MODES:
        got = _tuple(tstencil.fused_chain(torch.from_numpy(x), chain(tstencil, name), mode=mode))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            if name in EXACT:
                np.testing.assert_array_equal(g, w)
            else:
                _near(g, w)
        first = first or got
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ops_sobel_and_resize_half_match_jax_mode_ref(shape, dtype):
    x = _input(shape, dtype, seed=5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    dx, dy = tops.sobel(tx)
    wdx, wdy = jstencil.fused_chain(jx, (jstencil.sobel_stage(),), mode="ref")
    for g, w in ((dx, wdx), (dy, wdy)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert timgproc.sobel is tops.sobel
    mag = tstencil.fused_chain(tx, (tstencil.sobel_stage(), tstencil.grad_stage()))
    assert mag.dtype == tx.dtype
    _near(mag.numpy(), jstencil.fused_chain(jx, (jstencil.sobel_stage(), jstencil.grad_stage()),
                                            mode="ref"))
    half = timgproc.resize_half(tx)
    hw_axes = (0, 1) if len(shape) < 4 else (1, 2)
    assert all(half.shape[a] == shape[a] // 2 for a in hw_axes) and half.dtype == tx.dtype
    np.testing.assert_array_equal(
        half.numpy(), np.asarray(jstencil.fused_chain(jx, (jstencil.resize2_stage(),), mode="ref")))


def test_sobel_of_a_ramp():
    """Independent pin: on x = 3*col + 5*row the Sobel pair is (8*3, 8*5)
    inside (weights 1, 2, 1 times a central difference over two pixels),
    and the replicate border halves it at the edge."""
    rows, cols = np.mgrid[0:9, 0:11].astype(np.float32)
    dx, dy = tops.sobel(torch.from_numpy(3 * cols + 5 * rows))
    assert bool((dx[:, 1:-1] == 24).all()) and bool((dy[1:-1] == 40).all())
    assert bool((dx[:, 0] == 12).all()) and bool((dy[0] == 20).all())


def test_resize_half_of_a_known_block():
    x = torch.tensor([[0, 2, 4, 6, 9], [2, 4, 6, 8, 9], [1, 1, 3, 3, 9]], dtype=torch.uint8)
    # means 2, 6 (u8: 2.0, 6.0), the odd last row and column dropped
    assert torch.equal(timgproc.resize_half(x), torch.tensor([[2, 6]], dtype=torch.uint8))
    y = torch.tensor([[0, 1], [1, 1]], dtype=torch.uint8)  # mean 0.75 -> 1
    assert int(timgproc.resize_half(y)) == 1
    z = torch.tensor([[0, 1], [0, 1]], dtype=torch.uint8)  # mean 0.5 -> 0 (half to even)
    assert int(timgproc.resize_half(z)) == 0


# ---------------------------------------------------------------------------
# The step tables
# ---------------------------------------------------------------------------

def test_compile_chain_slots_of_the_pair():
    prog = exec_window.compile_chain(chain(tstencil, "sobel_grad"), torch.uint8)
    sob, red = prog.steps
    assert (sob["op"], sob["src"], sob["pk"]) == (10, 0, 0)
    assert sob["dst"] != sob["dst2"] and sob["store"] == sob["store2"] == -1
    assert (red["op"], red["src"], red["src2"], red["pk"], red["store"]) == \
        (exec_window.GRAD_PAIR, sob["dst"], sob["dst2"], 1, 0)
    assert prog.n_slots == 3 and prog.bands == ((torch.uint8, ()),)
    pair = exec_window.compile_chain(chain(tstencil, "tap_sobel"), torch.uint8)
    assert pair.bands == ((torch.uint8, ()), (torch.float32, ()), (torch.float32, ()))
    assert (pair.steps[0]["op"], pair.steps[0]["store"]) == (3, 0)  # the input band as it is
    assert (pair.steps[-1]["store"], pair.steps[-1]["store2"]) == (1, 2)


def test_compile_stream_of_the_pair():
    prog = exec_streaming.compile_stream(chain(tstencil, "sobel"), 8, torch.uint8)
    (st,) = prog.steps
    assert (st["op"], st["dst"], st["dst2"], st["store"], st["store2"]) == (10, -1, -1, 0, 1)
    prog = exec_streaming.compile_stream(chain(tstencil, "sobel_grad"), 8, torch.uint8)
    assert prog.layout.apps == ((0, (0,), (1, 2)), (1, (1, 2), (3,)))
    assert [s["pk"] for s in prog.steps] == [0, 1]


# ---------------------------------------------------------------------------
# The kernels' loops, replayed in numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("dtype,shape,tile", [("u8", (2, 37, 53), 16), ("f32", (1, 29, 35), 8)])
def test_window_kernel_replay(name, dtype, shape, tile):
    x = torch.from_numpy(_input(shape, dtype, seed=11))
    stages = chain(tstencil, name)
    prog = exec_window.compile_chain(stages, x.dtype)
    th, tw, _ = exec_window.pick_tile(prog, LaunchConfig(tile_rows=tile, tile_cols=tile))
    got = _emulate_kernel(x.numpy(), prog, th, tw)
    want = tref.chain_ref_planes(x, stages)
    assert [tuple(w.shape) for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float32))


REPLAY = [
    ("u8", (1, 45, 61), {"segments": 3}),
    ("f32", (2, 37, 70), {"tiled": True, "tile_w": 16, "segments": 2}),
    ("u8", (1, 31, 27), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 4}),
]


@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("dtype,shape,opts", REPLAY)
def test_stream_kernel_replay(name, dtype, shape, opts):
    x = torch.from_numpy(_input(shape, dtype, seed=12))
    stages = chain(tstencil, name)
    lc = LaunchConfig(stream_rows=opts.get("rows", 8), row_segments=opts["segments"])
    prog, _ = exec_streaming.program(stages, lc.stream_rows, x.dtype, x.device)
    geom = exec_streaming.stream_geometry(prog, tuple(x.shape), lc, tiled=opts.get("tiled", False),
                                          tile_w=opts.get("tile_w"))
    assert geom.n_seg == opts["segments"]
    got = _emulate_stream(x.numpy(), prog, geom)
    want = exec_streaming.stencil_stream_plain(x, stages)
    assert [tuple(w.shape) for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float64))
