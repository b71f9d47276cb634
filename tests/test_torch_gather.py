"""The port's gathers (warp_affine, remap) and `align_and_detect` against the
JAX package, on the CPU.

The JAX side runs `repro.kernels.ref.chain_ref` eagerly, every op rounded on
its own as the port's plain version rounds it, and `fused_chain(...,
mode="ref")` / `features.align_and_detect(..., mode="ref")`, which jit the
chain (its Pallas stencil plans do not lower on every jax release).  The
port runs `fused_chain`, the `imgproc` ops and `features.align_and_detect`
on the CPU, which is the plain version of whichever kernel the mode names.
Inputs are made from a numpy seed.

Tolerances: exact against the eager `chain_ref` for the chains of gathers
and morphology alone.  Where a filter stage joins them, and against the
jitted `mode="ref"`, XLA may contract a product and a sum into one FMA
(ROADMAP Notes): u8 |diff| <= 1 on at most 1% of the pixels (counted), f32
rtol 1e-5 and atol 1e-4.  An f32 gather against the jitted program takes
JAX's own tolerance for it, rtol 1e-5 and atol 1e-3 (tests/test_stencil.py,
`test_warp_ladder_chain_golden`): a contracted coordinate moves by an ulp,
which the local gradient (up to 255 a pixel) scales.  Keypoint sets exact.

The numpy replays of both kernels' loops (`test_torch_stencil._emulate_kernel`,
`test_torch_stream._emulate_stream`) run the gathers across several window
tiles, column tiles and row segments, bit for bit against the plain
version: a gather origin off by one row or column shows there.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig
from repro.cv import features as jfeatures
from repro.kernels import ref as jref
from repro.kernels import stencil as jstencil
from repro.kernels.stencil import plan as jplan

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features as tfeatures
from repro_torch.cv import imgproc as timgproc
from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import driver, exec_streaming, exec_window
from repro_torch.kernels.stencil import plan as tplan
from test_torch_stencil import _emulate_kernel
from test_torch_stream import _emulate_stream

U8_OFF_BY_ONE = 0.01
RTOL, ATOL = 1e-5, 1e-4
GATHER_ATOL = 1e-3  # f32 gathers against JAX's jitted program: coordinate ulp x gradient
MODES = [None, "window", "streaming", "tiled2d", "ref"]


def rot_about_centre(hw, deg: float = 1.0, shift=(4.0, -3.0)) -> np.ndarray:
    """Inverse map of a `deg` rotation about the image centre plus a (x, y)
    translation: src = R (dst - c) + c + shift."""
    h, w = hw
    cy, cx = (h - 1) / 2, (w - 1) / 2
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, -s, cx - c * cx + s * cy + shift[0]],
                     [s, c, cy - s * cx - c * cy + shift[1]]])


def bench_M(theta: float = 0.05) -> np.ndarray:
    """`benchmarks/pipeline_bench.py` `run_warp`'s matrix."""
    return np.array([[np.cos(theta), -np.sin(theta), 4.0], [np.sin(theta), np.cos(theta), -3.0]])


def smooth_maps(h, w):
    """An identity map plus a smooth field (tests/test_stencil.py:516)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return xx + 1.2 * np.cos(yy / 5.0), yy + 1.5 * np.sin(xx / 7.0)


def _maps(pkg, mx, my):
    return (jnp.asarray(mx), jnp.asarray(my)) if pkg is jstencil else (
        torch.from_numpy(np.ascontiguousarray(mx)), torch.from_numpy(np.ascontiguousarray(my)))


def gather_chain(pkg, name, hw):
    """One gather chain for an (h, w) image, built with either package."""
    h, w = hw
    feats = jfeatures if pkg is jstencil else tfeatures
    if name == "warp":
        return (pkg.warp_affine_stage(rot_about_centre(hw, 7.0), shape=hw),)
    if name == "warp_tap":
        return (pkg.gaussian_stage(3), pkg.warp_affine_stage(rot_about_centre(hw, -4.0), shape=hw,
                                                             extend=(2, 2), tap=0),
                pkg.box_stage(2))
    if name == "gauss_warp":
        return (pkg.gaussian_stage(3), pkg.warp_affine_stage(rot_about_centre(hw, 1.7), shape=hw))
    if name == "warp_ladder":
        return feats.aligned_octave_chain(bench_M(), hw, n_scales=2)
    if name == "remap":
        return (pkg.remap_stage(*_maps(pkg, *smooth_maps(h, w))),)
    if name == "remap_erode":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        mx, my = xx + np.cos(yy / 3.0), yy + np.sin(xx / 4.0)
        return (pkg.remap_stage(*_maps(pkg, mx, my), extend=(1, 1)), pkg.erode_stage(1))
    raise KeyError(name)


CHAINS = ["warp", "warp_tap", "gauss_warp", "warp_ladder", "remap", "remap_erode"]
EXACT = {"warp", "remap", "remap_erode"}  # no filter stage: every op rounds alone in JAX too


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * 255.0


def _hw(shape):
    return shape if len(shape) == 2 else shape[-3:-1]


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _near(got, want, atol=ATOL):
    """Within the tolerance against a JAX program that may contract FMAs."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= U8_OFF_BY_ONE, int((diff > 0).sum())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


# ---------------------------------------------------------------------------
# Builders and plans equal JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHAINS)
def test_builders_and_plans_match_jax(name):
    hw = (37, 61)
    jc, tc = gather_chain(jstencil, name, hw), gather_chain(tstencil, name, hw)
    for j, t in zip(jc, tc):
        assert (t.op, t.tap, t.halo, t.stride) == (j.op, j.tap, tuple(j.halo), tuple(j.stride))
        assert t.static == j.static
    assert tstencil.chain_accumulated_halo(tc) == jstencil.chain_accumulated_halo(jc)
    jp, tp = jstencil.resolve_chain(jc), tstencil.resolve_chain(tc)
    assert [r[:3] + r[5:] for r in tp] == [(op, m, tuple(h), a, b, tap)
                                           for op, m, h, _s, _u, a, b, tap in jp]
    for rows in (8, 16, 32):
        ji, ti = jstencil.chain_iface(jp, rows), tstencil.chain_iface(tp, rows)
        assert ti == ji
        assert tstencil.chain_stream_plan(tp, ti) == jstencil.chain_stream_plan(jp, ji)


@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("lmul", [1, 2, 4])
@pytest.mark.parametrize("hw,tile_w", [((37, 61), None), ((45, 300), 128), ((40, 96), 32)])
def test_gather_metas_match_jax(name, lmul, hw, tile_w):
    """(row step, row offset, column origin, column-origin step) of every
    gather, as JAX's `build_chain_geom` plans them for the same step rows
    (f32: 8 * lmul) and column tiles."""
    vc = VectorConfig(lmul=lmul)
    jc, tc = gather_chain(jstencil, name, hw), gather_chain(tstencil, name, hw)
    geom = jplan.build_chain_geom(jc, (1, *hw), jnp.float32, vc, stream=True, tile_w=tile_w)
    want = [meta if op in ("warp_affine", "remap") else None
            for op, _st, _m, _t, _h, meta in geom.plan]
    got = tplan.gather_metas(tc, hw, vc.rows(jnp.float32), tile_w)
    assert got == want
    assert any(m is not None for m in got)


def test_affine_disp_bound_and_warp_halos():
    M = rot_about_centre((1080, 1920))
    for hw in ((1080, 1920), (37, 61)):
        assert tstencil.affine_disp_bound(M, hw, extend=(3, 5)) == \
            jstencil.affine_disp_bound(M, hw, extend=(3, 5))
    # the image ops' 1-degree rotation about the centre + (4, -3)
    assert tstencil.warp_affine_stage(M, shape=(1080, 1920)).halo == (20, 14)
    M4 = rot_about_centre((2160, 3840))
    assert tstencil.warp_affine_stage(M4, shape=(2160, 3840)).halo == (37, 24)
    # run_warp's chain on the 512x512 plane: warp halo (25, 24) + ladder (34, 34)
    chain = tfeatures.aligned_octave_chain(bench_M(), (512, 512))
    assert chain[0].halo == (25, 24) and tstencil.chain_halo(chain) == (59, 58)


def test_remap_stage_bound_from_the_maps():
    mx, my = smooth_maps(23, 31)
    t = tstencil.remap_stage(torch.from_numpy(mx), torch.from_numpy(my), extend=(2, 1))
    j = jstencil.remap_stage(mx, my, extend=(2, 1))
    assert t.static == j.static and t.halo == tuple(j.halo) == (4, 3)
    assert tstencil.remap_stage(mx, my, bound=(0.5, 7.0)).halo == (1, 8)
    with pytest.raises(ValueError, match="share one"):
        tstencil.remap_stage(mx, my[:-1])


# ---------------------------------------------------------------------------
# The plain version against JAX's oracle
# ---------------------------------------------------------------------------

SHAPES = [(37, 61), (33, 45, 3), (2, 21, 30, 2)]


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", CHAINS)
def test_chains_equal_jax_chain_ref(name, shape, dtype):
    """Against the eager oracle, bit for bit for the chains without a filter
    stage; every mode runs the plain version of its kernel on the CPU, so
    every mode gives the same bits."""
    x = _input(shape, dtype, seed=len(shape))
    hw = _hw(shape)
    want = _tuple(jref.chain_ref(jnp.asarray(x), gather_chain(jstencil, name, hw)))
    tc = gather_chain(tstencil, name, hw)
    first = None
    for mode in MODES:
        got = _tuple(tstencil.fused_chain(torch.from_numpy(x), tc, mode=mode))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if name in EXACT:
                g, w = g.numpy(), np.asarray(w)
                assert g.shape == w.shape and g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                _near(g.numpy(), w)
        first = first or got
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_imgproc_warp_and_remap_match_jax_mode_ref(shape, dtype):
    x = _input(shape, dtype, seed=7)
    hw = _hw(shape)
    M = rot_about_centre(hw, 5.0)
    want = jstencil.fused_chain(jnp.asarray(x), (jstencil.warp_affine_stage(M, shape=hw),),
                                mode="ref")
    _near(timgproc.warp_affine(torch.from_numpy(x), M).numpy(), want, GATHER_ATOL)
    mx, my = smooth_maps(*hw)
    want = jstencil.fused_chain(jnp.asarray(x), (jstencil.remap_stage(mx, my),), mode="ref")
    _near(timgproc.remap(torch.from_numpy(x), mx, my).numpy(), want, GATHER_ATOL)


# ---------------------------------------------------------------------------
# Independent pins (not the oracle)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_identity_warp_and_remap_return_the_input(mode):
    x = torch.from_numpy(_input((37, 61), "u8", seed=3))
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert torch.equal(timgproc.warp_affine(x, eye, mode=mode), x)
    xf = torch.from_numpy(_input((2, 40, 56, 3), "f32", seed=4))
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    assert torch.equal(timgproc.remap(xf, xx, yy, mode=mode), xf)


@pytest.mark.parametrize("mode", MODES)
def test_integer_translation_is_a_shifted_copy(mode):
    """src = dst + (3, -2): a copy shifted with replicate edges."""
    x = _input((33, 49), "u8", seed=5)
    m = np.array([[1.0, 0.0, 3.0], [0.0, 1.0, -2.0]])
    got = timgproc.warp_affine(torch.from_numpy(x), m, mode=mode).numpy()
    want = np.pad(x, ((2, 0), (0, 3)), mode="edge")[:33, 3:]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d", None])
def test_bound_too_small_raises(mode):
    """A declared bound that undershoots the halo ring later stages read
    must raise (JAX's message), not silently clamp the gathers."""
    x = torch.from_numpy(_input((37, 61), "u8", seed=6))
    hw = (37, 61)
    chain = (tstencil.warp_affine_stage(rot_about_centre(hw, 7.0), bound=(0.1, 0.1)),
             tstencil.gaussian_stage(5))
    with pytest.raises(ValueError, match="displacement"):
        tstencil.fused_chain(x, chain, mode=mode)
    jchain = (jstencil.warp_affine_stage(rot_about_centre(hw, 7.0), bound=(0.1, 0.1)),
              jstencil.gaussian_stage(5))
    with pytest.raises(ValueError, match="displacement"):
        jplan.build_chain_geom(jchain, (1, *hw), jnp.uint8, VectorConfig(lmul=1))


@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d", None])
def test_remap_needs_extend_for_downstream(mode):
    x = torch.from_numpy(_input((37, 61), "u8", seed=8))
    yy, xx = np.mgrid[0:37, 0:61].astype(np.float32)
    counters.reset()
    with pytest.raises(ValueError, match="displacement"):
        tstencil.fused_chain(x, (tstencil.remap_stage(xx, yy), tstencil.erode_stage(2)), mode=mode)
    assert sum(counters.PLAIN_CALLS.values()) == 0
    ok = (tstencil.remap_stage(xx, yy, extend=(2, 2)), tstencil.erode_stage(2))
    want = jref.chain_ref(jnp.asarray(x.numpy()),
                          (jstencil.remap_stage(xx, yy, extend=(2, 2)), jstencil.erode_stage(2)))
    np.testing.assert_array_equal(tstencil.fused_chain(x, ok, mode=mode).numpy(), np.asarray(want))


def test_other_gather_errors():
    with pytest.raises(ValueError, match="bound=.*shape="):
        tstencil.warp_affine_stage(np.eye(2, 3))
    mx, my = smooth_maps(20, 30)
    with pytest.raises(ValueError, match="map planes are"):
        tstencil.fused_chain(torch.zeros((21, 30)), (tstencil.remap_stage(mx, my),), mode="window")


# ---------------------------------------------------------------------------
# align_and_detect
# ---------------------------------------------------------------------------

def _blob(h=64, w=80):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), 0.1, np.float32)
    return img + np.exp(-((yy - 30) ** 2 + (xx - 40) ** 2) / (2 * 2.3 ** 2)).astype(np.float32)


@pytest.mark.parametrize("mode", [None, "window", "ref"])
def test_align_and_detect_identity_and_translation(mode):
    """Identity M gives `detect_keypoints`; the inverse map src = dst + (3,
    5) moves the blob at (40, 30) to (37, 25) (tests/test_cv.py:139)."""
    img = torch.from_numpy(_blob())[None]
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    det = tfeatures.detect_keypoints(img, max_kp=4)
    ali = tfeatures.align_and_detect(img, eye, max_kp=4, mode=mode)
    assert torch.equal(det["xy"], ali["xy"]) and bool(det["valid"][0, 0])
    moved = tfeatures.align_and_detect(img, np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 5.0]]),
                                       max_kp=4, mode=mode)
    assert bool(moved["valid"][0, 0])
    assert tuple(int(v) for v in moved["xy"][0, 0]) == (37, 25)
    assert tuple(moved["gray"].shape) == (1, 64, 80)


@pytest.mark.parametrize("M", ["identity", "shift", "bench", "rot"])
def test_align_and_detect_matches_jax(M):
    """Two images per batch, each against JAX's `align_and_detect(...,
    mode="ref")`: the same keypoints, resp and warped gray within the f32
    tolerance."""
    rng = np.random.default_rng(12)
    imgs = np.stack([_blob(), _blob()[::-1].copy()]) + rng.random((2, 64, 80), np.float32) * 0.2
    m = {"identity": np.eye(2, 3), "shift": np.array([[1.0, 0.0, 3.0], [0.0, 1.0, 5.0]]),
         "bench": bench_M(), "rot": rot_about_centre((64, 80), 6.0)}[M]
    got = tfeatures.align_and_detect(torch.from_numpy(imgs), m, max_kp=8)
    for b in range(2):
        want = jfeatures.align_and_detect(jnp.asarray(imgs[b]), m, max_kp=8, mode="ref")
        for k in ("xy", "scale", "valid"):
            np.testing.assert_array_equal(got[k][b].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got["resp"][b].numpy(), np.asarray(want["resp"]),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got["gray"][b].numpy(), np.asarray(want["gray"]),
                                   rtol=RTOL, atol=ATOL)
        assert bool(got["valid"][b, 0])


def test_aligned_octave_chain_matches_jax():
    jc = jfeatures.aligned_octave_chain(bench_M(), (512, 512))
    tc = tfeatures.aligned_octave_chain(bench_M(), (512, 512))
    assert [(s.op, s.tap, s.halo, s.static) for s in tc] == \
        [(s.op, s.tap, tuple(s.halo), s.static) for s in jc]
    for j, t in zip(jc[1:], tc[1:]):
        for a, b in zip(j.weights, t.weights):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Mode resolution and window tiles under the gather halo
# ---------------------------------------------------------------------------

def test_mode_resolution_and_window_tiles_of_the_warp_chain():
    """run_warp's 512x512 f32 chain: a full-width tile's rings are over the
    budget, so mode=None takes tiled2d and an explicit streaming plan
    raises; the window kernel halves its tiles to 16x16 (88.8 KB a slot at
    32x32)."""
    chain = tfeatures.aligned_octave_chain(bench_M(), (512, 512))
    assert driver.resolve_mode(chain, (1, 512, 512), torch.float32) == "tiled2d"
    with pytest.raises(ValueError, match=r"full-width rings .* need \d+ bytes"):
        tstencil.fused_chain(torch.zeros((512, 512)), chain, mode="streaming")
    prog = exec_window.compile_chain(chain)
    assert prog.halo == (59, 58)
    assert (32 + 118) * (32 + 116) * 4 == 88800
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig())
    # the warp's source frame, uncut: (16 + 118) rows at an odd stride of 16 + 116 + 1
    assert prog.slot_floats(16, 16) == (16 + 118) * (16 + 116 + 1)
    assert (th, tw) == (16, 16) and smem == prog.table_smem() + prog.n_slots * 134 * 133 * 4
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        exec_window.pick_tile(prog, LaunchConfig(smem_budget=60_000))
    # the 1080p / 4K warps of the image ops stream (one tile) or tile
    warp4k = (tstencil.warp_affine_stage(rot_about_centre((2160, 3840)), shape=(2160, 3840)),)
    assert driver.resolve_mode(warp4k, (1, 2160, 3840), torch.uint8) == "tiled2d"


# ---------------------------------------------------------------------------
# The kernels' loops, replayed in numpy
# ---------------------------------------------------------------------------

def _remap_maps(chain):
    return [tuple(w.numpy() for w in s.weights) for s in chain if s.op == "remap"]


@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("dtype,shape,tile", [("u8", (2, 37, 61), 16), ("f32", (1, 45, 39), 8)])
def test_window_kernel_replay_of_gathers(name, dtype, shape, tile):
    x = torch.from_numpy(_input(shape, dtype, seed=13))
    chain = gather_chain(tstencil, name, shape[1:])
    prog = exec_window.compile_chain(chain, x.dtype)
    th, tw, _ = exec_window.pick_tile(prog, LaunchConfig(tile_rows=tile, tile_cols=tile))
    assert (th, tw) == (tile, tile) and -(-shape[1] // th) >= 3 and -(-shape[2] // tw) >= 3
    got = _emulate_kernel(x.numpy(), prog, th, tw, _remap_maps(chain))
    want = tref.chain_ref_planes(x, chain)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float32))


REPLAY = [
    ("u8", (1, 45, 61), {"segments": 3}),
    ("f32", (1, 41, 70), {"tiled": True, "tile_w": 16, "segments": 2}),
    ("u8", (2, 29, 37), {"tiled": True, "tile_w": 8, "segments": 2, "rows": 4}),
]


@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("dtype,shape,opts", REPLAY)
def test_stream_kernel_replay_of_gathers(name, dtype, shape, opts):
    x = torch.from_numpy(_input(shape, dtype, seed=14))
    chain = gather_chain(tstencil, name, shape[1:])
    lc = LaunchConfig(stream_rows=opts.get("rows", 8), row_segments=opts["segments"])
    prog, _ = exec_streaming.program(chain, lc.stream_rows, x.dtype, x.device)
    geom = exec_streaming.stream_geometry(prog, tuple(x.shape), lc, tiled=opts.get("tiled", False),
                                          tile_w=opts.get("tile_w"))
    assert geom.n_seg == opts["segments"] and (geom.n_tiles > 1) == opts.get("tiled", False)
    got = _emulate_stream(x.numpy(), prog, geom, _remap_maps(chain))
    want = exec_streaming.stencil_stream_plain(x, chain)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.float64))
