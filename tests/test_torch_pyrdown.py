"""pyrDown and the octave's next base in the port, against the JAX package.

The JAX side runs `fused_chain(..., mode="ref")` and `gaussian_octave(...,
mode="ref")`: its Pallas stencil plans do not lower on every jax release,
and the oracle always runs.  The port runs `ops.pyr_down`,
`gaussian_octave` and `fused_chain` on the CPU, which is the plain version
of whichever kernel the mode names.  Inputs are made from a numpy seed.

Tolerances: f32 rtol 2e-5 and atol 2e-3 (the repo's f32 oracle tolerance,
tests/test_pyramid.py), because XLA may contract a multiply and add into one
FMA where the port rounds twice; u8 |diff| <= 1 only at counted .5 ties (0
predicted: the pyrDown taps are dyadic, so every product and sum of u8
values is exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.cv import features as jfeatures
from repro.kernels import stencil as jstencil
from repro.kernels.stencil import plan as jplan

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features as tfeatures
from repro_torch.cv import imgproc as timgproc
from repro_torch.kernels import counters
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.stencil import plan as tplan

RTOL, ATOL = 2e-5, 2e-3
MODES = [None, "window", "streaming", "tiled2d", "ref"]


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32) * 255.0


def _assert_like_jax(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _chains(pkg, feats):
    return {
        "pyr_down": (pkg.pyr_down_stage(),),
        "octave_nb": feats.octave_chain(4),
    }


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 48), (5, 5), (2, 9, 11, 3)])
def test_pyr_down_matches_jax(shape, dtype, mode):
    x = _input(shape, dtype, seed=1)
    want = jstencil.fused_chain(jnp.asarray(x), (jstencil.pyr_down_stage(),), mode="ref")
    got = tops.pyr_down(torch.from_numpy(x), mode=mode)
    hw = (1, 2) if len(shape) == 4 else (0, 1)  # the image axes
    half = list(shape)
    for a in hw:
        half[a] = (shape[a] + 1) // 2
    assert tuple(got.shape) == tuple(half)
    _assert_like_jax(got.numpy(), want)
    assert timgproc.pyr_down is tops.pyr_down


@pytest.mark.parametrize("with_next_base", [True, False])
@pytest.mark.parametrize("mode", [None, "window", "tiled2d", "ref"])
def test_gaussian_octave_plane_matches_jax(with_next_base, mode):
    x = _input((45, 39), "f32", seed=2) / 255.0
    jp, jb = jfeatures.gaussian_octave(jnp.asarray(x), with_next_base=with_next_base, mode="ref")
    tp, tb = tfeatures.gaussian_octave(torch.from_numpy(x), with_next_base=with_next_base,
                                       mode=mode)
    assert tuple(tp.shape) == (7, 45, 39)
    _assert_like_jax(tp.numpy(), jp)
    if with_next_base:
        assert tuple(tb.shape) == (23, 20)
        _assert_like_jax(tb.numpy(), jb)
    else:
        assert tb is None and jb is None


@pytest.mark.parametrize("with_next_base", [True, False])
def test_gaussian_octave_batch_matches_jax(with_next_base):
    x = _input((3, 40, 37), "f32", seed=3) / 255.0
    tp, tb = tfeatures.gaussian_octave(torch.from_numpy(x), with_next_base=with_next_base)
    assert tuple(tp.shape) == (3, 7, 40, 37)
    for b in range(3):
        jp, jb = jfeatures.gaussian_octave(jnp.asarray(x[b]), with_next_base=with_next_base,
                                           mode="ref")
        _assert_like_jax(tp[b].numpy(), jp)
        if with_next_base:
            assert tuple(tb.shape) == (3, 20, 19)
            _assert_like_jax(tb[b].numpy(), jb)
    if not with_next_base:
        assert tb is None


def test_octave_chain_default_matches_jax():
    """The same call builds the same chain in both packages: with the
    terminal pyrDown tap of scale n_scales by default."""
    jc, tc = jfeatures.octave_chain(4), tfeatures.octave_chain(4)
    assert [(s.op, s.tap) for s in tc] == [(s.op, s.tap) for s in jc]
    assert tc[-1].op == "pyr_down" and tc[-1].tap == 4


def test_pyr_down_stage_weights_match_jax():
    ts, js = tstencil.pyr_down_stage(tap=2), jstencil.pyr_down_stage(tap=2)
    assert (ts.op, ts.tap, ts.halo, ts.stride) == (js.op, js.tap, tuple(js.halo), js.stride)
    np.testing.assert_array_equal(ts.weights[0].numpy(), np.asarray(js.weights[0]))
    np.testing.assert_array_equal(ts.weights[0].numpy(),
                                  np.asarray([1, 4, 6, 4, 1], np.float32) / 16)


@pytest.mark.parametrize("op", ["pyr_down", "resize2", "pyr_up", "sep_filter", None])
@pytest.mark.parametrize("hw", [(37, 53), (64, 48), (1, 1), (5, 4)])
def test_stage_out_hw_matches_jax(op, hw):
    assert tstencil.stage_out_hw(op, *hw) == jplan.stage_out_hw(op, *hw)


@pytest.mark.parametrize("name", ["pyr_down", "octave_nb"])
@pytest.mark.parametrize("rows", [8, 16])
def test_plans_of_the_new_chains_match_jax(name, rows):
    jc, tc = _chains(jstencil, jfeatures)[name], _chains(tstencil, tfeatures)[name]
    assert tstencil.chain_accumulated_halo(tc) == jstencil.chain_accumulated_halo(jc)
    jp, tp = jstencil.resolve_chain(jc), tstencil.resolve_chain(tc)
    assert [r[:5] for r in tp] == [(op, m, tuple(h), tuple(s), tuple(u)) for op, m, h, s, u, *_
                                   in jp]
    ji, ti = jstencil.chain_iface(jp, rows), tstencil.chain_iface(tp, rows)
    assert ti == ji
    assert tstencil.chain_stream_plan(tp, ti) == jstencil.chain_stream_plan(jp, ji)


def test_band_downs_and_stride_product():
    octave = tfeatures.octave_chain(4)
    assert tplan.band_downs(octave) == [1] * 7 + [2]
    assert tplan.stride_product(octave) == (2, 2)
    assert tplan.band_downs((tstencil.gaussian_stage(3, tap=0), tstencil.pyr_down_stage())) \
        == [2, 2]
    assert tplan.stride_product(tfeatures.octave_chain(4, with_next_base=False)) == (1, 1)
    assert tplan.aligned_pad(35, 2) == 36 and tplan.aligned_pad(36, 2) == 36


def test_strided_geometry_errors():
    """JAX's errors: odd step rows, an odd column tile narrower than the
    plane; the kernels' own: a pyrDown that is not the last stage."""
    x = torch.zeros((40, 70))
    pyr = (tstencil.pyr_down_stage(),)
    with pytest.raises(ValueError, match="stride product"):
        tstencil.fused_chain(x, pyr, mode="streaming", lc=LaunchConfig(stream_rows=5))
    with pytest.raises(ValueError, match="tile_w=33"):
        tstencil.fused_chain(x, pyr, mode="tiled2d", tile_w=33)
    tstencil.fused_chain(x, pyr, mode="tiled2d", tile_w=70)  # one full-width tile
    with pytest.raises(NotImplementedError, match="before the chain's last"):
        tstencil.fused_chain(x, pyr + (tstencil.gaussian_stage(3),), mode="streaming")
    # the plain version runs the general chain
    out = tstencil.fused_chain(x, pyr + (tstencil.gaussian_stage(3),), mode="ref")
    assert tuple(out.shape) == (20, 35)


def test_octave_next_base_full_width_streaming_raises_naming_the_bytes():
    """The 36-row halo of the octave with its next base: the full-width
    plan of a 512x512 plane is over the shared-memory budget."""
    x = torch.zeros((512, 512))
    with pytest.raises(ValueError, match=r"full-width rings .* need \d+ bytes"):
        tfeatures.gaussian_octave(x, mode="streaming")
    counters.reset()
    tfeatures.gaussian_octave(x[:40, :40])
    assert counters.PLAIN_CALLS["stencil_stream"] == 1


def test_small_planes_take_the_window_kernel():
    counters.reset()
    tfeatures.gaussian_octave(torch.zeros((2, 36, 36)))
    assert counters.PLAIN_CALLS["stencil_chain"] == 1 and sum(counters.LAUNCHES.values()) == 0
