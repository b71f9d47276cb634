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
from repro_torch.kernels.stencil import exec_window

RTOL, ATOL = 2e-5, 2e-3


def _preprocess(pkg):
    return (pkg.gaussian_stage(5), pkg.erode_stage(1), pkg.grad_stage())


def _chains():
    """(name, JAX chain, port chain) for the BoW path's two chains."""
    jo = jfeatures.octave_chain(4, with_next_base=False)
    to = tfeatures.octave_chain(4)
    return {
        "preprocess": (_preprocess(jstencil), _preprocess(tstencil)),
        "octave": (jo, to),
    }


CASES = [
    ("preprocess", (2, 40, 48, 3)),
    ("octave", (3, 48, 56)),
    ("octave", (2, 32, 32)),  # planes no larger than the octave's halo of 34
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


@pytest.mark.parametrize("op", ["pyr_down", "sobel", "pyr_up"])
def test_unported_stage_ops_raise(op):
    with pytest.raises(NotImplementedError):
        tstencil.Stage(op)


def test_grad_pair_reduction_not_ported():
    chain = (tstencil.gaussian_stage(3), tstencil.gaussian_stage(3, tap=-1), tstencil.grad_stage())
    assert tstencil.resolve_chain(chain)[-1][1] == "reduce"
    with pytest.raises(NotImplementedError):
        exec_window.compile_chain(chain)
    with pytest.raises(NotImplementedError):
        tstencil.fused_chain(torch.zeros((8, 8)), chain)


# ---------------------------------------------------------------------------
# The kernel's block loop, replayed in numpy from the planned step table
# ---------------------------------------------------------------------------

def _emulate_kernel(planes: np.ndarray, prog, th: int, tw: int) -> np.ndarray:
    N, H, W = planes.shape
    ph, pw = prog.halo
    WH, WW = th + 2 * ph, tw + 2 * pw
    wts = np.asarray(prog.weights, np.float32)
    out = np.full((prog.n_bands, N, H, W), np.nan, np.float32)
    for n in range(N):
        for ty0 in range(0, H, th):
            for tx0 in range(0, W, tw):
                sm = np.full((prog.n_slots, WH, WW), np.nan, np.float32)
                ys = np.clip(ty0 - ph + np.arange(WH), 0, H - 1)
                xs = np.clip(tx0 - pw + np.arange(WW), 0, W - 1)
                sm[0] = planes[n][ys][:, xs]
                for s in prog.steps:
                    r0, r1 = ph - s["rh"], ph + th + s["rh"]
                    c0, c1 = pw - s["rw"], pw + tw + s["rw"]
                    hy, hx = s["kh"] // 2, s["kw"] // 2
                    src = sm[s["src"]].copy()
                    if s["op"] in (0, 1):
                        cols = slice(c0 + hx, c1 - hx)
                        taps = [src[r0:r1, c0 + q:c1 - 2 * hx + q] for q in range(s["kw"])]
                        if s["op"] == 0:
                            kx = wts[s["wx"]:s["wx"] + s["kw"]]
                            acc = kx[0] * taps[0]
                            for q in range(1, s["kw"]):
                                acc = acc + kx[q] * taps[q]
                        else:
                            acc = np.minimum.reduce(taps)
                        sm[s["tmp"], r0:r1, cols] = acc
                        tmp = sm[s["tmp"]]
                        ctaps = [tmp[r0 + q:r1 - 2 * hy + q, cols] for q in range(s["kh"])]
                        if s["op"] == 0:
                            ky = wts[s["wy"]:s["wy"] + s["kh"]]
                            acc = ky[0] * ctaps[0]
                            for q in range(1, s["kh"]):
                                acc = acc + ky[q] * ctaps[q]
                        else:
                            acc = np.minimum.reduce(ctaps)
                        sm[s["dst"], r0 + hy:r1 - hy, cols] = acc
                    elif s["op"] == 2:
                        i, j = slice(r0 + 1, r1 - 1), slice(c0 + 1, c1 - 1)
                        dy = (src[r0 + 2:r1, j] - src[r0:r1 - 2, j]) * np.float32(0.5)
                        dx = (src[i, c0 + 2:c1] - src[i, c0:c1 - 2]) * np.float32(0.5)
                        sm[s["dst"], i, j] = np.sqrt(dx * dx + dy * dy)
                    if s["store"] >= 0:
                        hh, ww = min(th, H - ty0), min(tw, W - tx0)
                        out[s["store"], n, ty0:ty0 + hh, tx0:tx0 + ww] = \
                            sm[s["dst"], ph:ph + hh, pw:pw + ww]
    return out


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
    prog = exec_window.compile_chain(tfeatures.octave_chain(4))
    assert prog.n_slots == 3 and prog.n_bands == 7 and prog.halo == (34, 34)
    stores = [s["store"] for s in prog.steps if s["store"] >= 0]
    assert stores == list(range(7))
    th, tw, smem = exec_window.pick_tile(prog, LaunchConfig())
    assert (th, tw) == (32, 32) and smem == 3 * 100 * 100 * 4


def test_pick_tile_halves_under_a_small_budget():
    prog = exec_window.compile_chain(tfeatures.octave_chain(4))
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
