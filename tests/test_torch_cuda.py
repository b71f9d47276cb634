"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc, and skips
elsewhere (the decision is taken in a fixture, never at import).  Run them
on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.

Tolerances: the plain versions repeat the kernels' arithmetic (every
product and sum rounded on its own, in the same order), so the bow kernels
must match exactly and the stencil chain within the repo's f32 oracle
tolerance (rtol 2e-5, atol 2e-3).
"""

import pytest
import torch

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features
from repro_torch.kernels import bow as kbow
from repro_torch.kernels import counters
from repro_torch.kernels import stencil

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _chains():
    return {
        "preprocess": (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage()),
        "octave": features.octave_chain(4),
        "taps_only": (stencil.gaussian_stage(3, tap=0), stencil.gaussian_stage(5, tap=-1)),
    }


@pytest.mark.parametrize("name", ["preprocess", "octave", "taps_only"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 70, 45, 2), (3, 7, 9, 1)])
@pytest.mark.parametrize("tile", [32, 8])
def test_stencil_chain_matches_plain(dev, name, shape, tile):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.rand(shape, generator=g, device=dev) * 255.0
    chain = _chains()[name]
    lc = LaunchConfig(tile_rows=tile, tile_cols=tile)
    counters.reset()
    got = stencil.fused_chain(x, chain, lc=lc)
    want = stencil.fused_chain(x, chain, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_chain"] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (2, 45, 128, 5), (1, 1, 16, 33)])
def test_bow_quantize_hist_matches_plain(dev, B, N, D, K):
    g = torch.Generator(device=dev).manual_seed(B * N + K)
    descs = torch.randn((B, N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    valids = torch.rand((B, N), generator=g, device=dev) < 0.8
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
    want = kbow.quantize_hist_plain(descs, valids, cents)
    assert torch.equal(got, want)


def test_bow_quantize_hist_ties_and_pad_words(dev):
    """Eight words, four of them duplicates (bit-identical s: the lower index
    wins), in a 32-row codebook tile whose 24 pad rows must never win.  The
    descriptors point away from every word, so each real s is > 0 and an
    unmasked zero pad row (s = 0) would take every descriptor."""
    base = torch.rand((4, 32), device=dev) + 1.0
    cents = torch.cat([base, base.flip(0)])
    descs = (-base)[None].repeat(2, 1, 1)
    valids = torch.ones((2, 4), dtype=torch.bool, device=dev)
    got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
    assert torch.equal(got, kbow.quantize_hist_plain(descs, valids, cents))
    assert torch.equal(got.sum(1), torch.full((2,), 4.0, device=dev))
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


@pytest.mark.parametrize("B,K,C", [(256, 250, 10), (3, 1, 7)])
def test_linear_score_matches_plain(dev, B, K, C):
    g = torch.Generator(device=dev).manual_seed(B + K + C)
    h = torch.rand((B, K), generator=g, device=dev)
    w = torch.randn((C, K), generator=g, device=dev)
    b = torch.randn((C,), generator=g, device=dev)
    assert torch.equal(kbow.linear_score(h, w, b), kbow.linear_score_plain(h, w, b))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        stencil.fused_chain(torch.zeros((8, 8), dtype=torch.float64, device=dev),
                            _chains()["preprocess"])
    with pytest.raises(ValueError):
        kbow.linear_score(torch.zeros((2, 3), device=dev), torch.zeros((3, 4), device=dev).T,
                          torch.zeros(4, device=dev))
