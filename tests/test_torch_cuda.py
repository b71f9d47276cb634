"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc, and skips
elsewhere (the decision is taken in a fixture, never at import).  Run them
on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.

Tolerances: the plain versions repeat the kernels' arithmetic (every
product and sum rounded on its own, in the same order), so the bow and
gbdt kernels must match exactly, `stencil_stream` exactly on u8 and f32,
and `stencil_chain` within the repo's f32 oracle tolerance (rtol 2e-5,
atol 2e-3) in its older test and exactly in the mode-agreement test.
`flash_attention` sums its dot products in another order than its plain
version and the f32 oracle, and each rounds once to the output dtype, so
it is held to `kernels.attention.AGREE`: one rounding apart in f16 / bf16
(rtol 2^-10 / 2^-7, atol 1e-4), rtol = atol = 2e-4 in f32 (the JAX kernel
test's, tests/test_kernels_attention.py:20).
"""

import pytest
import torch

from repro_torch.core.device import LaunchConfig
from repro_torch.cv import features, pipeline
from repro_torch.cv.config import PipelineConfig
from repro_torch.data.synthetic import ImageStream
from repro_torch.configs import reduced_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import bow as kbow
from repro_torch.kernels import counters
from repro_torch.kernels import gbdt as kgbdt
from repro_torch.kernels import ops, ref, stencil, unfused
from repro_torch.models.lm import LM
from repro_torch.serve import cv_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _chains():
    return {
        "preprocess": (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage()),
        "octave": features.octave_chain(4, with_next_base=False),
        "octave_nb": features.octave_chain(4),
        "pyr_down": (stencil.pyr_down_stage(),),
        "taps_only": (stencil.gaussian_stage(3, tap=0), stencil.gaussian_stage(5, tap=-1)),
    }


@pytest.mark.parametrize("name", ["preprocess", "octave", "taps_only", "octave_nb", "pyr_down"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 70, 45, 2), (3, 7, 9, 1)])
@pytest.mark.parametrize("tile", [32, 8])
def test_stencil_chain_matches_plain(dev, name, shape, tile):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.rand(shape, generator=g, device=dev) * 255.0
    chain = _chains()[name]
    lc = LaunchConfig(tile_rows=tile, tile_cols=tile)
    counters.reset()
    got = stencil.fused_chain(x, chain, mode="window", lc=lc)
    want = stencil.fused_chain(x, chain, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_chain"] == 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-3)


def _slice_chains():
    k1 = stencil.filter_stage(torch.outer(*(2 * (ref.gaussian_kernel1d(13),))))
    return {
        **_chains(),
        "filter2d_k13": (k1,),
        "erode_r3": (stencil.erode_stage(3),),
        "acceptance": (stencil.gaussian_stage(5), stencil.erode_stage(1),
                       stencil.threshold_stage(100.0)),
        "mixed": (stencil.box_stage(1), stencil.gaussian_stage(3, tap=0), stencil.dilate_stage(1),
                  stencil.affine_stage(0.5, 3.25), stencil.gaussian_stage(5, tap=-1)),
    }


def _image(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    return torch.rand(shape, generator=g, device=dev) * 255.0


@pytest.mark.parametrize("name", ["preprocess", "octave", "taps_only", "filter2d_k13",
                                  "erode_r3", "acceptance", "mixed", "octave_nb", "pyr_down"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,lc", [
    ((2, 37, 53, 3), LaunchConfig()),
    ((1, 300, 211, 1), LaunchConfig(row_segments=5, stream_rows=4)),
    ((1, 77, 640, 1), LaunchConfig(tile2d_cols=96, row_segments=3)),
])
@pytest.mark.parametrize("mode", ["streaming", "tiled2d"])
def test_stencil_stream_matches_plain(dev, name, dtype, shape, lc, mode):
    """Bit for bit against the plain version, in one launch, on ragged
    tiles, several row segments and heights that are not whole steps."""
    x = _image(dev, shape, dtype, seed=sum(shape))
    chain = _slice_chains()[name]
    counters.reset()
    if mode == "streaming" and stencil.resolve_mode(chain, shape[:0] + (1,) + shape[1:3], dtype,
                                                    lc) == "tiled2d":
        # full-width rings over the budget: the explicit plan refuses
        with pytest.raises(ValueError, match="bytes"):
            stencil.fused_chain(x, chain, mode=mode, lc=lc)
        assert sum(counters.LAUNCHES.values()) == 0
        return
    got = stencil.fused_chain(x, chain, mode=mode, lc=lc)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["stencil_stream"] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = stencil.fused_chain(x, chain, mode="ref")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["acceptance", "filter2d_k13", "mixed", "octave", "octave_nb",
                                  "pyr_down"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_window_streaming_and_tiled2d_are_bit_identical(dev, name, dtype):
    x = _image(dev, (2, 96, 130, 1), dtype, seed=3)
    chain = _slice_chains()[name]
    outs = {}
    for mode in ("window", "streaming", "tiled2d"):
        lc = LaunchConfig(tile2d_cols=64) if mode == "tiled2d" else LaunchConfig()
        o = stencil.fused_chain(x, chain, mode=mode, lc=lc)
        outs[mode] = o if isinstance(o, tuple) else (o,)
    for mode in ("streaming", "tiled2d"):
        for a, b in zip(outs[mode], outs["window"], strict=True):
            assert torch.equal(a, b), mode


def test_streaming_over_the_budget_raises_on_the_card(dev):
    x = torch.zeros((2160, 3840), dtype=torch.uint8, device=dev)
    counters.reset()
    with pytest.raises(ValueError, match="bytes"):
        stencil.fused_chain(x, _slice_chains()["filter2d_k13"], mode="streaming")
    assert counters.snapshot()["launches"]["stencil_stream"] == 0


@pytest.mark.parametrize("mode", ["window", "streaming", "tiled2d"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape", [(1081, 1919), (37, 53), (5, 5), (2, 64, 48, 3)])
def test_pyr_down_matches_plain(dev, mode, dtype, shape):
    """`ops.pyr_down` in one launch, bit for bit, at odd and even sizes."""
    x = _image(dev, shape, dtype, seed=sum(shape))
    lc = LaunchConfig(tile2d_cols=64, row_segments=3) if mode == "tiled2d" else LaunchConfig()
    counters.reset()
    got = ops.pyr_down(x, mode=mode, lc=lc)
    torch.cuda.synchronize()
    kernel = "stencil_chain" if mode == "window" else "stencil_stream"
    assert counters.LAUNCHES[kernel] == 1 and sum(counters.PLAIN_CALLS.values()) == 0
    want = ops.pyr_down(x, mode="ref")
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("shape", [(37, 53), (512, 512), (1081, 1919)])
def test_seed_gaussian_blur_matches_plain(dev, ksize, shape):
    x = _image(dev, shape, torch.uint8, seed=ksize + shape[0])
    counters.reset()
    got = unfused.seed_gaussian_blur_2d(x, ksize)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_gaussian_blur"] == 1
    assert torch.equal(got, unfused.seed_gaussian_blur_2d(x, ksize, mode="ref"))


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("shape", [(37, 53), (512, 512), (1081, 1919)])
def test_seed_erode_matches_plain(dev, r, shape):
    x = _image(dev, shape, torch.uint8, seed=r + shape[1])
    counters.reset()
    got = unfused.seed_erode_2d(x, r)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["seed_erode"] == 1
    assert torch.equal(got, unfused.seed_erode_2d(x, r, mode="ref"))


@pytest.mark.parametrize(
    "thresh", [0, 100.5, 254.5, 255.9, 255.99999999, 256, -0.5, -1, -5, 300, 511.7, -256])
def test_seed_threshold_matches_plain(dev, thresh):
    x = (torch.arange(37 * 53, device=dev) % 256).to(torch.uint8).reshape(37, 53)  # every value
    got = unfused.seed_threshold_2d(x, thresh)
    assert torch.equal(got, unfused.seed_threshold_2d(x, thresh, mode="ref"))


def test_seed_pipeline_launches_per_plane_and_equals_staged(dev):
    """B*C launches of each seed kernel, no plain call; equal to its plain
    version and to the staged per-op path through the fused engine."""
    batch = _image(dev, (2, 40, 72, 3), torch.uint8, seed=9)
    counters.reset()
    got = unfused.seed_pipeline(batch, blur_ksize=5, erode_r=1, thresh=100.0)
    torch.cuda.synchronize()
    snap = counters.snapshot()
    assert {k: snap["launches"][k] for k in ("seed_gaussian_blur", "seed_erode",
                                             "seed_threshold")} == dict.fromkeys(
        ("seed_gaussian_blur", "seed_erode", "seed_threshold"), 6)
    assert sum(snap["plain_calls"].values()) == 0
    want = unfused.seed_pipeline(batch, blur_ksize=5, erode_r=1, thresh=100.0, mode="ref")
    assert torch.equal(got, want)
    staged = torch.stack([torch.stack([
        ops.threshold(ops.erode(ops.gaussian_blur(batch[b, :, :, c], 5), 1), 100.0)
        for c in range(3)], -1) for b in range(2)])
    assert torch.equal(got, staged)


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


@pytest.mark.parametrize("N,D,K", [(32768, 128, 250), (45, 16, 33), (1, 8, 1)])
def test_bow_assign_matches_plain(dev, N, D, K):
    """Random descriptors, then two rows that tie exactly (a duplicated word)
    and a codebook whose last tile is mostly pad rows (K % 32 != 0)."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    desc = torch.randn((N, D), generator=g, device=dev)
    cents = torch.randn((K, D), generator=g, device=dev)
    if K > 2:
        cents[K - 1] = cents[1]  # a duplicate: ties go to word 1
        desc[0] = cents[1] + 1e-3
    counters.reset()
    got_i, got_d2 = kbow.bow_assign(desc, cents)
    want_i, want_d2 = kbow.bow_assign_plain(desc, cents)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["bow_assign"] == 1
    assert torch.equal(got_i, want_i) and torch.equal(got_d2, want_d2)
    if K > 2:
        assert int(got_i[0]) == 1


def test_bow_assign_ties_and_pad_words(dev):
    """The quantize test's codebook: duplicate words (the lower index wins)
    in a tile whose pad rows must never win; batched input keeps its shape."""
    base = torch.rand((4, 32), device=dev) + 1.0
    cents = torch.cat([base, base.flip(0)])
    descs = (-base)[None].repeat(2, 1, 1)
    got_i, got_d2 = kbow.bow_assign(descs, cents)
    want_i, want_d2 = kbow.bow_assign_plain(descs.reshape(8, 32), cents)
    assert got_i.shape == (2, 4)
    assert torch.equal(got_i.reshape(8), want_i) and torch.equal(got_d2.reshape(8), want_d2)
    assert bool((got_i < 4).all())
    empty_i, _ = kbow.bow_assign(torch.zeros((0, 32), device=dev), cents)
    assert empty_i.shape == (0,)


@pytest.mark.parametrize("B,F,T,depth,C", [(1024, 250, 16, 3, 10), (5, 7, 3, 2, 1)])
def test_gbdt_score_matches_plain(dev, B, F, T, depth, C):
    g = torch.Generator(device=dev).manual_seed(B + F)
    x = torch.rand((B, F), generator=g, device=dev)
    feat = torch.randint(0, F, (T, depth), generator=g, device=dev, dtype=torch.int32)
    thr = torch.rand((T, depth), generator=g, device=dev)
    leaf = torch.randn((T, 2**depth, C), generator=g, device=dev)
    base = torch.randn((C,), generator=g, device=dev)
    feat[0] = torch.arange(depth, dtype=torch.int32, device=dev)
    x[: min(B, 4), :depth] = thr[0]  # x == thr goes left at every level of tree 0
    counters.reset()
    got_s, got_li = kgbdt.gbdt_score(x, feat, thr, leaf, base)
    want_s, want_li = kgbdt.gbdt_score_plain(x, feat, thr, leaf, base)
    torch.cuda.synchronize()
    assert counters.LAUNCHES["gbdt_score"] == 1
    assert torch.equal(got_li, want_li) and torch.equal(got_s, want_s)
    assert bool((got_li[: min(B, 4), 0] == 0).all())


@pytest.mark.parametrize("head", ["svm", "gbdt"])
def test_train_on_the_card(dev, head):
    """Training on the card runs every assignment through the kernel and no
    plain version: the preprocess chain through `stencil_stream`, the octave
    (32x32 planes under its 34-pixel halo) through `stencil_chain`, and 21
    bow_assign launches (20 k-means iterations + the histograms)."""
    stream = ImageStream(res=32)
    imgs, labels = stream.batch(64, split=31)
    cfg = PipelineConfig(preprocess=True, head=head)
    counters.reset()
    model = pipeline.train(imgs, labels, cfg, dict_size=32, device=dev)
    torch.cuda.synchronize()
    snap = counters.snapshot()
    assert snap["launches"]["stencil_chain"] == 1 and snap["launches"]["stencil_stream"] == 1
    assert snap["launches"]["bow_assign"] == 21
    assert sum(snap["plain_calls"].values()) == 0
    assert model.centroids.device.type == "cuda"
    assert bool(torch.isfinite(model.centroids).all())
    pred = pipeline.predict(model, imgs, cfg, device=dev)
    assert pred.shape == (64,) and pred.device.type == "cuda"


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,S,T,H,hd",
    [(1, 128, 128, 1, 64), (2, 200, 200, 4, 64), (1, 300, 300, 2, 128), (2, 257, 257, 2, 16),
     (1, 130, 130, 2, 256), (1, 100, 160, 2, 64), (2, 150, 70, 3, 32), (1, 1, 65, 1, 8)],
)
def test_flash_attention_matches_plain(dev, dtype, causal, B, S, T, H, hd):
    g = torch.Generator(device=dev).manual_seed(S * 7 + T + hd)
    q, k, v = (torch.randn((B, n, H, hd), generator=g, device=dev).to(dtype) for n in (S, T, T))
    counters.reset()
    got = kattn.flash_attention(q, k, v, causal=causal)
    want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
    torch.cuda.synchronize()
    assert counters.LAUNCHES["flash_attention"] == 1
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = kattn.AGREE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    oracle = ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), oracle.float(), rtol=rtol, atol=atol)


def test_flash_attention_refuses_gqa_and_an_over_budget_tile(dev):
    q = torch.zeros((1, 64, 4, 256), device=dev)
    kv = torch.zeros((1, 64, 2, 256), device=dev)
    counters.reset()
    with pytest.raises(ValueError, match="KV heads"):
        kattn.flash_attention(q, kv, kv)
    # f32 at hd 256 needs 214,528 bytes a block: it fits the card, not a smaller budget
    with pytest.raises(ValueError, match="214528 bytes"):
        kattn.flash_attention(q, q, q, lc=LaunchConfig(smem_budget=150_000))
    assert counters.LAUNCHES["flash_attention"] == 0
    assert counters.PLAIN_CALLS["flash_attention"] == 0
    out = kattn.flash_attention(q, q, q)
    assert counters.LAUNCHES["flash_attention"] == 1 and out.shape == q.shape


def test_reduced_generate_launches_flash_once_per_layer(dev):
    cfg = reduced_config("gemma-7b")
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=torch.Generator().manual_seed(1))
    counters.reset()
    out = cv_engine.generate(model, prompts, steps=5)
    torch.cuda.synchronize()
    assert out.shape == (3, 5) and out.device.type == "cuda"
    assert counters.LAUNCHES["flash_attention"] == cfg.n_layers
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert torch.equal(out, cv_engine.generate(model, prompts, steps=5))
