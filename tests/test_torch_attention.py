"""The port's attention against the JAX package's, on the CPU.

On the CPU the port's `flash_attention` runs its plain version; the JAX side
runs its Pallas kernel in interpret mode (``VectorConfig(lmul=1)`` and the
default lmul, as tests/test_kernels_attention.py runs it) and its oracle
`ref.attention_ref`.

Tolerances, with their reasons:
  * `flash_attention_plain` against JAX's kernel and oracle:
    `kernels.attention.AGREE`, rtol = atol = 2e-4 in f32 (the JAX kernel
    test's, tests/test_kernels_attention.py:20) and one bf16 rounding apart
    in bf16 (rtol 2^-7, atol 1e-4; within the JAX test's 3e-2, l.29): all
    three compute in f32 and round once, summing dot products in another
    order;
  * the port's `attention_ref` and `dense_attention` against JAX's: rtol =
    atol = 1e-5 in f32, the same formula in another summation order;
  * the replay of the 16-bit kernel's tile walk (`_replay_wgmma`) against
    JAX's kernel and `flash_attention_plain`: `AGREE` in bf16 and f16 (it
    too rounds once to the output dtype), and its output within 2^-16 of
    max |v| from the same walk with f32 p.v (the p_hi + p_lo split leaves
    ~2^-18 of p in bf16, ~2^-22 in f16 above its subnormals); the share of
    its outputs that differ from the plain version's within
    `OFF_PLAIN_SHARE`, which the same walk with p_hi alone exceeds; the
    same on GQA shapes (query head h reading KV head h // (H // Hkv)),
    against JAX's kernel over the repeated KV;
  * `blockwise_attention` against JAX's `attention` above 8192 positions:
    rtol = atol = 1e-5 in f32, as `dense_attention`.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import lm as jlm

from repro_torch.core.device import SMEM_MAX_BYTES
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm


# (B, S, T, H, hd): the JAX kernel test's shapes, hd 16 and 256, S != T
SHAPES = [
    (1, 128, 128, 1, 64),
    (2, 200, 200, 4, 64),
    (1, 300, 300, 2, 128),
    (2, 96, 96, 3, 16),
    (1, 130, 130, 2, 256),
    (1, 100, 160, 2, 64),
    (2, 150, 70, 1, 32),
]


def _qkv(shape, dtype, seed):
    B, S, T, H, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    # the port gets JAX's rounding of the inputs, widened exactly
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_jax_kernel_and_oracle(shape, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype, sum(shape) + causal)
    counters.reset()
    got = kattn.flash_attention(tq, tk, tv, causal=causal)
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rtol, atol = kattn.AGREE[tq.dtype]
    for vc in (VectorConfig(lmul=1), VectorConfig()):
        want = jops.flash_attention(jq, jk, jv, causal=causal, vc=vc)
        np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(oracle.astype(jnp.float32)), rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 40, 40, 2, 16), (1, 33, 70, 3, 8)])
def test_attention_ref_matches_jax(shape, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, "float32", 7)
    got = tref.attention_ref(tq, tk, tv, causal=causal)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_plain_first_row_and_empty_keys():
    """Causal row 0 sees key 0 alone, whatever T; with no keys at all every
    row stays masked and the output is 0, as the kernel's acc / max(l, 1e-30)."""
    _, (tq, tk, tv) = _qkv((1, 70, 130, 1, 16), "float32", 3)
    got = kattn.flash_attention_plain(tq, tk, tv, causal=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0].numpy(), tv[:, 0].numpy(), rtol=1e-6, atol=1e-6)
    empty = kattn.flash_attention_plain(tq, tk[:, :0], tv[:, :0], causal=False)
    assert torch.equal(empty, torch.zeros_like(tq))


def test_ops_exports_the_wrapper():
    assert tops.flash_attention is kattn.flash_attention


@pytest.mark.parametrize(
    "bad",
    ["gqa", "dtype", "mixed_dtype", "head_dim", "noncontig", "mode", "rank"],
)
def test_flash_attention_refuses(bad):
    q = torch.zeros((1, 8, 4, 16))
    k = v = torch.zeros((1, 8, 4, 16))
    kw = {}
    if bad == "gqa":  # a KV head count that does not divide the query heads
        k = v = torch.zeros((1, 8, 3, 16))
    elif bad == "dtype":
        q = k = v = torch.zeros((1, 8, 4, 16), dtype=torch.float64)
    elif bad == "mixed_dtype":
        k = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    elif bad == "head_dim":
        q = k = v = torch.zeros((1, 8, 4, 12))
    elif bad == "noncontig":
        q = torch.zeros((1, 4, 8, 16)).transpose(1, 2)
    elif bad == "mode":
        kw = {"mode": "window"}
    elif bad == "rank":
        q = torch.zeros((8, 4, 16))
    counters.reset()
    with pytest.raises(ValueError):
        kattn.flash_attention(q, k, v, **kw)
    assert counters.PLAIN_CALLS["flash_attention"] == 0


def test_smem_bytes_fit_the_card_at_hd_256():
    """gemma-7b's head dim: 230,472 bytes a block in bf16 and f16 (the
    128-row q tile, 2 stages of 64-row K and V tiles, two warpgroups' p_hi
    and p_lo tiles, the alignment slack and 9 mbarriers) and 214,528 in f32
    (the SIMT body), both under the 227 KB a block may use.  The 16-bit
    layout pads the head dim to 64-channel chunks: hd 16 takes hd 64's
    bytes."""
    assert kattn.smem_bytes(256, 2) == 230_472 <= SMEM_MAX_BYTES
    assert kattn.smem_bytes(256, 4) == 214_528 <= SMEM_MAX_BYTES
    assert kattn.smem_bytes(16, 2) == kattn.smem_bytes(64, 2) < kattn.smem_bytes(128, 2)
    assert kattn.smem_bytes(128, 2) < kattn.smem_bytes(136, 2) == kattn.smem_bytes(256, 2)
    assert kattn.smem_bytes(16, 4) < kattn.smem_bytes(64, 4) < kattn.smem_bytes(128, 4)


def test_wgmma_layout_at_hd_256_fits_its_two_stage_ring():
    """q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB of tiles, with the
    32 KB of p tiles, the slack and the mbarriers, fits the 227 KB a block
    may use; a third stage (64 KB more) would not."""
    row = 2 * 256  # bytes of one bf16 row at hd 256
    tiles = (kattn.WGMMA_BQ + 2 * kattn.STAGES * kattn.BKV) * row
    assert kattn.STAGES == 2 and tiles == 192 * 1024 and kattn.P_TILES == 32 * 1024
    assert kattn.smem_bytes(256, 2) == tiles + kattn.P_TILES + kattn.WGMMA_EXTRA <= SMEM_MAX_BYTES
    assert kattn.smem_bytes(256, 2) + 2 * kattn.BKV * row > SMEM_MAX_BYTES


def _replay_wgmma(q, k, v, causal, split=True):
    """The 16-bit kernel's arithmetic on the CPU: per 128-row query tile (a
    causal tile stops at its last row), 64-key tiles, the online softmax in
    f32, p split into p_hi = T(p) and p_lo = T(p - p_hi) in q's dtype T and
    p_hi.v + p_lo.v summed in f32; out rounded once to T.  Returns that and
    the largest distance of its f32 output from the same walk with f32 p.v,
    over max |v|.  ``split=False`` drops p_lo: one 16-bit pass of p.  k and v
    may hold Hkv < H heads: the block of query head h reads KV head
    h // (H // Hkv), as the kernel's K and V tensor maps do."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    group = torch.arange(H) // (H // k.shape[2])
    qf = q.to(torch.float32).transpose(1, 2)  # (B, H, n, hd)
    kf, vf = (x.to(torch.float32).transpose(1, 2)[:, group] for x in (k, v))
    out = torch.zeros((B, H, S, hd))
    exact = torch.zeros((B, H, S, hd))
    for q0 in range(0, S, kattn.WGMMA_BQ):
        qb = qf[:, :, q0 : q0 + kattn.WGMMA_BQ]
        qi = torch.arange(q0, q0 + qb.shape[2])[:, None]
        m = torch.full(qb.shape[:3], kattn.NEG)
        l = torch.zeros(qb.shape[:3])  # noqa: E741
        acc = torch.zeros(qb.shape)
        acc_f32 = torch.zeros(qb.shape)
        kv_end = min(T, q0 + kattn.WGMMA_BQ, S) if causal else T
        for k0 in range(0, kv_end, kattn.BKV):
            kb, vb = kf[:, :, k0 : k0 + kattn.BKV], vf[:, :, k0 : k0 + kattn.BKV]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                ki = torch.arange(k0, k0 + kb.shape[2])[None, :]
                s = torch.where(ki <= qi, s, kattn.NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(m_new <= kattn.NEG / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(m <= kattn.NEG / 2, 0.0, torch.exp(m - m_safe))[..., None]
            l = l * corr[..., 0] + torch.sum(p, dim=-1)  # noqa: E741
            p_hi = p.to(q.dtype).to(torch.float32)
            p_lo = (p - p_hi).to(q.dtype).to(torch.float32) if split else torch.zeros_like(p)
            acc = acc * corr + (p_hi @ vb + p_lo @ vb)
            acc_f32 = acc_f32 * corr + p @ vb
            m = m_new
        den = torch.clamp(l, min=1e-30)[..., None]
        out[:, :, q0 : q0 + qb.shape[2]] = acc / den
        exact[:, :, q0 : q0 + qb.shape[2]] = acc_f32 / den
    dist = float((out - exact).abs().max() / vf.abs().max())
    return out.transpose(1, 2).to(q.dtype), dist


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_replay_matches_jax_kernel_and_plain(shape, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype, sum(shape) + causal)
    got, dist = _replay_wgmma(tq, tk, tv, causal)
    print(f"p_hi + p_lo against f32 p.v: {dist:.3g} of max |v| (2^{math.log2(dist or 2**-60):.1f})")
    assert dist <= 2.0**-16
    rtol, atol = kattn.AGREE[tq.dtype]
    plain = kattn.flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=rtol, atol=atol)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_p_split_is_needed_within_off_plain_share(shape, causal, dtype):
    """`AGREE` passes one 16-bit pass of p as well as the split, so the card
    also holds the kernel to `OFF_PLAIN_SHARE`: the share of outputs that
    differ from the plain version's (f32 p.v, rounded once).  The replay of
    the split stays within it, the same walk with p_hi alone does not."""
    _, (tq, tk, tv) = _qkv(shape, dtype, sum(shape) + causal)
    plain = kattn.flash_attention_plain(tq, tk, tv, causal=causal)
    split, _ = _replay_wgmma(tq, tk, tv, causal)
    single, _ = _replay_wgmma(tq, tk, tv, causal, split=False)
    off_split = float((split != plain).float().mean())
    off_single = float((single != plain).float().mean())
    print(f"outputs off the plain version's: split {off_split:.5f}, p_hi alone {off_single:.5f}")
    assert off_split <= kattn.OFF_PLAIN_SHARE < off_single


# (B, S, T, H, Hkv, hd): group ratios 2, 4 and 9 (starcoder2-7b's 36 over 4),
# hd 120 (h2o-danube-3-4b's, padded to 128 channels by the kernel) and S != T
GQA_SHAPES = [
    (2, 130, 130, 4, 2, 64),
    (1, 200, 200, 8, 2, 120),
    (1, 140, 140, 36, 4, 128),
    (2, 100, 160, 4, 1, 32),
]


def _gqa_qkv(shape, dtype, seed):
    """q (B, S, H, hd), k / v (B, T, Hkv, hd) from a numpy seed: JAX's with k
    and v repeated to H heads (its kernel is MHA only), the port's not."""
    B, S, T, H, G, hd = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((B, S, H, hd), (B, T, G, hd), (B, T, G, hd))]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in (jq, jk, jv)]
    return (jq, jattn._repeat_kv(jk, H // G), jattn._repeat_kv(jv, H // G)), tx


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", GQA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_replay_over_kv_head_groups(shape, causal, dtype):
    """The 16-bit kernel's tile walk with each query head reading its group's
    KV head: within `AGREE` of the plain version and of JAX's kernel over the
    repeated KV, and within `OFF_PLAIN_SHARE` of the plain version, which the
    same walk with p_hi alone exceeds."""
    (jq, jk, jv), (tq, tk, tv) = _gqa_qkv(shape, dtype, sum(shape) + causal)
    got, dist = _replay_wgmma(tq, tk, tv, causal)
    assert dist <= 2.0**-16
    rtol, atol = kattn.AGREE[tq.dtype]
    plain = kattn.flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=rtol, atol=atol)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)
    single, _ = _replay_wgmma(tq, tk, tv, causal, split=False)
    off_split = float((got != plain).float().mean())
    off_single = float((single != plain).float().mean())
    print(f"outputs off the plain version's: split {off_split:.5f}, p_hi alone {off_single:.5f}")
    assert off_split <= kattn.OFF_PLAIN_SHARE < off_single


def test_planted_faults_edit_the_kernel_source_once():
    """scripts/torch_flash_faults.py plants each fault by one textual edit of
    csrc/flash_attn.cu: each fault's source text is there exactly once."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_flash_faults", root / "scripts" / "torch_flash_faults.py"
    )
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    text = (root / "src" / "repro_torch" / "csrc" / "flash_attn.cu").read_text()
    assert set(faults.FAULTS) == {
        "zeros", "diag_bf16", "last_key_bf16", "den_1pct_bf16", "kv_head_0", "p_lo_dropped"
    }
    for name, (_, old, new) in faults.FAULTS.items():
        assert text.count(old) == 1 and new != old, name


# ---------------------------------------------------------------------------
# dense_attention and the routing of models.attention.attention
# ---------------------------------------------------------------------------


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pos", [5, 11, 17, 30])
@pytest.mark.parametrize("window,soft_cap", [(None, None), (8, None), (None, 30.0)])
def test_dense_attention_ring_cache_matches_jax(pos, window, soft_cap):
    """Decode against a 12-slot ring cache (wrapped once pos >= 12), GQA
    (4 query heads over 2 KV heads), grouped as the decode path runs it."""
    B, T, Hq, G, hd = 2, 12, 4, 2, 16
    q, k, v = _rand((B, 1, Hq, hd), pos), _rand((B, T, G, hd), pos + 1), _rand((B, T, G, hd), pos + 2)
    jkv, jvalid = jlm.ring_positions(jnp.asarray(pos), T)
    tkv, tvalid = tlm.ring_positions(pos, T)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jpos = jnp.full((B, 1), pos, jnp.int32)
    want = jattn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, q_pos=jpos, kv_pos=jkv,
        window=window, kv_valid=jvalid, soft_cap=soft_cap, grouped=True,
    )
    got = tattn.dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        q_pos=torch.full((B, 1), pos, dtype=torch.int32), kv_pos=tkv, window=window,
        kv_valid=tvalid, soft_cap=soft_cap, grouped=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_full_sequence_matches_jax(grouped, causal):
    B, S, Hq, G, hd = 2, 24, 6, 3, 8
    q, k, v = _rand((B, S, Hq, hd), 1), _rand((B, S, G, hd), 2), _rand((B, S, G, hd), 3)
    pos = np.arange(S)[None, :]
    want = jattn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos), scale=0.3, grouped=grouped,
    )
    got = tattn.dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos), scale=0.3, grouped=grouped,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _route(**kw):
    """(which path ran, output) for one `attention` call on small tensors."""
    q = torch.from_numpy(_rand((1, 10, kw.pop("hq", 2), 8), 4))
    k = torch.from_numpy(_rand((1, 10, 2, 8), 5))
    v = torch.from_numpy(_rand((1, 10, 2, 8), 6))
    counters.reset()
    out = tattn.attention(q, k, v, **kw)
    return ("flash" if counters.PLAIN_CALLS["flash_attention"] else "dense"), out, (q, k, v)


@pytest.mark.parametrize(
    "kw,path",
    [
        ({}, "flash"),
        ({"causal": False}, "flash"),
        ({"mode": "ref"}, "flash"),
        ({"hq": 4, "window": 4}, "dense"),  # GQA, T = 10 over the window
        ({"window": 4}, "dense"),
        ({"soft_cap": 20.0}, "dense"),
        ({"scale": 0.5}, "dense"),
        ({"kv_valid": torch.ones(10, dtype=torch.bool)}, "dense"),
        ({"q_pos": torch.arange(10), "kv_pos": torch.arange(10)}, "dense"),
        ({"hq": 4}, "flash"),  # GQA: two query heads a KV head
        ({"hq": 6, "causal": False}, "flash"),
        ({"window": 10}, "flash"),  # S = T = 10 within the window
        ({"hq": 4, "window": 16}, "flash"),
    ],
)
def test_attention_routing(kw, path):
    got, out, (q, k, v) = _route(**kw)
    assert got == path
    assert tattn.kernel_route(q, k, v, **{n: kw[n] for n in kw if n not in ("causal", "mode", "hq")}) == (
        path == "flash"
    )
    if path == "flash" or set(kw) <= {"q_pos", "kv_pos", "kv_valid"}:
        # the same function either way: dense_attention (with the window) agrees
        causal = kw.get("causal", True)
        want = tattn.dense_attention(q, k, v, causal=causal, window=kw.get("window"))
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_attention_above_8192_positions_needs_blockwise():
    """Off the kernel route, more than 8192 KV positions without `kv_valid`
    go to `blockwise_attention`, as JAX's `attention` does, and match it."""
    q, k, v = _rand((1, 3, 4, 8), 11), _rand((1, 8193, 2, 8), 12), _rand((1, 8193, 2, 8), 13)
    qp = np.array([8190, 8191, 8192])
    want = jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(qp),
        kv_pos=jnp.arange(8193), window=4096,
    )
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    counters.reset()
    got = tattn.attention(
        tq, tk, tv, q_pos=torch.from_numpy(qp), kv_pos=torch.arange(8193), window=4096
    )
    assert counters.PLAIN_CALLS["flash_attention"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    blockwise = tattn.blockwise_attention(
        tq, tk, tv, q_pos=torch.from_numpy(qp), kv_pos=torch.arange(8193), window=4096
    )
    assert torch.equal(got, blockwise)
    # a ring cache (kv_valid) stays dense at any length, as in JAX
    q, k = torch.zeros((1, 1, 2, 8)), torch.zeros((1, 8193, 2, 8))
    out = tattn.attention(
        q, k, k, q_pos=torch.tensor([8192]), kv_pos=torch.arange(8193),
        kv_valid=torch.ones(8193, dtype=torch.bool),
    )
    assert out.shape == q.shape
    # and the kernel route takes any length
    x = torch.zeros((1, 8193, 1, 8))
    counters.reset()
    assert tattn.attention(x, x, x).shape == x.shape
    assert counters.PLAIN_CALLS["flash_attention"] == 1


# (B, S, T, H, Hkv, hd): llama-3.2-vision-11b's cross-attention, 32 query
# heads over 8 KV heads of 128 against its 1600 image tokens (25 full key
# tiles), non-causal: a decode step's single query row (127 of the 128-row
# query tile past S) and one request of the prefill's 1024 rows
CROSS_SHAPES = [(1, 1, 1600, 32, 8, 128), (1, 1024, 1600, 32, 8, 128)]


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_replay_at_the_cross_attention_shapes(shape):
    """The 16-bit kernel's tile walk at ``causal=False`` on the
    cross-attention shapes, bf16: within `AGREE` of JAX's `attention_ref`
    (over the repeated KV) and of the plain version, and within
    `OFF_PLAIN_SHARE` of the plain version, which the same walk with p_hi
    alone exceeds."""
    (jq, jk, jv), (tq, tk, tv) = _gqa_qkv(shape, "bfloat16", sum(shape))
    got, dist = _replay_wgmma(tq, tk, tv, False)
    assert dist <= 2.0**-16
    rtol, atol = kattn.AGREE[tq.dtype]
    want = jref.attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)
    plain = kattn.flash_attention_plain(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=rtol, atol=atol)
    single, _ = _replay_wgmma(tq, tk, tv, False, split=False)
    off_split = float((got != plain).float().mean())
    off_single = float((single != plain).float().mean())
    print(f"outputs off the plain version's: split {off_split:.5f}, p_hi alone {off_single:.5f}")
    assert off_split <= kattn.OFF_PLAIN_SHARE < off_single
