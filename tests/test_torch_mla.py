"""Multi-head latent attention (DeepSeek-V3) and the padded-v kernel route
against the JAX package on the CPU.

On the CPU `flash_attention` runs its plain version.  JAX's `mla_attn`
runs `dense_attention` with an explicit ``scale = 1 / sqrt(qk_nope +
qk_rope)``; the port passes None (the default for q's head dim, the same
number) so that the call may take the kernel route, where v is padded with
zero channels to q's head dim and the output cut back to ``v_dim``.

Tolerances, with their reasons:
  * f32: `mla_attn`'s output and latents, `mla_decode`'s output and cache
    within rtol = atol = 1e-5 (the same f32 formulas summed in another
    order; the plain flash version's online softmax against JAX's dense
    softmax); the padded route against `dense_attention` within
    `kernels.attention.AGREE`;
  * bf16: the padded route within `AGREE` of `dense_attention` on the same
    inputs widened to f32 (the 16-bit dense path rounds p to v's dtype
    before p.v, the kernel and its plain version do not).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jattn
from repro.models import lm as jlm

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

from test_torch_moe import _np, _tree, _x

ARCH = "deepseek-v3-671b"
B, S = 3, 20


def _mla_params(seed=0):
    cfg_j = jax_reduced_config(ARCH).replace(dtype="float32")
    p = jattn.init_mla(jax.random.key(seed), cfg_j)
    # JAX initialises the norm scales to 1, which cannot show that they were read
    rng = np.random.default_rng(seed + 50)
    for name in ("q_norm", "kv_norm"):
        n = p[name]["scale"].shape[0]
        p[name]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(n).astype(np.float32))
    return cfg_j, p, reduced_config(ARCH).replace(dtype="float32")


def test_mla_scale_is_the_default_for_q_head_dim():
    """JAX's explicit scale is `dense_attention`'s default for q's head dim,
    at full width and reduced; so the port's call with None computes the
    same function, and equals the call with JAX's scale."""
    _, p, cfg = _mla_params(0)
    m = cfg.mla
    x = _x((1, 9, cfg.d_model), seed=9)[1]
    q, k, v, _, _ = tattn.mla_project_qkv(_tree(p), x, cfg, torch.arange(9)[None, :])
    assert q.shape[-1] == k.shape[-1] == m.qk_nope_dim + m.qk_rope_dim and v.shape[-1] == m.v_dim
    jax_scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    assert jax_scale == 1.0 / math.sqrt(q.shape[-1])
    full = get_config(ARCH).mla
    assert full.qk_nope_dim + full.qk_rope_dim == 192 and full.v_dim == 128
    explicit = tattn.attention(q, k, v, scale=jax_scale)  # dense: a scale is given
    assert torch.equal(explicit, tattn.dense_attention(q, k, v))


@pytest.mark.parametrize("positions", [None, "given"])
def test_mla_attn_matches_jax(positions):
    """Output and the latents (c_kv, k_rope) the cache keeps.  positions None
    takes the kernel route (the plain version on the CPU, v padded from 16
    to 24 channels); given positions, `dense_attention` unpadded, as JAX."""
    cfg_j, p, cfg = _mla_params(1)
    jx, tx = _x((B, S, cfg.d_model), seed=2)
    pos = jnp.arange(S)[None, :]
    oj, (cj, kj) = jattn.mla_attn(p, jx, cfg_j, positions=pos)
    counters.reset()
    ot, (ct, kt) = tattn.mla_attn(_tree(p), tx, cfg,
                                  positions=None if positions is None else torch.arange(S)[None, :])
    assert counters.PLAIN_CALLS["flash_attention"] == (1 if positions is None else 0)
    assert ot.shape == (B, S, cfg.d_model) and ct.shape == (B, S, 16) and kt.shape == (B, S, 8)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(kt), _np(kj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos,T", [(9, 12), (11, 12), (0, 4)])
def test_mla_decode_matches_jax(pos, T):
    """The absorbed-matrix decode over a cache whose slots below `pos` hold
    random latents: the output and both cache tensors after the write."""
    cfg_j, p, cfg = _mla_params(3)
    m = cfg.mla
    jx, tx = _x((B, 1, cfg.d_model), seed=4)
    (jc, tc), (jr, tr) = _x((B, T, m.kv_lora_rank), seed=5), _x((B, T, m.qk_rope_dim), seed=6)
    kv_pos, valid = tlm.ring_positions(pos, T)
    oj, (cj, rj) = jattn.mla_decode(p, jx, cfg_j, cache_ckv=jc, cache_kr=jr, pos=pos,
                                    kv_pos=jnp.asarray(kv_pos.numpy()),
                                    kv_valid=jnp.asarray(valid.numpy()))
    ot, (ct, rt) = tattn.mla_decode(_tree(p), tx, cfg, cache_ckv=tc, cache_kr=tr, pos=pos,
                                    kv_pos=kv_pos, kv_valid=valid)
    assert ct is tc and rt is tr  # written in place
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(rt), _np(rj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hdv", [(24, 16), (192, 128), (64, 8)])
def test_padded_v_route_equals_dense_attention(hd, hdv, dtype):
    """The kernel route's call (v padded with zeros to q's head dim, the
    output cut back), run through the plain version: within `AGREE` of
    `dense_attention` on the unpadded v, and the padded channels of the
    output exactly zero."""
    (_, q), (_, k), (_, v) = (_x((2, 70, 3, d), dtype, seed=hd + i)
                              for i, d in enumerate((hd, hd, hdv)))
    vp = F.pad(v, (0, hd - hdv))
    assert tattn.kernel_route(q, k, vp) and not tattn.kernel_route(q, k, v)
    full = kattn.flash_attention(q, k, vp)
    assert not full[..., hdv:].any()
    want = tattn.dense_attention(q.float(), k.float(), v.float())
    rtol, atol = kattn.AGREE[getattr(torch, dtype)]
    torch.testing.assert_close(full[..., :hdv].float(), want, rtol=rtol, atol=atol)


def test_kernel_route_refuses_a_v_unlike_k():
    """`attention` never reaches `flash_attention`'s shape check from a v
    whose shape differs from k's: it routes such a call to
    `dense_attention`, which takes v's own head dim."""
    (_, q), (_, k), (_, v) = (_x((1, 10, 2, d), seed=i) for i, d in enumerate((16, 16, 8)))
    with pytest.raises(ValueError, match="expected q"):
        kattn.flash_attention(q, k, v)
    assert not tattn.kernel_route(q, k, v)
    assert tattn.kernel_route(q, k, k)
    counters.reset()
    out = tattn.attention(q, k, v)
    assert counters.PLAIN_CALLS["flash_attention"] == 0 and out.shape == (1, 10, 2, 8)
    torch.testing.assert_close(out, tattn.dense_attention(q, k, v))
    # a v with k's head dim over other heads is refused too
    assert not tattn.kernel_route(q, k, torch.zeros((1, 10, 1, 16)))


def test_mla_cache_and_prefill_match_jax():
    """The reduced deepseek prefill's last logits and its MLA cache entries
    (L, B, S, r) against JAX's `lm.prefill`."""
    cfg_j = jax_reduced_config(ARCH).replace(dtype="float32")
    params = jlm.init_params(jax.random.key(7), cfg_j)
    cfg = reduced_config(ARCH).replace(dtype="float32")
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S))
    lj, cj = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(toks)})
    lt, ct = tlm.prefill(model, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=2e-3, atol=2e-3)
    for gt, gj in zip(ct["groups"], cj["groups"]):
        assert set(gt) == set(gj) == {"ckv", "kr"}
        for name in gt:
            assert tuple(gt[name].shape) == tuple(gj[name].shape)
            np.testing.assert_allclose(_np(gt[name]), _np(gj[name]), rtol=1e-4, atol=1e-4)
