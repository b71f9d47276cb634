"""The encoder-decoder (seamless-m4t-large-v2): the bidirectional ``enc``
block, the ``dec`` block (causal self-attention, cross-attention over the
encoder's output, MLP), `lm._run_encoder` and the arch end to end, against
the JAX package on the CPU.

As in test_torch_xattn.py (whose arch-level checks run here for this arch):
inputs and the context (``audio_frames``) come from numpy seeds, the JAX
package draws the parameters (the LayerNorm scales and biases JAX
initialises to constants perturbed) and `convert.from_jax_lm_params` or
`load_block` carries them across.  The ``dec`` block has no gate, so its
context moves the logits at JAX's init too; the check that it does runs
all the same.  On the CPU the encoder's self-attention and every
cross-attention call run `flash_attention`'s plain version at
``causal=False``.

Tolerances, with their reasons: as in test_torch_xattn.py (the modules in
f32 rtol = atol = 1e-5; the reduced arch's f32 logits within 2e-3 of JAX's
and its `generate` tokens identical; bf16 within 3e-2 but at counted
near-ties).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import reduced_config as jax_reduced_config
from repro.models import blocks as jblocks
from repro.models import lm as jlm

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.serve import cv_engine as tengine

from test_torch_ssm import perturbed
from test_torch_xattn import (
    B,
    S,
    TOL,
    _layer,
    _pair,
    check_bf16_logits_match_jax_but_at_counted_near_ties,
    check_generate_tokens_identical_to_jax_f32,
    check_init_cache_matches_jax,
    check_missing_context_raises_before_any_compute,
    check_prefill_and_decode_match_jax_f32,
    check_serve_cli,
    check_the_context_moves_the_logits,
    context,
    load_block,
    models,
    tokens,
)

ARCH = "seamless-m4t-large-v2"


def _cfgs():
    return (reduced_config(ARCH).replace(dtype="float32"),
            jax_reduced_config(ARCH).replace(dtype="float32"))


def test_enc_block_matches_jax_and_is_bidirectional():
    """``enc`` is ``attn`` at ``causal=False``: its first position reads the
    last one."""
    cfg, cfg_j = _cfgs()
    jp = _layer(cfg_j, "enc", 1)
    p = load_block("enc", jp, cfg)
    jh, th = _pair((2, 11, 64), "float32", 2)
    wh, wc, _ = jblocks.apply_block("enc", jp, jh, cfg_j, positions=jnp.arange(11)[None, :])
    gh, gc, m = tblocks.apply_block("enc", p, th, cfg)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    assert set(gc) == set(wc) == {"k", "v"} and m == {}
    th2 = th.clone()
    th2[:, -1] = torch.flip(th2[:, -1], dims=[-1])  # the last position only
    moved = tblocks.apply_block("enc", p, th2, cfg)[0]
    assert float((moved[:, 0] - gh[:, 0]).abs().max()) > 1e-3
    causal = tblocks.apply_block("attn", p, th2, cfg)[0]
    assert torch.equal(causal[:, 0], tblocks.apply_block("attn", p, th, cfg)[0][:, 0])
    with pytest.raises(ValueError, match="no decode"):
        tblocks.apply_block_decode("enc", p, th[:, :1], cfg, cache=gc, pos=11, kv_pos=None,
                                   kv_valid=None)


def test_dec_block_apply_and_decode_match_jax():
    """Prefill over 9 positions against a context of 13 rows, then one
    decode step: JAX's hidden states and cache entries, ``k`` / ``v`` of the
    self-attention and ``xk`` / ``xv`` of the context."""
    cfg, cfg_j = _cfgs()
    jp = _layer(cfg_j, "dec", 3)
    p = load_block("dec", jp, cfg)
    jh, th = _pair((2, 9, 64), "float32", 4)
    jc, tc = _pair((2, 13, 64), "float32", 5)
    wh, wc, _ = jblocks.apply_block("dec", jp, jh, cfg_j, positions=jnp.arange(9)[None, :], ctx=jc)
    gh, gc, _ = tblocks.apply_block("dec", p, th, cfg, ctx=tc)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    assert set(gc) == set(wc) == {"k", "v", "xk", "xv"}
    for name in gc:
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]), **TOL)
    # decode position 9 against a 12-slot buffer holding the prefill's 9
    jcache = jblocks.init_block_cache("dec", cfg_j, 2, 12, jnp.float32, ctx_len=13)
    jcache = {n: t.at[:, : wc[n].shape[1]].set(wc[n]) for n, t in jcache.items()}
    tcache = {n: torch.from_numpy(np.array(t)) for n, t in jcache.items()}
    kv_pos, kv_valid = jlm.ring_positions(jnp.asarray(9), 12)
    jh1, th1 = _pair((2, 1, 64), "float32", 6)
    wd, wdc = jblocks.apply_block_decode("dec", jp, jh1, cfg_j, cache=jcache, pos=9,
                                         kv_pos=kv_pos, kv_valid=kv_valid)
    tp, tv = tlm.ring_positions(9, 12)
    gd, gdc = tblocks.apply_block_decode("dec", p, th1, cfg, cache=tcache, pos=9, kv_pos=tp,
                                         kv_valid=tv)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    for name in gdc:
        assert gdc[name] is tcache[name]
        np.testing.assert_allclose(gdc[name].numpy(), np.asarray(wdc[name]), **TOL)


def test_run_encoder_matches_jax():
    params, cfg_j, model, cfg = models(ARCH, seed=7)
    jx, tx = context(cfg, 8)
    want = jlm._run_encoder(params, cfg_j, jx["audio_frames"], hint=jlm.NO_HINT)
    got = tlm._run_encoder(model, tx["audio_frames"])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (B, S, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_layout_and_conversion():
    """`LM.encoder` holds ``n_enc_layers`` ``enc`` blocks and its LayerNorm;
    `from_jax_lm_params` carries JAX's ``encoder.groups[0]`` (stacked) and
    ``encoder.final_norm`` into them, and refuses a tree without them."""
    params, _, model, cfg = models(ARCH, seed=9)
    assert len(model.encoder["blocks"]) == cfg.n_enc_layers == 2
    state = model.state_dict()
    enc = params["encoder"]
    for li in range(2):
        np.testing.assert_array_equal(state[f"encoder.blocks.{li}.attn.w_q"].numpy(),
                                      np.asarray(enc["groups"][0]["attn"]["w_q"][li]))
        np.testing.assert_array_equal(state[f"encoder.blocks.{li}.ln2.bias"].numpy(),
                                      np.asarray(enc["groups"][0]["ln2"]["bias"][li]))
    np.testing.assert_array_equal(state["encoder.final_norm.scale"].numpy(),
                                  np.asarray(enc["final_norm"]["scale"]))
    np.testing.assert_array_equal(state["blocks.1.xattn.w_k"].numpy(),
                                  np.asarray(params["groups"][0]["xattn"]["w_k"][1]))
    tree = jax.tree.map(np.asarray, params)
    del tree["encoder"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_lm_params(tree, cfg, device="cpu")
    full = tlm.LM(get_config(ARCH), device="meta")
    n = sum(p.numel() for p in full.parameters())
    assert len(full.encoder["blocks"]) == 24 and 1.5e9 < n < 1.7e9


# ---------------------------------------------------------------------------
# reduced seamless-m4t-large-v2 end to end
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax_forward_f32():
    check_prefill_and_decode_match_jax_f32(ARCH)


def test_generate_tokens_identical_to_jax_f32():
    check_generate_tokens_identical_to_jax_f32(ARCH)


def test_bf16_logits_match_jax_but_at_counted_near_ties():
    check_bf16_logits_match_jax_but_at_counted_near_ties(ARCH)


def test_the_audio_frames_move_the_logits():
    check_the_context_moves_the_logits(ARCH)


@pytest.mark.parametrize("cache_len,ctx_len", [(12, None), (30, 16), (8, 40)])
def test_init_cache_matches_jax(cache_len, ctx_len):
    check_init_cache_matches_jax(ARCH, cache_len, ctx_len)


def test_prompt_fit_reads_the_self_attention_slots_by_name():
    """A ``dec`` entry's ``k`` holds the prompt's slots, ``xk`` the
    context's: a context of 4 rows does not refuse a prompt of 10 in 12
    slots, a context of 40 does not admit one in 8."""
    cfg = reduced_config(ARCH)
    tengine.check_prompt_fits(tlm.init_cache(cfg, 1, 12, ctx_len=4, device="cpu"), 10, cfg)
    cache = tlm.init_cache(cfg, 1, 8, ctx_len=40, device="cpu")
    cache["groups"][0] = {n: cache["groups"][0][n] for n in ("xk", "xv", "k", "v")}
    with pytest.raises(ValueError, match="does not fit a decode cache of 8 slots"):
        tengine.check_prompt_fits(cache, 10, cfg)


def test_adopt_prefill_copies_the_context_whole():
    _, _, model, cfg = models(ARCH, seed=10)
    toks = torch.from_numpy(tokens(cfg, 11, 6))
    _, tx = context(cfg, 12, seq=6)
    _, pc = tlm.prefill(model, toks, extras=tx)
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, 10, ctx_len=6, device="cpu"), pc, cfg)
    g, pg = cache["groups"][0], pc["groups"][0]
    assert torch.equal(g["xk"], pg["xk"]) and torch.equal(g["xv"], pg["xv"])
    assert torch.equal(g["k"][:, :, :6], pg["k"]) and not g["k"][:, :, 6:].any()
    with pytest.raises(ValueError, match=r"dec xk: prefill \(2, 3, 6, 4, 16\)"):
        tengine._adopt_prefill(tlm.init_cache(cfg, B, 10, ctx_len=7, device="cpu"), pc, cfg)


def test_missing_audio_frames_raise_before_any_compute(monkeypatch):
    check_missing_context_raises_before_any_compute(ARCH, monkeypatch)


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    check_serve_cli(ARCH, capsys, prompt_len=24)


def test_perturbed_layernorm_reaches_the_encoder():
    """The perturbation `models` applies reaches the encoder's LayerNorms
    (scale and bias), so a norm read in the wrong place shows."""
    params = perturbed(jlm.init_params(jax.random.key(0), jax_reduced_config(ARCH)), 1)
    ln = params["encoder"]["final_norm"]
    assert float(jnp.abs(ln["scale"] - 1).max()) > 0 and float(jnp.abs(ln["bias"]).max()) > 0
