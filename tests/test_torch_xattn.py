"""Cross-attention (`models.attention.cross_kv`, `cross_attn`), the gated
``xattn`` block and the arch it serves (llama-3.2-vision-11b) against the
JAX package on the CPU.

Inputs and the context (``image_embeds``) come from numpy seeds; the JAX
package draws the parameters and `convert.from_jax_lm_params` (or
`load_block`) carries them across.  JAX initialises every gate to 0, which
makes a gated layer the identity: with those gates no check here could see
cross-attention at all.  So every gate is set non-zero in the JAX tree
first (`gated`), and the norm scales JAX initialises to ones are perturbed
(`test_torch_ssm.perturbed`), so that a parameter read in the wrong place
shows.  Each arch file asserts that changing the context moves the logits.
The arch-level checks are written once for both cross-attention archs and
called from here for llama-3.2-vision-11b and from test_torch_encdec.py for
seamless-m4t-large-v2.  On the CPU every cross-attention call runs
`flash_attention`'s plain version at ``causal=False`` (the kernel route);
JAX runs `dense_attention` with every position 0, the same function.

Tolerances, with their reasons:
  * the modules and blocks in f32: rtol = atol = 1e-5 (the same f32
    formulas summed in another order);
  * the modules in bf16: rtol = atol = 3e-2 (the repo's bf16 attention
    tolerance, tests/test_kernels_attention.py:29): the kernel route keeps
    the probabilities in f32 where `dense_attention` rounds them to bf16;
  * the reduced archs in f32: prefill logits within 2e-3 of JAX
    `lm.prefill`, every decode step within 2e-3 of JAX `lm.forward`
    (tests/test_decode_consistency.py:28), `generate` tokens identical;
  * bf16: logits within atol 3e-2 + rtol 3e-2, tokens equal but at counted
    logit near-ties, as in tests/test_torch_lm.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import extra_inputs as jax_extra_inputs
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import cv_engine as jengine

from repro_torch.configs import extra_inputs, get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import counters
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.serve import cv_engine as tengine

from test_torch_moe import _np, _tree
from test_torch_ssm import perturbed

ARCH = "llama-3.2-vision-11b"
B, S, STEPS = 3, 20, 6
TOL = dict(rtol=1e-5, atol=1e-5)
GATES = ("gate_attn", "gate_mlp")


def gated(params, seed: int):
    """`params` with every gate (JAX: 0 at init) drawn from [0.3, 0.9)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if jax.tree_util.keystr(path[-1:])[2:-2] in GATES:
            return jnp.asarray(rng.uniform(0.3, 0.9, a.shape).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(k)[2:-2].replace("']['", "."): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def load_block(kind: str, jp: dict, cfg) -> torch.nn.Module:
    """The port's block of `kind` (`blocks.init_block`) holding JAX's layer
    parameters `jp` (one layer, unstacked): their names must be the port's."""
    blk = tblocks.init_block(kind, cfg, device="cpu")
    state, flat = blk.state_dict(), _paths(jp)
    assert set(state) == set(flat)
    with torch.no_grad():
        for name, a in flat.items():
            assert tuple(state[name].shape) == a.shape, name
            state[name].copy_(torch.from_numpy(_np(a).copy()))
    return blk


def context(cfg, seed: int, batch: int = B, seq: int = S, scale: float = 1.0):
    """The arch's context inputs (`extra_inputs`, the JAX package's and the
    port's alike) from a numpy seed, rounded to the model's dtype by JAX ->
    (JAX's dict, the same values in torch)."""
    rng = np.random.default_rng(seed)
    jx, tx = {}, {}
    for name, (shape, dt) in jax_extra_inputs(cfg, batch, seq).items():
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale, dt)
        jx[name] = a
        tx[name] = torch.from_numpy(_np(a).copy()).to(getattr(torch, dt))
    return jx, tx


def models(arch: str, dtype: str = "float32", seed: int = 0):
    """JAX's reduced model, gates non-zero and constant-initialised leaves
    perturbed, and the port's, carried over."""
    cfg_j = jax_reduced_config(arch).replace(dtype=dtype)
    params = gated(perturbed(jlm.init_params(jax.random.key(seed), cfg_j), seed + 100), seed + 200)
    cfg = reduced_config(arch).replace(dtype=dtype)
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, model, cfg


def tokens(cfg, seed, n=S, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def jax_forward(params, cfg_j, toks, jx) -> np.ndarray:
    fwd = jax.jit(lambda p, t, x: jlm.forward(p, cfg_j, {"tokens": t, **x})[0])
    return np.asarray(fwd(params, jnp.asarray(toks), jx))


def jax_prefill(params, cfg_j, toks, jx):
    return jax.jit(lambda p, t, x: jlm.prefill(p, cfg_j, {"tokens": t, **x}))(
        params, jnp.asarray(toks), jx)


def calls(cfg) -> tuple[int, int]:
    """`flash_attention` calls (plain on the CPU) of one prefill and of one
    decode step: every self-, encoder and cross application in the prefill,
    every cross application in decode."""
    n_cross = sum(c for k, c in cfg.blocks if k in tblocks.CONTEXT_ENTRIES)
    n_self = sum(c for k, c in cfg.blocks if k != "xattn")
    return n_self + n_cross + cfg.n_enc_layers, n_cross


def cache_names(kind: str) -> set:
    return {"attn": {"k", "v"}, "xattn": {"k", "v"}, "dec": {"k", "v", "xk", "xv"}}[kind]


def check_prefill_and_decode_match_jax_f32(arch):
    params, cfg_j, model, cfg = models(arch, seed=1)
    toks = tokens(cfg, 6, S + 4)
    # the context of the whole sequence (audio_frames has min(seq, 4096) rows)
    jx, tx = context(cfg, 7, seq=S)
    full = jax_forward(params, cfg_j, toks, jx)
    lj, jcache = jax_prefill(params, cfg_j, toks[:, :S], jx)
    n_pre, n_dec = calls(cfg)
    counters.reset()
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks[:, :S]), extras=tx)
    assert counters.PLAIN_CALLS["flash_attention"] == n_pre
    assert sum(counters.LAUNCHES.values()) == 0
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < 2e-3
    assert float(np.max(np.abs(lt.numpy() - full[:, S - 1]))) < 2e-3
    # the prefill cache: JAX's entries, shapes and values (stacked by layer)
    for (kind, _), g, jg in zip(cfg.blocks, pcache["groups"], jcache["groups"], strict=True):
        assert set(g) == cache_names(kind) == set(jg)
        for name, t in g.items():
            assert tuple(t.shape) == jg[name].shape, (kind, name)
            np.testing.assert_allclose(t.numpy(), np.asarray(jg[name]), rtol=1e-4, atol=1e-4)
    assert "ctx" not in pcache and "ctx" in jcache
    ctx_len = tlm.context_len(cfg, tx, B)
    assert ctx_len == jcache["ctx"].shape[1]
    cache = tengine._adopt_prefill(
        tlm.init_cache(cfg, B, S + 8, ctx_len=ctx_len, device="cpu"), pcache, cfg)
    for t in range(S, S + 4):
        counters.reset()
        lg, cache = tlm.decode_step(model, torch.from_numpy(toks[:, t : t + 1]), cache)
        assert counters.PLAIN_CALLS["flash_attention"] == n_dec
        assert cache["pos"] == t + 1
        err = float(np.max(np.abs(lg.numpy() - full[:, t])))
        assert err < 2e-3, (t, err)


def check_generate_tokens_identical_to_jax_f32(arch):
    params, cfg_j, model, cfg = models(arch, seed=2)
    toks = tokens(cfg, 3)
    jx, tx = context(cfg, 4)
    with make_host_mesh() as mesh:
        want = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS,
                                           mesh=mesh, extras=jx))
    counters.reset()
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, extras=tx, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    n_pre, n_dec = calls(cfg)
    assert counters.PLAIN_CALLS["flash_attention"] == n_pre + (STEPS - 1) * n_dec
    assert sum(counters.LAUNCHES.values()) == 0


def check_bf16_logits_match_jax_but_at_counted_near_ties(arch):
    """Teacher-forced on JAX's tokens: each step's logits within 3e-2, each
    token the port's argmax but at a counted logit near-tie."""
    params, cfg_j, model, cfg = models(arch, dtype="bfloat16", seed=4)
    toks = tokens(cfg, 5)
    jx, tx = context(cfg, 6)
    with make_host_mesh() as mesh:
        gen = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS,
                                          mesh=mesh, extras=jx))
    lg, pc = jax_prefill(params, cfg_j, toks, jx)
    ctx_len = pc["ctx"].shape[1]
    cache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S + STEPS, ctx_len=ctx_len), pc, cfg_j)
    step = jax.jit(lambda c, t: jlm.decode_step(params, cfg_j, t, c))
    lj = [_np(lg)]
    for t in range(STEPS - 1):
        lg, cache = step(cache, jnp.asarray(gen[:, t : t + 1], jnp.int32))
        lj.append(_np(lg))
    lt_, pc = tlm.prefill(model, torch.from_numpy(toks), extras=tx)
    cache = tengine._adopt_prefill(
        tlm.init_cache(cfg, B, S + STEPS, ctx_len=ctx_len, device="cpu"), pc, cfg)
    lt = [_np(lt_)]
    for t in range(STEPS - 1):
        lg, cache = tlm.decode_step(model, torch.tensor(gen[:, t : t + 1], dtype=torch.long), cache)
        lt.append(_np(lg))
    lj, lt = np.stack(lj, 1), np.stack(lt, 1)  # (B, STEPS, V)
    np.testing.assert_allclose(lt, lj, rtol=3e-2, atol=3e-2)
    diff = float(np.max(np.abs(lt - lj)))
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    off = np.argmax(lt, axis=-1) != gen
    assert np.all(margin[off] <= diff), (margin[off], diff)
    print(f"{arch} bf16: max logit diff {diff:.4g}, {int(off.sum())} near-tie tokens of {off.size}")


def check_the_context_moves_the_logits(arch) -> float:
    """Another context input (the same tokens) moves the prefill's and the
    decode's logits, in both packages alike -> the smallest move seen.  With
    the gates of JAX's init (0) a gated layer would not move them at all."""
    params, cfg_j, model, cfg = models(arch, seed=11)
    toks = torch.from_numpy(tokens(cfg, 12))
    moves = []
    outs = []
    for seed in (13, 14):
        jx, tx = context(cfg, seed)
        lt, pc = tlm.prefill(model, toks, extras=tx)
        cache = tengine._adopt_prefill(
            tlm.init_cache(cfg, B, S + 2, ctx_len=tlm.context_len(cfg, tx, B), device="cpu"),
            pc, cfg)
        ld, _ = tlm.decode_step(model, toks[:, :1], cache)
        lj, _ = jax_prefill(params, cfg_j, toks.numpy(), jx)
        outs.append((lt.numpy(), ld.numpy(), np.asarray(lj)))
    (a, da, ja), (b, db, jb) = outs
    moves = [float(np.abs(a - b).max()), float(np.abs(da - db).max())]
    print(f"{arch}: another context moves the prefill / decode logits by {moves}")
    assert min(moves) > 1e-2, moves
    np.testing.assert_allclose(a - b, ja - jb, rtol=0, atol=4e-3)
    return min(moves)


def check_init_cache_matches_jax(arch, cache_len, ctx_len):
    """`lm.init_cache`'s group entries, shapes, dtypes and values are JAX's
    (JAX's cache also holds the context itself, ``ctx``; the port's not)."""
    cfg, cfg_j = reduced_config(arch), jax_reduced_config(arch)
    got = tlm.init_cache(cfg, 2, cache_len, ctx_len=ctx_len, device="cpu")
    want = jlm.init_cache(cfg_j, 2, cache_len, ctx_len=ctx_len)
    assert set(got) == {"groups", "shared", "pos"} and got["shared"] == []
    for (kind, _), g, w in zip(cfg.blocks, got["groups"], want["groups"], strict=True):
        assert set(g) == set(w) == cache_names(kind)
        for name, t in g.items():
            assert tuple(t.shape) == w[name].shape and str(t.dtype)[6:] == str(w[name].dtype)
            assert not t.any()


def check_serve_cli(arch, capsys, prompt_len):
    """`launch/serve.py` makes the context input and serves the arch."""
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                 "--prompt-len", str(prompt_len), "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out and "output shape (2, 4)" in out
    cfg = reduced_config(arch)
    for name, (shape, dt) in extra_inputs(cfg, 2, prompt_len).items():
        assert f"context input {name} {shape} torch.{dt}" in out


def check_missing_context_raises_before_any_compute(arch, monkeypatch):
    cfg = reduced_config(arch).replace(dtype="float32")
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def no_prefill(*a, **k):
        raise AssertionError("the prefill ran")

    monkeypatch.setattr(tlm, "prefill", no_prefill)
    toks = torch.zeros((2, 5), dtype=torch.long)
    name = tlm.context_input(cfg)
    with pytest.raises(ValueError, match=f"needs the context input '{name}'"):
        tengine.generate(model, toks, steps=2, device="cpu")
    with pytest.raises(ValueError, match=r"of shape \(2, T, 64\)"):
        tengine.generate(model, toks, steps=2, device="cpu",
                         extras={name: torch.zeros((3, 4, cfg.d_model))})


# ---------------------------------------------------------------------------
# cross_kv, cross_attn and the xattn block
# ---------------------------------------------------------------------------


def _layer(cfg_j, kind, seed):
    """One JAX layer of `kind`, gates non-zero, constant leaves perturbed."""
    return gated(perturbed(jblocks.init_block(jax.random.key(seed), kind, cfg_j), seed + 1), seed + 2)


def _pair(shape, dtype, seed, scale=1.0):
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale,
                    dtype)
    return a, torch.from_numpy(_np(a).copy()).to(getattr(torch, dtype))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_kv_matches_jax(qkv_bias):
    cfg = reduced_config(ARCH).replace(qkv_bias=qkv_bias, dtype="float32")
    cfg_j = jax_reduced_config(ARCH).replace(qkv_bias=qkv_bias, dtype="float32")
    jp = _layer(cfg_j, "xattn", 1)["attn"]
    jc, tc = _pair((2, 16, 64), "float32", 2)
    want = jattn.cross_kv(jp, jc, cfg_j)
    got = tattn.cross_kv(_tree(jp), tc, cfg)
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape == (2, 16, 2, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", [True, False])
def test_cross_attn_matches_jax(gate, dtype):
    """Gated (``tanh(gate_attn)`` times the output) and not, over a context
    of another length than the queries', GQA (4 query heads over 2): one
    `flash_attention` call at ``causal=False``."""
    cfg = reduced_config(ARCH).replace(dtype=dtype)
    cfg_j = jax_reduced_config(ARCH).replace(dtype=dtype)
    jp = _layer(cfg_j, "xattn", 3)["attn"]
    if not gate:
        del jp["gate_attn"]
    jx, tx = _pair((2, 9, 64), dtype, 4)
    jc, tc = _pair((2, 16, 64), dtype, 5)
    want = jattn.cross_attn(jp, jx, jattn.cross_kv(jp, jc, cfg_j), cfg_j)
    p = _tree(jp)
    counters.reset()
    got = tattn.cross_attn(p, tx, tattn.cross_kv(p, tc, cfg), cfg)
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    if gate:  # the gate scales the whole output
        ungated = jattn.cross_attn({k: v for k, v in jp.items() if k != "gate_attn"}, jx,
                                   jattn.cross_kv(jp, jc, cfg_j), cfg_j)
        assert float(jnp.abs(ungated.astype(jnp.float32)).max()) > float(np.abs(_np(got)).max())


def test_xattn_block_apply_and_decode_match_jax():
    cfg, cfg_j = reduced_config(ARCH), jax_reduced_config(ARCH)
    cfg, cfg_j = cfg.replace(dtype="float32"), cfg_j.replace(dtype="float32")
    jp = _layer(cfg_j, "xattn", 6)
    p = load_block("xattn", jp, cfg)
    jh, th = _pair((2, 7, 64), "float32", 7)
    jc, tc = _pair((2, 16, 64), "float32", 8)
    pos = jnp.arange(7)[None, :]
    wh, wc, _ = jblocks.apply_block("xattn", jp, jh, cfg_j, positions=pos, ctx=jc)
    gh, gc, m = tblocks.apply_block("xattn", p, th, cfg, ctx=tc)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    assert set(gc) == set(wc) == {"k", "v"} and m == {}
    for name in gc:
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]), **TOL)
    # decode: one token over the same context, the entry returned as it was
    jh1, th1 = _pair((2, 1, 64), "float32", 9)
    wd, wdc = jblocks.apply_block_decode("xattn", jp, jh1, cfg_j, cache=wc, pos=7, kv_pos=None,
                                         kv_valid=None)
    counters.reset()
    gd, gdc = tblocks.apply_block_decode("xattn", p, th1, cfg, cache=gc, pos=7, kv_pos=None,
                                         kv_valid=None)
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert gdc is gc and all(gdc[n] is gc[n] for n in gc)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def test_xattn_layout_and_gates_at_full_width():
    """The full-width ``xattn`` block has JAX's parameter names, shapes and
    dtypes, the two gates scalar f32 zeros as JAX initialises them."""
    cfg = get_config(ARCH)
    blk = tblocks.init_block("xattn", cfg, device="meta")
    want = jax.eval_shape(lambda: jblocks.init_block(jax.random.key(0), "xattn",
                                                     jax_reduced_config(ARCH).replace(
                                                         d_model=4096, n_heads=32, n_kv_heads=8,
                                                         head_dim=128, d_ff=14336)))
    flat = _paths(want)
    got = dict(blk.named_parameters())
    assert set(got) == set(flat)
    for name, w in flat.items():
        assert tuple(got[name].shape) == w.shape and str(got[name].dtype)[6:] == str(w.dtype), name
    small = tblocks.init_block("xattn", reduced_config(ARCH), device="cpu")
    for name in ("attn.gate_attn", "gate_mlp"):
        t = dict(small.named_parameters())[name]
        assert t.shape == () and t.dtype == torch.float32 and float(t) == 0.0


# ---------------------------------------------------------------------------
# reduced llama-3.2-vision-11b end to end
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax_forward_f32():
    check_prefill_and_decode_match_jax_f32(ARCH)


def test_generate_tokens_identical_to_jax_f32():
    """A prompt of 20 tokens past the 16 image tokens: the cross-attention
    slots are the context's, not the prompt's (`check_prompt_fits`)."""
    assert S > reduced_config(ARCH).n_image_tokens
    check_generate_tokens_identical_to_jax_f32(ARCH)


def test_bf16_logits_match_jax_but_at_counted_near_ties():
    check_bf16_logits_match_jax_but_at_counted_near_ties(ARCH)


def test_the_image_embeds_move_the_logits():
    check_the_context_moves_the_logits(ARCH)
    # the same change with the gates JAX initialises (0): not a bit moves
    cfg_j = jax_reduced_config(ARCH).replace(dtype="float32")
    params = jlm.init_params(jax.random.key(11), cfg_j)
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), reduced_config(ARCH).replace(
        dtype="float32"), device="cpu")
    toks = torch.from_numpy(tokens(model.cfg, 12))
    a, b = (tlm.prefill(model, toks, extras=context(model.cfg, s)[1])[0] for s in (13, 14))
    assert torch.equal(a, b)


@pytest.mark.parametrize("cache_len,ctx_len", [(12, None), (30, 16), (30, 40)])
def test_init_cache_matches_jax(cache_len, ctx_len):
    check_init_cache_matches_jax(ARCH, cache_len, ctx_len)


def test_from_jax_lm_params_carries_the_gates():
    params, _, model, cfg = models(ARCH, seed=5)
    state = model.state_dict()
    assert [k for k, _ in cfg.blocks] == ["attn", "xattn", "attn", "xattn"]
    for gi, li in ((1, 1), (3, 3)):
        g = params["groups"][gi]
        assert float(state[f"blocks.{li}.attn.gate_attn"]) == float(g["attn"]["gate_attn"][0]) != 0
        assert float(state[f"blocks.{li}.gate_mlp"]) == float(g["gate_mlp"][0]) != 0
    tree = jax.tree.map(np.asarray, params)
    del tree["groups"][1]["gate_mlp"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_lm_params(tree, cfg, device="cpu")


def test_prompt_fit_skips_the_context_slots():
    """The ``xattn`` entries hold the context's 16 rows: a prompt of 20 fits
    a cache of 26 slots, and one of 27 does not (the self-attention's)."""
    cfg = reduced_config(ARCH)
    cache = tlm.init_cache(cfg, 1, 26, ctx_len=16, device="cpu")
    tengine.check_prompt_fits(cache, 20, cfg)
    with pytest.raises(ValueError, match="does not fit a decode cache of 26 slots"):
        tengine.check_prompt_fits(cache, 27, cfg)
    assert tlm._group_cache_len("xattn", cache["groups"][1]) is None


def test_missing_image_embeds_raise_before_any_compute(monkeypatch):
    check_missing_context_raises_before_any_compute(ARCH, monkeypatch)


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    check_serve_cli(ARCH, capsys, prompt_len=24)
