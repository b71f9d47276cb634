"""The Mamba2 (SSD) mixer and the arch it serves (zamba2-2.7b, with Zamba's
shared attention block) against the JAX package on the CPU.

Inputs come from numpy seeds; the JAX package draws the parameters and
`convert.from_jax_lm_params` (or `_tree`) carries them across, the norm
scales, conv biases and skip weights JAX initialises to constants given
random values first (`perturbed`), so that a parameter read in the wrong
place shows.  The arch-level checks are written once for both recurrent
archs and called from here for zamba2-2.7b and from test_torch_xlstm.py for
xlstm-125m.

Tolerances, with their reasons:
  * the modules in f32: rtol = atol = 1e-5 (the same f32 formulas summed in
    another order: the chunk carry as a Python loop where JAX scans, the
    three-operand einsums contracted pairwise);
  * the reduced archs in f32: prefill logits within 2e-3 of JAX
    `lm.prefill`, every decode step within 2e-3 of JAX `lm.forward`
    (tests/test_decode_consistency.py:28), `generate` tokens identical;
  * bf16: logits within atol 3e-2 + rtol 3e-2 (the repo's bf16 attention
    tolerance, tests/test_kernels_attention.py:29), tokens equal but at
    counted logit near-ties, as in tests/test_torch_lm.py: JAX sums the
    conv taps in bf16 inside a fused XLA loop, which may keep more
    precision than the port's one rounding a step;
  * prompts shorter than the conv's K - 1 = 3 taps: within 2e-3 of JAX
    `lm.forward`, the port's stated departure from JAX's decode (which
    keeps a zeroed conv state there and lies far off).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import cv_engine as jengine

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import counters
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import cv_engine as tengine

from test_torch_moe import _np, _tree

ARCH = "zamba2-2.7b"
B, S, STEPS = 3, 20, 6
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _pair(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.copy())


# the leaves JAX initialises to constants (0, 1, a linspace): given random values
_CONSTANT_INIT = ("scale", "conv_b", "D", "b_i", "b_f", "b_gates", "bias")


def perturbed(params, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])[2:-2]
        if name in _CONSTANT_INIT:
            return a + jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1, a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


# ---------------------------------------------------------------------------
# ssd_scan, the conv, the mixer and its decode
# ---------------------------------------------------------------------------


def _ssd_inputs(S, G, seed, H=4, P=8, N=6):
    x = _normal((2, S, H, P), seed)
    dt = np.log1p(np.exp(_normal((2, S, H), seed + 1)))  # softplus: positive
    A = -np.exp(_normal((H,), seed + 2, 0.5))
    Bm, Cm = _normal((2, S, G, N), seed + 3), _normal((2, S, G, N), seed + 4)
    s0 = _normal((2, H, N, P), seed + 5)
    return [_pair(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm, s0)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_scan_matches_jax(chunk, groups, with_state):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (js0, ts0) = _ssd_inputs(17, groups, chunk)
    jy, jfin = jssm.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                             init_state=js0 if with_state else None)
    ty, tfin = tssm.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk,
                             init_state=ts0 if with_state else None)
    assert ty.shape == (2, 17, 4, 8) and tfin.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tfin.numpy(), np.asarray(jfin), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(_normal((2, 11, 24), 0), jdt)
    jw = jnp.asarray(_normal((4, 24), 1, 0.5), jdt)
    jb = jnp.asarray(_normal((24,), 2))
    want = jssm._causal_conv(jx, jw, jb)
    got = tssm._causal_conv(*(torch.from_numpy(_np(a)).to(getattr(torch, dtype))
                              for a in (jx, jw)), torch.from_numpy(_np(jb)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    # bf16: the port rounds each of the K products and K - 1 partial sums, the
    # bias add and silu to bf16 (2K + 1 roundings of at most 2^-8 of the sum
    # of |terms|); XLA fuses the chain and may round once.  Both against the
    # f32 conv of the same bf16 inputs, within those roundings (silu' < 1.1)
    x, w, b = (_np(a) for a in (jx, jw, jb))
    pad = np.pad(x, ((0, 0), (3, 0), (0, 0)))
    terms = np.stack([pad[:, i : i + 11] * w[i] for i in range(4)])
    pre = terms.sum(0) + b
    exact = pre / (1 + np.exp(-pre))
    bound = 1.1 * (2 * 4 + 1) * 2.0**-8 * (np.abs(terms).sum(0) + np.abs(b)) + 2.0**-8 * np.abs(exact)
    for out in (_np(got), _np(want)):
        assert np.all(np.abs(out - exact) <= bound)


def _mixer(seed=0):
    cfg_j = jax_reduced_config(ARCH).replace(dtype="float32")
    p = perturbed(jssm.init_mamba2(jax.random.key(seed), cfg_j), seed + 1)
    return cfg_j, p, _tree(p), reduced_config(ARCH).replace(dtype="float32")


@pytest.mark.parametrize("S_", [17, 40, 3])
def test_mamba2_mixer_matches_jax(S_):
    cfg_j, jp, tp, cfg = _mixer()
    jx, tx = _pair(_normal((2, S_, cfg.d_model), S_))
    jy, jst = jax.jit(lambda p, x: jssm.mamba2_mixer(p, x, cfg_j))(jp, jx)
    ty, tst = tssm.mamba2_mixer(tp, tx, cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tst) == {"ssm", "conv"}
    for name in tst:
        assert tst[name].dtype == torch.float32
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), **TOL)


@pytest.mark.parametrize("S_", [1, 2])
def test_mamba2_conv_tail_is_left_padded_below_the_taps(S_):
    """The port's departure: K - 1 = 3 rows whatever S, the rows before the
    prompt zero; JAX's slice has fewer rows here."""
    cfg_j, jp, tp, cfg = _mixer()
    jx, tx = _pair(_normal((2, S_, cfg.d_model), S_))
    _, jst = jax.jit(lambda p, x: jssm.mamba2_mixer(p, x, cfg_j))(jp, jx)
    _, tst = tssm.mamba2_mixer(tp, tx, cfg)
    K = cfg.ssm.d_conv
    assert tst["conv"].shape == (2, K - 1, tssm.init_mamba2_state(cfg, 2)["conv"].shape[2])
    assert jst["conv"].shape[1] < K - 1
    assert not tst["conv"][:, : K - 1 - S_].any()
    xbc = torch.cat(tssm._split_in_proj(tp, tx, cfg.ssm)[1:4], dim=-1)
    np.testing.assert_array_equal(tst["conv"][:, K - 1 - S_ :].numpy(), xbc.numpy())
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]), **TOL)


def test_mamba2_decode_matches_jax():
    cfg_j, jp, tp, cfg = _mixer(seed=3)
    jx, tx = _pair(_normal((2, 1, cfg.d_model), 4))
    zero = tssm.init_mamba2_state(cfg, 2)
    state = {n: _normal(t.shape, 5 + i) for i, (n, t) in enumerate(zero.items())}
    jy, jnew = jssm.mamba2_decode(jp, jx, cfg_j, state={n: jnp.asarray(a) for n, a in state.items()})
    ty, tnew = tssm.mamba2_decode(tp, tx, cfg, state={n: torch.from_numpy(a) for n, a in state.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]), **TOL)


def test_mamba2_decode_continues_the_mixer():
    """Decoding 5 tokens from the mixer's state gives the mixer's outputs
    over the whole sequence at those positions (chunk 16, 21 positions: the
    carry crosses a chunk boundary)."""
    _, _, tp, cfg = _mixer(seed=6)
    x = torch.from_numpy(_normal((2, 21, cfg.d_model), 7))
    full, _ = tssm.mamba2_mixer(tp, x, cfg)
    _, state = tssm.mamba2_mixer(tp, x[:, :16], cfg)
    for t in range(16, 21):
        y, state = tssm.mamba2_decode(tp, x[:, t : t + 1], cfg, state=state)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(), **TOL)


def test_init_mamba2_layout():
    cfg = get_config(ARCH).replace(n_layers=1, blocks=(("mamba", 1),))
    p = tssm.init_mamba2(cfg, device="meta")
    want = jax.eval_shape(lambda: jssm.init_mamba2(jax.random.key(0), jax_get_config(ARCH)))
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got = {n: t for n, t in p.named_parameters()}
    assert {jax.tree_util.keystr(k)[2:-2].replace("']['", ".") for k in flat} == set(got)
    for k, w in flat.items():
        t = got[jax.tree_util.keystr(k)[2:-2].replace("']['", ".")]
        assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), k
    # dt_bias: the inverse softplus of a draw in [1e-3, 0.1]; A_log = log(1..H)
    small = cfg.replace(d_model=64, ssm=dataclasses.replace(cfg.ssm, d_inner=5120 // 4, d_state=8))
    p = tssm.init_mamba2(small, device="cpu", generator=torch.Generator().manual_seed(0))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert p["dt_bias"].shape == (20,)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert torch.allclose(p["A_log"], torch.log(torch.arange(1.0, 21.0)))


# ---------------------------------------------------------------------------
# the reduced archs end to end (shared with test_torch_xlstm.py)
# ---------------------------------------------------------------------------


def models(arch: str, dtype: str = "float32", seed: int = 0):
    """JAX's reduced model (constant-initialised leaves perturbed) and the
    port's, carried over."""
    cfg_j = jax_reduced_config(arch).replace(dtype=dtype)
    params = perturbed(jlm.init_params(jax.random.key(seed), cfg_j), seed + 100)
    cfg = reduced_config(arch).replace(dtype=dtype)
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, model, cfg


def jax_forward(params, cfg_j, toks) -> np.ndarray:
    """JAX `lm.forward`'s logits, jitted (eager dispatch of the layer scan
    is slow on the CPU)."""
    fwd = jax.jit(lambda p, t: jlm.forward(p, cfg_j, {"tokens": t})[0])
    return np.asarray(fwd(params, jnp.asarray(toks)))


def jax_prefill(params, cfg_j, toks):
    return jax.jit(lambda p, t: jlm.prefill(p, cfg_j, {"tokens": t}))(params, jnp.asarray(toks))


def tokens(cfg, seed, n=S, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def attention_calls(cfg) -> int:
    """Plain flash calls of one prefill: one a shared-block application."""
    return len(cfg.blocks) if cfg.shared_attn_every else 0


def state_names(kind: str) -> set:
    return {"mamba": {"ssm", "conv"}, "mlstm": {"C", "n", "m", "conv"},
            "slstm": {"c", "n", "h", "m"}}[kind]


def check_prefill_and_decode_match_jax_f32(arch, S_=S):
    params, cfg_j, model, cfg = models(arch, seed=1)
    toks = tokens(cfg, 6, S_ + 4)
    full = jax_forward(params, cfg_j, toks)
    lj, jcache = jax_prefill(params, cfg_j, toks[:, :S_])
    counters.reset()
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks[:, :S_]))
    assert counters.PLAIN_CALLS["flash_attention"] == attention_calls(cfg)
    assert sum(counters.LAUNCHES.values()) == 0
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < 2e-3
    assert float(np.max(np.abs(lt.numpy() - np.asarray(full[:, S_ - 1])))) < 2e-3
    # the prefill cache: JAX's entries, shapes and values (stacked by layer)
    for (kind, count), g, jg in zip(cfg.blocks, pcache["groups"], jcache["groups"]):
        assert set(g) == state_names(kind) == set(jg)
        for name, t in g.items():
            assert t.dtype == torch.float32 and tuple(t.shape) == jg[name].shape
            np.testing.assert_allclose(t.numpy(), np.asarray(jg[name]), rtol=1e-4, atol=1e-4)
    assert len(pcache["shared"]) == attention_calls(cfg) == len(jcache["shared"])
    for sc, jsc in zip(pcache["shared"], jcache["shared"]):
        assert tuple(sc["k"].shape) == jsc["k"].shape == (B, S_, cfg.n_kv_heads, cfg.head_dim)
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S_ + 8, device="cpu"), pcache, cfg)
    for t in range(S_, S_ + 4):
        lg, cache = tlm.decode_step(model, torch.from_numpy(toks[:, t : t + 1]), cache)
        assert cache["pos"] == t + 1
        err = float(np.max(np.abs(lg.numpy() - np.asarray(full[:, t]))))
        assert err < 2e-3, (t, err)


def check_generate_tokens_identical_to_jax_f32(arch):
    params, cfg_j, model, cfg = models(arch, seed=2)
    toks = tokens(cfg, 3)
    with make_host_mesh() as mesh:
        want = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    counters.reset()
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefill's shared applications; decode is dense
    assert counters.PLAIN_CALLS["flash_attention"] == attention_calls(cfg)
    assert sum(counters.LAUNCHES.values()) == 0


def check_bf16_logits_match_jax_but_at_counted_near_ties(arch):
    """Teacher-forced on JAX's tokens: each step's logits within 3e-2, each
    token the port's argmax but at a counted logit near-tie."""
    params, cfg_j, model, cfg = models(arch, dtype="bfloat16", seed=4)
    toks = tokens(cfg, 5)
    with make_host_mesh() as mesh:
        gen = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    lg, pc = jax_prefill(params, cfg_j, toks)
    cache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S + STEPS), pc, cfg_j)
    step = jax.jit(lambda c, t: jlm.decode_step(params, cfg_j, t, c))
    lj = [_np(lg)]
    for t in range(STEPS - 1):
        lg, cache = step(cache, jnp.asarray(gen[:, t : t + 1], jnp.int32))
        lj.append(_np(lg))
    lt_, pc = tlm.prefill(model, torch.from_numpy(toks))
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + STEPS, device="cpu"), pc, cfg)
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


def check_short_prompts_decode_like_jax_forward(arch, S_):
    """A prompt of 1 or 2 tokens, under the conv's K - 1 = 3: the port's
    generate and teacher-forced decode lie within 2e-3 of JAX `lm.forward`
    at every step; JAX's own decode, which keeps a zeroed conv state there,
    lies more than 100x further off."""
    params, cfg_j, model, cfg = models(arch, seed=9)
    toks = tokens(cfg, 10 + S_, S_)
    gen = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu").numpy()
    seq = np.concatenate([toks, gen], axis=1)
    full = jax_forward(params, cfg_j, seq)
    np.testing.assert_array_equal(gen, np.argmax(full[:, S_ - 1 : S_ - 1 + STEPS], axis=-1))
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks))
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S_ + STEPS, device="cpu"), pcache, cfg)
    errs = [float(np.abs(lt.numpy() - full[:, S_ - 1]).max())]
    for t in range(STEPS - 1):
        lg, cache = tlm.decode_step(model, torch.from_numpy(gen[:, t : t + 1]), cache)
        errs.append(float(np.abs(lg.numpy() - full[:, S_ + t]).max()))
    assert max(errs) < 2e-3, errs

    _, jcache = jax_prefill(params, cfg_j, toks)
    jcache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S_ + STEPS), jcache, cfg_j)
    jl, _ = jax.jit(lambda p, t, c: jlm.decode_step(p, cfg_j, t, c))(
        params, jnp.asarray(gen[:, :1], jnp.int32), jcache)
    ref_err = float(np.abs(np.asarray(jl) - full[:, S_]).max())
    print(f"{arch} prompt of {S_}: decode against lm.forward: port {max(errs):.3g}, "
          f"JAX's decode {ref_err:.3g}")
    assert ref_err > 100 * max(errs)


def check_cache_matches_jax(arch, cache_len):
    """`lm.init_cache`'s entries, shapes, dtypes and values are JAX's: the
    state kinds' in f32 whatever the model's dtype, with their nonzero
    starts (mLSTM ``m`` -1e30, sLSTM ``n`` 1e-6 and ``m`` -10)."""
    cfg, cfg_j = reduced_config(arch), jax_reduced_config(arch)
    got, want = tlm.init_cache(cfg, 2, cache_len, device="cpu"), jlm.init_cache(cfg_j, 2, cache_len)
    for g, w in zip(got["groups"] + got["shared"], want["groups"] + want["shared"], strict=True):
        assert set(g) == set(w)
        for name, t in g.items():
            assert tuple(t.shape) == w[name].shape and str(t.dtype)[6:] == str(w[name].dtype)
            np.testing.assert_array_equal(_np(t), _np(w[name]))


def check_serve_cli(arch, capsys, prompt_len):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                 "--prompt-len", str(prompt_len), "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out and "output shape (2, 4)" in out


def test_prefill_and_decode_match_jax_forward_f32():
    check_prefill_and_decode_match_jax_f32(ARCH)


def test_generate_tokens_identical_to_jax_f32():
    check_generate_tokens_identical_to_jax_f32(ARCH)


def test_bf16_logits_match_jax_but_at_counted_near_ties():
    check_bf16_logits_match_jax_but_at_counted_near_ties(ARCH)


@pytest.mark.parametrize("S_", [1, 2])
def test_short_prompts_decode_like_jax_forward(S_):
    check_short_prompts_decode_like_jax_forward(ARCH, S_)


@pytest.mark.parametrize("cache_len", [12, 5000])
def test_init_cache_matches_jax(cache_len):
    """The shared block's rings hold ``min(cache_len, 4096)`` slots."""
    check_cache_matches_jax(ARCH, cache_len)
    shared = tlm.init_cache(reduced_config(ARCH), 1, cache_len, device="cpu")["shared"]
    assert len(shared) == 2 and shared[0]["k"].shape[1] == min(cache_len, tlm.SHARED_ATTN_SLOTS)


def test_prompt_past_the_shared_ring_raises_before_any_compute(monkeypatch):
    """JAX keeps the zeroed shared ring for a prompt past its 4096 slots (its
    decode then attends to zeros); the port refuses the prompt, before the
    prefill runs."""
    cfg = reduced_config(ARCH).replace(dtype="float32")
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def no_prefill(*a, **k):
        raise AssertionError("the prefill ran")

    monkeypatch.setattr(tlm, "prefill", no_prefill)
    too_long = torch.zeros((1, tlm.SHARED_ATTN_SLOTS + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="shared block's ring of 4096 slots"):
        tengine.generate(model, too_long, steps=2, device="cpu")
    # an explicit cache_len at or below the ring: the same rule, at its size
    with pytest.raises(ValueError, match="does not fit the shared block's ring of 9 slots"):
        tengine.generate(model, torch.zeros((1, 10), dtype=torch.long), steps=1, cache_len=9,
                         device="cpu")


def test_from_jax_lm_params_carries_the_shared_block_and_mixers():
    params, _, model, cfg = models(ARCH, seed=5)
    state = model.state_dict()
    for path, arr in jax.tree_util.tree_flatten_with_path(params["shared_block"])[0]:
        name = "shared_block." + jax.tree_util.keystr(path)[2:-2].replace("']['", ".")
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(arr))
    mixer = params["groups"][1]["mixer"]
    for name in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "out_proj"):
        np.testing.assert_array_equal(state[f"blocks.3.mixer.{name}"].numpy(),
                                      np.asarray(mixer[name][1]))
    np.testing.assert_array_equal(state["blocks.3.mixer.norm.scale"].numpy(),
                                  np.asarray(mixer["norm"]["scale"][1]))
    tree = jax.tree.map(np.asarray, params)
    del tree["shared_block"]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_lm_params(tree, cfg, device="cpu")


def test_decode_writes_the_state_in_place():
    """`lm.decode_step` writes each layer's state into the run's stacked
    cache (and the shared K / V into its ring), as `gqa_decode` writes K and
    V: the cache's tensors stay the same objects."""
    _, _, model, cfg = models(ARCH, seed=8)
    toks = torch.from_numpy(tokens(cfg, 11, 5))
    _, pc = tlm.prefill(model, toks)
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, 8, device="cpu"), pc, cfg)
    before = {n: t.clone() for n, t in cache["groups"][0].items()}
    ids = [id(t) for g in cache["groups"] + cache["shared"] for t in g.values()]
    _, new = tlm.decode_step(model, toks[:, :1], cache)
    assert [id(t) for g in new["groups"] + new["shared"] for t in g.values()] == ids
    assert all(not torch.equal(before[n], new["groups"][0][n]) for n in before)
    assert bool(new["shared"][0]["k"][:, 5].any()) and not new["shared"][0]["k"][:, 6:].any()


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    check_serve_cli(ARCH, capsys, prompt_len=24)


def test_block_kinds_and_state_entries():
    cfg = reduced_config(ARCH)
    assert "mamba" in tblocks.PORTED and "mamba" in tblocks.STATE_KINDS
    entry = tblocks.init_block_cache("mamba", cfg, 2, 99, torch.bfloat16, device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in entry.items()} == {
        "ssm": ((2, 4, 16, 32), torch.float32), "conv": ((2, 3, 160), torch.float32)}
    assert tlm._group_cache_len("mamba", entry) is None
