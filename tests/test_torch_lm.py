"""The port's language model against the JAX package's, on the CPU.

Reduced gemma-7b (2 layers, d 64, 4 heads of 16, vocab 512): the JAX
package draws the parameters (`lm.init_params`), `convert.from_jax_lm_params`
carries them across, and the prompts come from a numpy seed.  On the CPU
the port's prefill runs `flash_attention`'s plain version where JAX runs
`dense_attention`.

Tolerances, with their reasons:
  * f32: prefill logits against JAX `lm.prefill`, and every decode step
    against JAX `lm.forward`, within 2e-3 (tests/test_decode_consistency.py:28);
    `generate` tokens identical to JAX's;
  * bf16: logits within atol 3e-2 + rtol 3e-2 (the repo's bf16 attention
    tolerance, tests/test_kernels_attention.py:29): the two packages round
    to bf16 at other places (the kernel path keeps the probabilities in
    f32; XLA fuses elementwise chains), so each step's tokens equal JAX's
    except where JAX's top-2 margin lies within the largest logit
    difference seen; those are counted;
  * layers: f32 within 1e-6 (rtol and atol), the embedding exactly.
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
from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import cv_engine as jengine

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import counters
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM
from repro_torch.serve import cv_engine as tengine

B, S, STEPS = 3, 20, 6


def _models(dtype: str, seed: int = 0):
    cfg_j = jax_reduced_config("gemma-7b").replace(dtype=dtype)
    params = jlm.init_params(jax.random.key(seed), cfg_j)
    cfg = reduced_config("gemma-7b").replace(dtype=dtype)
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, model, cfg


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def test_reduced_config_matches_jax_and_full_width_is_published():
    published = {
        "gemma-7b": (28, 3072, 16, 16, 256, 24576, 256000),
        "qwen2-72b": (80, 8192, 64, 8, 128, 29568, 152064),
        "starcoder2-7b": (32, 4608, 36, 4, 128, 18432, 49152),
        "h2o-danube-3-4b": (24, 3840, 32, 8, 120, 10240, 32000),
        "arctic-480b": (35, 7168, 56, 8, 128, 4864, 32000),
        "deepseek-v3-671b": (61, 7168, 128, 128, 128, 18432, 129280),
        "zamba2-2.7b": (54, 2560, 32, 32, 80, 10240, 32000),
        "xlstm-125m": (12, 768, 4, 4, 192, 0, 50304),
        "llama-3.2-vision-11b": (40, 4096, 32, 8, 128, 14336, 128256),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 64, 8192, 256206),
    }
    assert ARCHS == list(published)
    for arch, widths in published.items():
        for name in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "blocks",
                     "window", "shared_attn_every", "cross_attn_layers", "n_image_tokens",
                     "encdec", "n_enc_layers"):
            assert getattr(reduced_config(arch), name) == getattr(jax_reduced_config(arch), name)
        for name in SUB_CONFIGS:
            assert _fields(getattr(reduced_config(arch), name)) == _fields(
                getattr(jax_reduced_config(arch), name))
        full = get_config(arch)
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
                full.d_ff, full.vocab_size) == widths, arch
        assert full.param_dtype == torch.bfloat16


SUB_CONFIGS = ("moe", "mla", "ssm", "xlstm")


def _fields(sub_config):
    return None if sub_config is None else dataclasses.asdict(sub_config)


def _assert_published(arch):
    """Every field the port's config holds is JAX's, at full width and reduced."""
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (reduced_config(arch), jax_reduced_config(arch))):
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if f.name in SUB_CONFIGS:
                got, want = _fields(got), _fields(want)
            assert got == want, (arch, f.name)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "arctic-480b", "deepseek-v3-671b", "xlstm-125m",
                                  "llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_registry_raises_on_an_unported_arch(arch):
    # all six are ported (arctic-480b and deepseek-v3-671b in Queue 1 item 8
    # steps 4-5, zamba2-2.7b and xlstm-125m in step 6, llama-3.2-vision-11b and
    # seamless-m4t-large-v2 in step 7): their published and reduced configs are
    # JAX's; only an arch the JAX package lacks raises
    assert arch in ARCHS
    _assert_published(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        reduced_config("no-such-arch")


@pytest.mark.parametrize(
    "field,value",
    [("moe", object()), ("mla", object()), ("ssm", object()), ("encdec", True),
     ("cross_attn_layers", (1,)), ("shared_attn_every", 2), ("fsdp", True)],
)
def test_config_refuses_a_field_of_an_unported_part(field, value):
    # the JAX config's fields for enc-dec, cross-attention and sharding join
    # with the slice that reads them
    if field in ("moe", "mla", "ssm"):
        # ported (Queue 1 item 8 steps 4-6): the sub-config equals JAX's
        # field for field, by default and in each arch that sets it
        port_cls = {"moe": tconfig.MoEConfig, "mla": tconfig.MLAConfig,
                    "ssm": tconfig.SSMConfig}[field]
        jax_cls = {"moe": jconfig.MoEConfig, "mla": jconfig.MLAConfig,
                   "ssm": jconfig.SSMConfig}[field]
        assert _fields(port_cls()) == _fields(jax_cls())
        for arch in ("arctic-480b", "deepseek-v3-671b", "zamba2-2.7b"):
            assert _fields(getattr(get_config(arch), field)) == _fields(
                getattr(jax_get_config(arch), field))
        if field == "ssm":
            assert get_config("zamba2-2.7b").ssm.n_heads == jax_get_config("zamba2-2.7b").ssm.n_heads == 80
            assert _fields(tconfig.XLSTMConfig()) == _fields(jconfig.XLSTMConfig())
        return
    if field in ("encdec", "cross_attn_layers"):
        # ported (Queue 1 item 8 step 7): JAX's defaults, with n_enc_layers and
        # n_image_tokens, and the values of the archs that set them
        for name in ("encdec", "n_enc_layers", "cross_attn_layers", "n_image_tokens"):
            assert (tconfig.ModelConfig.__dataclass_fields__[name].default
                    == jconfig.ModelConfig.__dataclass_fields__[name].default)
            for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2", "gemma-7b"):
                assert getattr(get_config(arch), name) == getattr(jax_get_config(arch), name)
        assert getattr(reduced_config("gemma-7b").replace(**{field: value}), field) == value
        return
    if field == "shared_attn_every":
        # ported (Queue 1 item 8 step 6): JAX's default and zamba2-2.7b's value
        assert reduced_config("gemma-7b").replace(**{field: value}).shared_attn_every == value
        assert tconfig.ModelConfig.__dataclass_fields__[field].default == 0
        for arch in ("zamba2-2.7b", "gemma-7b"):
            assert get_config(arch).shared_attn_every == jax_get_config(arch).shared_attn_every
        return
    # fsdp: ported with the sharding slice (Queue 1 item 8 step 9): fsdp and
    # dp_over_model take JAX's defaults and each arch's values, published and
    # reduced, and the head-sharding properties follow JAX's
    assert field == "fsdp"
    for name in ("fsdp", "dp_over_model"):
        assert (tconfig.ModelConfig.__dataclass_fields__[name].default
                == jconfig.ModelConfig.__dataclass_fields__[name].default)
    for arch in ARCHS:
        for port, ref in ((get_config(arch), jax_get_config(arch)),
                          (reduced_config(arch), jax_reduced_config(arch))):
            for name in ("fsdp", "dp_over_model", "heads_shardable", "kv_heads_shardable"):
                assert getattr(port, name) == getattr(ref, name), (arch, name)
    assert reduced_config("gemma-7b").replace(**{field: value}).fsdp is value


@pytest.mark.parametrize("kind", ["moe", "mla", "mamba", "xattn", "dec"])
def test_unported_block_kinds_raise(kind):
    # every kind is ported (Queue 1 item 8 steps 4-7): a model of two such
    # layers builds, prefills and decodes, with its kind's cache entries; xattn
    # and dec over a context of 7 rows (image embeddings; the encoder's
    # output).  Only a kind the JAX package lacks raises.
    arch = {"moe": "arctic-480b", "mla": "deepseek-v3-671b", "mamba": "zamba2-2.7b",
            "xattn": "llama-3.2-vision-11b", "dec": "seamless-m4t-large-v2"}[kind]
    cfg = reduced_config(arch).replace(blocks=((kind, 2),), dtype="float32")
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 0, 10))
    extras = {name: torch.randn(B, 7, cfg.d_model, generator=torch.Generator().manual_seed(1))
              for name in [tlm.context_input(cfg)] if name}
    lg, pc = tlm.prefill(model, toks, extras=extras)
    assert lg.shape == (B, cfg.vocab_size) and bool(torch.isfinite(lg).all())
    names = {"moe": {"k", "v"}, "mla": {"ckv", "kr"}, "mamba": {"ssm", "conv"},
             "xattn": {"k", "v"}, "dec": {"k", "v", "xk", "xv"}}[kind]
    assert set(pc["groups"][0]) == names
    if kind in ("xattn", "dec"):
        for name in tblocks.CONTEXT_ENTRIES[kind]:
            assert pc["groups"][0][name].shape == (2, B, 7, cfg.n_kv_heads, cfg.head_dim)
    cache = tengine._adopt_prefill(
        tlm.init_cache(cfg, B, 12, ctx_len=7 if extras else None, device="cpu"), pc, cfg)
    lg, cache = tlm.decode_step(model, toks[:, :1], cache)
    assert lg.shape == (B, cfg.vocab_size) and cache["pos"] == 11
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(reduced_config("gemma-7b").replace(blocks=(("no-such-kind", 2),)), device="cpu")


def test_prefill_and_decode_match_jax_f32():
    params, cfg_j, model, cfg = _models("float32")
    toks = _tokens(cfg, 1, S + 4)
    full, _ = jlm.forward(params, cfg_j, {"tokens": jnp.asarray(toks)})
    lj, _ = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(toks[:, :S])})
    counters.reset()
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks[:, :S]))
    assert counters.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < 2e-3
    assert float(np.max(np.abs(lt.numpy() - np.asarray(full[:, S - 1])))) < 2e-3
    assert pcache["pos"] == S and pcache["groups"][0]["k"].shape == (2, B, S, 4, 16)
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + 8, device="cpu"), pcache, cfg)
    for t in range(S, S + 3):
        lg, cache = tlm.decode_step(model, torch.from_numpy(toks[:, t : t + 1]), cache)
        assert cache["pos"] == t + 1
        err = float(np.max(np.abs(lg.numpy() - np.asarray(full[:, t]))))
        assert err < 2e-3, (t, err)


def test_generate_tokens_identical_to_jax_f32():
    params, cfg_j, model, cfg = _models("float32", seed=2)
    toks = _tokens(cfg, 3)
    mesh = make_host_mesh()
    with mesh:
        want = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    counters.reset()
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # one plain flash call per layer, in the prefill; decode is dense
    assert counters.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    assert sum(counters.LAUNCHES.values()) == 0


def _teacher_forced_logits(prefill, decode, toks, gen):
    """Logits of the prompt's last position and of each decode step fed the
    tokens `gen` (B, STEPS), from one package's prefill and decode."""
    lg, cache = prefill(toks)
    out = [lg]
    for t in range(STEPS - 1):
        lg, cache = decode(gen[:, t : t + 1], cache)
        out.append(lg)
    return np.stack([_f32(x) for x in out], axis=1)  # (B, STEPS, V)


def test_bf16_logits_and_tokens_match_jax_except_near_ties():
    params, cfg_j, model, cfg = _models("bfloat16", seed=4)
    toks = _tokens(cfg, 5)
    mesh = make_host_mesh()
    with mesh:
        gen = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu").numpy()

    def jax_prefill(t):
        lg, pc = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(t)})
        cache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S + STEPS), pc, cfg_j)
        return lg, cache

    def jax_decode(t, cache):
        return jlm.decode_step(params, cfg_j, jnp.asarray(t, jnp.int32), cache)

    def port_prefill(t):
        lg, pc = tlm.prefill(model, torch.from_numpy(t))
        return lg, tengine._adopt_prefill(tlm.init_cache(cfg, B, S + STEPS, device="cpu"), pc, cfg)

    def port_decode(t, cache):
        return tlm.decode_step(model, torch.tensor(np.asarray(t), dtype=torch.long), cache)

    lj = _teacher_forced_logits(jax_prefill, jax_decode, toks, gen)
    lt = _teacher_forced_logits(port_prefill, port_decode, toks, gen)
    np.testing.assert_allclose(lt, lj, rtol=3e-2, atol=3e-2)
    diff = float(np.max(np.abs(lt - lj)))
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    off = np.argmax(lt, axis=-1) != gen
    assert np.all(margin[off] <= diff), (margin[off], diff)
    # the port's own generate: equal to JAX's up to a request's first
    # near-tie, where it takes the port's teacher-forced argmax
    for b in range(B):
        bad = np.flatnonzero(got[b] != gen[b])
        if bad.size:
            t = bad[0]
            assert off[b, t] and got[b, t] == np.argmax(lt[b, t]), (b, t)
    print(f"bf16: max logit diff {diff:.4g}, {int(off.sum())} near-tie tokens of {off.size}")


# ---------------------------------------------------------------------------
# Layers and the embedding
# ---------------------------------------------------------------------------


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("gemma_style", [True, False])
def test_rms_norm_matches_jax(gemma_style):
    x, w = _x((3, 5, 64)), _x((64,), 1) * 0.1
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, gemma_style=gemma_style)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6, gemma_style=gemma_style)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_apply_rope_matches_jax(rotary_dim):
    x = _x((2, 40, 3, 16))
    pos = np.arange(40)[None, :] + np.array([[0], [1000]])
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0, rotary_dim=rotary_dim)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=10000.0, rotary_dim=rotary_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = _x((1000,)) * 4
    want = jlayers.ACTIVATIONS["gelu"](jnp.asarray(x))
    got = tlayers.ACTIVATIONS["gelu"](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_embed_scale_rounds_sqrt_d_to_bf16_at_full_width():
    """At d 3072 in bf16 JAX multiplies by bf16(sqrt(3072)) = 55.5, not 55.43
    (the reduced d 64 gives an exact 8 and cannot show it)."""
    cfg = get_config("gemma-7b").replace(vocab_size=4, n_layers=1, blocks=(("attn", 1),), d_ff=8)
    cfg_j = jax_reduced_config("gemma-7b").replace(
        d_model=3072, vocab_size=4, dtype="bfloat16", scale_embed=True
    )
    table = _x((4, 3072), 6) * 0.02
    jemb = jnp.asarray(table, jnp.bfloat16)
    toks = np.array([[0, 3, 1, 1]])
    want = jlm._embed({"embed": jemb}, cfg_j, jnp.asarray(toks))
    model = LM(cfg, device="meta")
    model.embed = torch.nn.Parameter(
        torch.from_numpy(np.array(jemb.astype(jnp.float32))).to(torch.bfloat16), requires_grad=False
    )
    got = tlm._embed(model, torch.from_numpy(toks))
    np.testing.assert_array_equal(_f32(got), _f32(want))
    ones = torch.ones((1, 3072), dtype=torch.bfloat16)
    model.embed = torch.nn.Parameter(ones, requires_grad=False)
    assert float(tlm._embed(model, torch.zeros((1, 1), dtype=torch.long))[0, 0, 0]) == 55.5


# ---------------------------------------------------------------------------
# The model's own init, conversion and the entry points
# ---------------------------------------------------------------------------


def test_lm_init_is_seeded_truncated_and_counts_params():
    cfg = reduced_config("gemma-7b")
    a = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    b = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for (name, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), name
    assert a.embed.dtype == torch.bfloat16 and a.final_norm["scale"].dtype == torch.float32
    assert float(a.embed.float().abs().max()) <= 3 * 0.02 * (1 + 2**-7)
    w_q = a.blocks[0]["attn"]["w_q"].float()
    assert float(w_q.abs().max()) <= 3 / 64**0.5 * (1 + 2**-7)
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    per_layer = 4 * d * h + 3 * d * f + 2 * d
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.vocab_size * d + cfg.n_layers * per_layer + d
    assert not any(p.requires_grad for p in a.parameters())


def test_from_jax_lm_params_refuses_a_tree_that_does_not_match():
    params, _, _, cfg = _models("float32")
    tree = jax.tree.map(np.asarray, params)
    del tree["groups"][0]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_lm_params(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"][:, :32]
    with pytest.raises(ValueError, match="shape"):
        from_jax_lm_params(tree, cfg, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    cfg = reduced_config("gemma-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    model = LM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.generate(model, torch.zeros((1, 4), dtype=torch.long), steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "gemma-7b", "--reduced"])
    with pytest.raises(ValueError, match="lies on"):
        tengine.generate(LM(cfg, device="meta"), torch.zeros((1, 4), dtype=torch.long), steps=2, device="cpu")


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    tserve.main(
        ["--arch", "gemma-7b", "--reduced", "--device", "cpu", "--requests", "2",
         "--prompt-len", "8", "--gen-len", "4"]
    )
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out and "output shape (2, 4)" in out


def test_block_cache_and_ring_positions():
    cfg = reduced_config("gemma-7b")
    c = tblocks.init_block_cache("attn", cfg, 2, 10, torch.float32, device="cpu")
    assert c["k"].shape == (2, 10, 4, 16) and not c["k"].any()
    kv_pos, valid = tlm.ring_positions(12, 10)
    assert kv_pos.tolist() == [10, 11, 12, 3, 4, 5, 6, 7, 8, 9] and bool(valid.all())
    kv_pos, valid = tlm.ring_positions(3, 10)
    assert valid.tolist() == [True] * 4 + [False] * 6 and int(kv_pos[5]) == 2**30
