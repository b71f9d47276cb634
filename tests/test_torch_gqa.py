"""Grouped-query and sliding-window attention, and the three archs they serve
(qwen2-72b, starcoder2-7b, h2o-danube-3-4b), against the JAX package on the
CPU.

On the CPU `flash_attention` runs its plain version.  The JAX package has
no grouped kernel (its Pallas kernel is MHA only), so the port's grouped
kernel route is held to JAX's `dense_attention`, which repeats KV, and to
JAX's kernel in interpret mode over the repeated KV.

Tolerances, with their reasons:
  * `flash_attention_plain` over KV head groups: `kernels.attention.AGREE`
    (one rounding to the output dtype apart) against JAX's kernel and
    against JAX's `dense_attention` on the same inputs widened to f32 (its
    16-bit path rounds p to v's dtype before p.v, which the kernel and its
    plain version do not);
  * `blockwise_attention` against JAX's: rtol = atol = 1e-5 in f32 (the same
    formula summed in another order, as `dense_attention`'s test), and in
    bf16 one bf16 rounding of the output apart plus one of p (rtol 2^-7,
    atol 2^-7 x max |v|); against the port's `dense_attention`: 1e-5 in f32;
  * the reduced archs in f32: prefill and every decode step within 2e-3 of
    JAX `lm.forward` (tests/test_decode_consistency.py:28), `generate`
    tokens identical to JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import cv_engine as jengine

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve import cv_engine as tengine

NEW_ARCHS = ["qwen2-72b", "starcoder2-7b", "h2o-danube-3-4b"]
B, STEPS = 3, 6


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _inputs(shapes, dtype, seed):
    """numpy normals in `shapes`, rounded to `dtype` by JAX; -> (JAX arrays,
    the port's tensors holding the same values)."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx]
    return jx, tx


# ---------------------------------------------------------------------------
# flash_attention over KV head groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [8, 16, 64, 120])
@pytest.mark.parametrize("R,G", [(1, 3), (2, 2), (4, 2), (9, 4)], ids=lambda x: str(x))
def test_flash_plain_over_kv_groups_matches_jax(R, G, hd, causal, dtype):
    H, S, T = R * G, 70, 70 if causal else 90
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, S, H, hd), (2, T, G, hd), (2, T, G, hd)], dtype, R * 1000 + hd + causal
    )
    counters.reset()
    got = kattn.flash_attention(tq, tk, tv, causal=causal)
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    assert got.shape == tq.shape and got.dtype == tq.dtype
    rtol, atol = kattn.AGREE[tq.dtype]
    kr, vr = jattn._repeat_kv(jk, R), jattn._repeat_kv(jv, R)
    want = jops.flash_attention(jq, kr, vr, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)
    f32 = [a.astype(jnp.float32) for a in (jq, jk, jv)]
    dense = jattn.dense_attention(*f32, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(dense), rtol=rtol, atol=atol)


@pytest.mark.parametrize("heads", [(4, 3), (6, 4), (2, 0)])
def test_flash_attention_refuses_a_kv_head_count_that_does_not_divide(heads):
    H, G = heads
    q, kv = torch.zeros((1, 8, H, 16)), torch.zeros((1, 8, G, 16))
    counters.reset()
    with pytest.raises(ValueError, match="KV heads"):
        kattn.flash_attention(q, kv, kv)
    assert counters.PLAIN_CALLS["flash_attention"] == 0
    assert not tattn.kernel_route(q, kv, kv)


# ---------------------------------------------------------------------------
# blockwise_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize(
    "window,soft_cap,offset,causal",
    [(None, None, 0, True), (24, None, 0, True), (None, 30.0, 0, True), (40, 20.0, 1000, True),
     (None, None, 7, False)],
    ids=["plain", "window", "soft_cap", "window_cap_offset", "full"],
)
def test_blockwise_matches_jax_grouped_both_ways(window, soft_cap, offset, causal, chunk, dtype):
    """T = 150 keys: 150 = 9 x 16 + 6 and 2 x 64 + 22, so the tail is padded
    at position 2^30 with either chunk; 12 query heads over 4 KV heads."""
    S, T, H, G, hd = 40, 150, 12, 4, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, S, H, hd), (2, T, G, hd), (2, T, G, hd)], dtype, chunk + offset
    )
    kv_pos = np.arange(T) + offset
    q_pos = kv_pos[None, -S:] + np.array([[0], [-5]])  # (B, S): the last S keys' positions, shifted
    kw = dict(causal=causal, window=window, soft_cap=soft_cap)
    got = tattn.blockwise_attention(
        tq, tk, tv, q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos), chunk=chunk, **kw
    )
    assert got.shape == tq.shape and got.dtype == tq.dtype
    if dtype == "float32":
        rtol, atol = 1e-5, 1e-5
    else:
        rtol, atol = 2.0**-7, 2.0**-7 * float(np.abs(_np(tv)).max())
    for grouped in (True, False):
        want = jattn.blockwise_attention(
            jq, jk, jv, q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), chunk=chunk,
            grouped=grouped, **kw,
        )
        np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=atol)
    if dtype == "float32":
        dense = tattn.dense_attention(
            tq, tk, tv, q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos), **kw
        )
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_blockwise_keeps_fully_masked_rows_at_zero():
    """A query row with no key in its window (JAX's guard: m stays -1e30 and
    l 0) gives 0, not NaN, as JAX's does."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 2, 8), (1, 20, 1, 8), (1, 20, 1, 8)], "float32", 5)
    q_pos, kv_pos = np.array([3, 100]), np.arange(20)
    got = tattn.blockwise_attention(
        tq, tk, tv, q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos), window=4, chunk=8
    )
    want = jattn.blockwise_attention(
        jq, jk, jv, q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos), window=4, chunk=8
    )
    assert torch.isfinite(got).all() and not got[0, 1].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The routing of models.attention.attention at the archs' shapes
# ---------------------------------------------------------------------------


def _routed(S, T, H, G, hd, **kw):
    (_, _, _), (q, k, v) = _inputs([(1, S, H, hd), (1, T, G, hd), (1, T, G, hd)], "float32", S + T)
    counters.reset()
    out = tattn.attention(q, k, v, **kw)
    route = "flash" if counters.PLAIN_CALLS["flash_attention"] else "other"
    assert tattn.kernel_route(q, k, v, **{n: x for n, x in kw.items() if n not in ("causal", "chunk")}) == (
        route == "flash"
    )
    return route, out, (q, k, v)


@pytest.mark.parametrize(
    "S,H,G,hd,window,route",
    [
        (40, 8, 2, 8, None, "flash"),  # reduced qwen2-72b
        (40, 36, 4, 16, None, "flash"),  # starcoder2-7b's 36 over 4
        (32, 4, 2, 16, 32, "flash"),  # reduced danube, T = window
        (40, 4, 2, 16, 32, "other"),  # reduced danube, T > window
        (40, 6, 2, 12, None, "other"),  # reduced starcoder2-7b: head dim 12
        (40, 4, 2, 264, None, "other"),  # head dim over 256
    ],
)
def test_attention_routes_by_shape_and_equals_dense(S, H, G, hd, window, route):
    got, out, (q, k, v) = _routed(S, S, H, G, hd, window=window)
    assert got == route
    want = tattn.dense_attention(q, k, v, window=window)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_attention_above_8192_routes_to_blockwise_and_matches_jax():
    """Self-attention over 8200 positions with a window (h2o-danube-3-4b's
    long prompt, cut to 2 heads of 8 and a window of 4096): not the kernel
    (T > window), blockwise (T > 8192, no kv_valid), JAX's `attention`'s
    numbers."""
    S, H, G, hd = 8200, 2, 1, 8
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, S, H, hd), (1, S, G, hd), (1, S, G, hd)], "float32", 9)
    pos = np.arange(S)
    counters.reset()
    got = tattn.attention(
        tq, tk, tv, q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos), window=4096, chunk=1024
    )
    assert counters.PLAIN_CALLS["flash_attention"] == 0
    want = jattn.attention(
        jq, jk, jv, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos), window=4096, grouped=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # positions None take the same route: T > window rules the kernel out
    route, out, _ = _routed(S, S, H, G, hd, window=4096)
    assert route == "other"


# ---------------------------------------------------------------------------
# The archs
# ---------------------------------------------------------------------------


def _models(arch: str, seed: int = 0, bias_seed: int | None = None):
    """JAX's reduced model in f32 and the port's, carried over.  With
    `bias_seed` every bias (QKV, LayerNorm, MLP) gets random values first:
    JAX initialises them to 0, which cannot show that they were carried."""
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    params = jlm.init_params(jax.random.key(seed), cfg_j)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)

        def rand_bias(path, a):
            name = jax.tree_util.keystr(path[-1:])
            if "b_" in name or "bias" in name:
                return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1)
            return a

        params = jax.tree_util.tree_map_with_path(rand_bias, params)
    cfg = reduced_config(arch).replace(dtype="float32")
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, model, cfg


def _prompt_len(cfg) -> int:
    """A prompt inside the window (reduced danube: 32), else 20 tokens."""
    return min(20, cfg.window or 20)


def test_configs_match_jax_and_are_published():
    published = {
        "qwen2-72b": (80, 8192, 64, 8, 128, 29568, 152064, None),
        "starcoder2-7b": (32, 4608, 36, 4, 128, 18432, 49152, None),
        "h2o-danube-3-4b": (24, 3840, 32, 8, 120, 10240, 32000, 4096),
    }
    widths = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
              "window")
    same = widths + ("blocks", "norm", "norm_eps", "act", "mlp_style", "qkv_bias", "rope_theta",
                     "tie_embeddings", "attn_soft_cap", "blockwise_chunk", "dtype")
    for arch, want in published.items():
        assert tuple(getattr(get_config(arch), f) for f in widths) == want, arch
        for f in same:
            assert getattr(get_config(arch), f) == getattr(jax_get_config(arch), f), (arch, f)
            assert getattr(reduced_config(arch), f) == getattr(jax_reduced_config(arch), f), (arch, f)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_weights_and_biases_carry_across(arch):
    """Every parameter, the random biases included, lands in the port's model,
    and the prefill logits follow: within 2e-3 of JAX's."""
    params, cfg_j, model, cfg = _models(arch, seed=3, bias_seed=4)
    state = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    n_bias = 0
    for path, arr in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "groups":
            arr = np.asarray(arr)
            for li in range(arr.shape[0]):
                name = ".".join(["blocks", str(li), *map(str, keys[2:])])
                np.testing.assert_array_equal(state[name].numpy(), arr[li])
                n_bias += keys[-1].startswith("b_") or keys[-1] == "bias"
        else:
            np.testing.assert_array_equal(state[".".join(map(str, keys))].numpy(), np.asarray(arr))
    want_bias = {"qwen2-72b": 3, "starcoder2-7b": 7, "h2o-danube-3-4b": 0}[arch]
    assert n_bias == want_bias * cfg.n_layers
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, _prompt_len(cfg)))
    lj, _ = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(toks)})
    lt, _ = tlm.prefill(model, torch.from_numpy(toks))
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < 2e-3


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_jax_forward_f32(arch):
    params, cfg_j, model, cfg = _models(arch, seed=1, bias_seed=2)
    S = _prompt_len(cfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S + 4))
    full, _ = jlm.forward(params, cfg_j, {"tokens": jnp.asarray(toks)})
    counters.reset()
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks[:, :S]))
    kv = torch.zeros((1, S, cfg.n_kv_heads, cfg.head_dim))
    routed = tattn.kernel_route(
        torch.zeros((1, S, cfg.n_heads, cfg.head_dim)), kv, kv, window=cfg.window)
    assert counters.PLAIN_CALLS["flash_attention"] == (cfg.n_layers if routed else 0)
    assert float(np.max(np.abs(lt.numpy() - np.asarray(full[:, S - 1])))) < 2e-3
    assert pcache["groups"][0]["k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + 8, device="cpu"), pcache, cfg)
    for t in range(S, S + 4):
        lg, cache = tlm.decode_step(model, torch.from_numpy(toks[:, t : t + 1]), cache)
        err = float(np.max(np.abs(lg.numpy() - np.asarray(full[:, t]))))
        assert err < 2e-3, (t, err)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_tokens_identical_to_jax_f32(arch):
    params, cfg_j, model, cfg = _models(arch, seed=7)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, _prompt_len(cfg)))
    mesh = make_host_mesh()
    with mesh:
        want = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(counters.LAUNCHES.values()) == 0


def test_ring_prompt_past_the_window_decodes_like_jax_forward():
    """Reduced h2o-danube-3-4b (window 32), a prompt of 40: the prefill KV is
    adopted into the 32-slot ring (positions 8-39 at slots p % 32), and every
    step of the port's `generate` and of its teacher-forced decode lies
    within 2e-3 of JAX `lm.forward` over the whole sequence.  JAX's own
    decode keeps the zeroed ring here (its `_adopt_prefill`), the fault the
    port departs from: it lies far off `lm.forward`."""
    params, cfg_j, model, cfg = _models("h2o-danube-3-4b", seed=9)
    S, window = 40, cfg.window
    assert window == 32
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (B, S))
    gen = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu").numpy()
    seq = np.concatenate([toks, gen], axis=1)
    full, _ = jlm.forward(params, cfg_j, {"tokens": jnp.asarray(seq)})
    full = np.asarray(full)  # (B, S + STEPS, V): position S - 1 + t predicts gen[:, t]
    np.testing.assert_array_equal(gen, np.argmax(full[:, S - 1 : S - 1 + STEPS], axis=-1))

    lt, pcache = tlm.prefill(model, torch.from_numpy(toks))
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + STEPS, device="cpu"), pcache, cfg)
    ring = cache["groups"][0]["k"]
    assert ring.shape[2] == window
    slots = np.arange(S - window, S) % window
    assert torch.equal(ring[:, :, slots], pcache["groups"][0]["k"][:, :, S - window :])
    errs = [float(np.abs(lt.numpy() - full[:, S - 1]).max())]
    for t in range(STEPS - 1):
        lg, cache = tlm.decode_step(model, torch.from_numpy(gen[:, t : t + 1]), cache)
        errs.append(float(np.abs(lg.numpy() - full[:, S + t]).max()))
    assert max(errs) < 2e-3, errs

    _, jcache = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(toks)})
    jcache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S + STEPS), jcache, cfg_j)
    jl, _ = jlm.decode_step(params, cfg_j, jnp.asarray(gen[:, :1], jnp.int32), jcache)
    ref_err = float(np.abs(np.asarray(jl) - full[:, S]).max())
    print(f"decode logits against lm.forward: port {max(errs):.3g}, JAX's generate {ref_err:.3g}")
    assert ref_err > 100 * max(errs)


def test_adopt_prefill_refuses_a_prompt_longer_than_a_full_cache():
    cfg = reduced_config("qwen2-72b").replace(dtype="float32")
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    _, pcache = tlm.prefill(model, torch.zeros((1, 12), dtype=torch.long))
    with pytest.raises(ValueError, match="does not fit"):
        tengine._adopt_prefill(tlm.init_cache(cfg, 1, 8, device="cpu"), pcache, cfg)


@pytest.mark.parametrize("cache_len", [16, 32, 100])
def test_init_cache_clamps_to_the_window_as_jax(cache_len):
    cfg, cfg_j = reduced_config("h2o-danube-3-4b"), jax_reduced_config("h2o-danube-3-4b")
    got = tlm.init_cache(cfg, 2, cache_len, device="cpu")["groups"][0]["k"]
    want = jlm.init_cache(cfg_j, 2, cache_len)["groups"][0]["k"]
    assert tuple(got.shape) == tuple(want.shape) and got.shape[2] == min(cache_len, 32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_runs_each_new_arch_reduced_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                 "--prompt-len", "40", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out and "output shape (2, 4)" in out


def test_get_config_keeps_the_first_layers():
    """qwen2-72b's card runs keep 8 of its 80 layers at full width."""
    cut = get_config("qwen2-72b", n_layers=8)
    full = get_config("qwen2-72b")
    assert cut.n_layers == 8 and cut.blocks == (("attn", 8),)
    assert cut.replace(n_layers=80, blocks=(("attn", 80),)) == full
    for bad in (0, 81):
        with pytest.raises(ValueError, match="cannot keep"):
            get_config("qwen2-72b", n_layers=bad)
