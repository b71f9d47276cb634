"""The MoE FFN and the two archs it serves (arctic-480b, deepseek-v3-671b)
against the JAX package on the CPU.

Inputs come from numpy seeds; the JAX package draws the parameters and
`convert.from_jax_lm_params` (or `_tree`) carries them across.

Routing near-ties: top-k can choose another expert where the k-th and the
(k+1)-th selection scores differ by less than the two packages' rounding
apart, and a changed choice moves the slot ranks of the sequence's later
tokens.  So every check records both packages' routing at each MoE call
(`_Routes`), holds the choices equal except at counted near-ties (a token
whose chosen set differs, where JAX's gap between its k-th and (k+1)-th
score is at most twice the largest score difference of the call's other
tokens, those whose choices agree on the sequences without a change so
far: a changed choice must lie within the perturbation every token sees),
and compares outputs only on sequences with no such token.

Tolerances, with their reasons:
  * f32: `_route`'s weights and metrics within 1e-6 (the same f32 formulas
    summed in another order); `moe_ffn` and the block within 1e-5
    (absolute, on outputs of order 1); prefill and every decode step of the
    reduced archs within 2e-3 of JAX `lm.forward`
    (tests/test_decode_consistency.py:28); `generate` tokens identical;
  * bf16: logits within atol 3e-2 + rtol 3e-2 (the repo's bf16 attention
    tolerance, tests/test_kernels_attention.py:29), tokens equal but at
    counted logit near-ties, as in tests/test_torch_lm.py.
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.mesh import make_host_mesh
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import cv_engine as jengine

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import counters
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.serve import cv_engine as tengine

ARCHS = ["arctic-480b", "deepseek-v3-671b"]
B, S, STEPS = 3, 20, 6


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tree(tree, dtype=None) -> nn.ParameterDict:
    """A JAX parameter tree (nested dicts of arrays) -> nested ParameterDicts
    holding the same values (each array in its own dtype, or `dtype`)."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = _tree(a, dtype)
        else:
            t = torch.from_numpy(_np(a).copy())
            jdt = jnp.asarray(a).dtype
            out[name] = nn.Parameter(
                t.to(dtype or (torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32)),
                requires_grad=False,
            )
    return nn.ParameterDict(out)


def _x(shape, dtype="float32", seed=0):
    """numpy normals rounded to `dtype` by JAX -> (JAX array, the same values
    in torch)."""
    jx = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32), dtype)
    return jx, torch.from_numpy(_np(jx).copy()).to(getattr(torch, dtype))


def _moe_params(arch, *, seed=0, bias_seed=None, tie=False, dtype="float32"):
    """JAX's `init_moe` for `arch`'s reduced config, with a random
    ``router_bias`` (`bias_seed`) and, with `tie`, expert 1's router column
    (and bias) a copy of expert 0's: an exact tie in every token's scores."""
    cfg = jax_reduced_config(arch).replace(dtype=dtype)
    p = jmoe.init_moe(jax.random.key(seed), cfg)
    if bias_seed is not None and "router_bias" in p:
        rb = np.random.default_rng(bias_seed).standard_normal(cfg.moe.n_experts) * 0.05
        p["router_bias"] = jnp.asarray(rb.astype(np.float32))
    if tie:
        p["router"] = p["router"].at[:, 1].set(p["router"][:, 0])
        if "router_bias" in p:
            p["router_bias"] = p["router_bias"].at[1].set(p["router_bias"][0])
    return cfg, p


# ---------------------------------------------------------------------------
# routing near-ties
# ---------------------------------------------------------------------------


def _jax_sel(p, x, m):
    """JAX's selection scores (`repro.models.moe._route`'s `sel`)."""
    logits = jnp.asarray(x).astype(jnp.float32) @ p["router"]
    if m.router_style == "sigmoid":
        scores = jax.nn.sigmoid(logits)
        return scores + p["router_bias"] if "router_bias" in p else scores
    return jax.nn.softmax(logits, axis=-1)


class _Routes:
    """Both packages' `_route` calls, in order: (selection scores, idx)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        port_route, jax_route = tmoe._route, jmoe._route

        def port(p, x, m):
            out = port_route(p, x, m)
            self.port.append((_np(tmoe.selection_scores(p, x, m)[2]), out[1].numpy()))
            return out

        def jx(p, x, m):
            out = jax_route(p, x, m)
            self.jax.append((_np(_jax_sel(p, x, m)), np.asarray(out[1])))
            return out

        monkeypatch.setattr(tmoe, "_route", port)
        monkeypatch.setattr(jmoe, "_route", jx)

    def judge(self, k: int):
        return _judge(self.port, self.jax, k)


def _judge(port, jax_calls, k: int):
    """Aligned calls of both packages -> (sequences with no changed choice
    (B,) bool, near-tie tokens): every changed choice must be a near-tie
    (module docstring)."""
    assert len(port) == len(jax_calls) > 0
    clean = np.ones(port[0][1].shape[0], dtype=bool)
    n_ties = 0
    for (sp, ip), (sj, ij) in zip(port, jax_calls):
        changed = np.any(np.sort(ip, -1) != np.sort(ij, -1), axis=-1)  # (B, S)
        agree = ~changed & clean[:, None]
        delta = float(np.abs(sp - sj)[agree].max()) if agree.any() else 0.0
        top = -np.sort(-sj, axis=-1)
        gap = top[..., k - 1] - top[..., k]
        off = changed & clean[:, None]
        assert np.all(gap[off] <= 2 * delta), (gap[off], delta)
        n_ties += int(off.sum())
        clean &= ~changed.any(-1)
    return clean, n_ties


# ---------------------------------------------------------------------------
# _route, moe_ffn, the MoE blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True], ids=["random", "planted_tie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, tie, monkeypatch):
    """Both router styles (arctic softmax, deepseek sigmoid with a nonzero
    ``router_bias`` carried across): weights, choices, ``moe_aux``,
    ``moe_z`` and ``expert_load``.  `planted_tie` gives experts 0 and 1 the
    same scores for every token, so the tie break decides where they meet
    at the k-th place: counted as near-ties."""
    cfg_j, p = _moe_params(arch, bias_seed=3, tie=tie)
    cfg = reduced_config(arch)
    m = cfg.moe
    jx, tx = _x((B, 16, cfg.d_model), seed=1)
    routes = _Routes(monkeypatch)
    wj, ij, mj = jmoe._route(p, jx, cfg_j.moe)
    wt, it, mt = tmoe._route(_tree(p), tx, m)
    clean, n_ties = routes.judge(m.top_k)
    assert it.dtype == torch.int64 and wt.dtype == torch.float32
    # weights by expert, on the tokens whose choices agree
    same = np.all(np.sort(it.numpy(), -1) == np.sort(np.asarray(ij), -1), axis=-1)
    dense_t = np.zeros((B, 16, m.n_experts), np.float32)
    dense_j = np.zeros_like(dense_t)
    np.put_along_axis(dense_t, it.numpy(), wt.numpy(), axis=-1)
    np.put_along_axis(dense_j, np.asarray(ij), np.asarray(wj), axis=-1)
    np.testing.assert_allclose(dense_t[same], dense_j[same], rtol=1e-6, atol=1e-6)
    # each near-tie token moves at most k experts' load by one token's share
    n = B * 16
    np.testing.assert_allclose(_np(mt["expert_load"]), np.asarray(mj["expert_load"]),
                               atol=n_ties / n + 1e-6, rtol=0)
    np.testing.assert_allclose(float(mt["moe_aux"]), float(mj["moe_aux"]),
                               atol=m.n_experts * 2 * n_ties / n + 1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(mt["moe_z"]), float(mj["moe_z"]), rtol=1e-6, atol=1e-6)
    if tie:
        assert n_ties == int((~same).sum())
    else:
        assert same.all()
    print(f"{arch} {'planted' if tie else 'random'}: {n_ties} near-tie tokens of {n}")


@pytest.mark.parametrize(
    "arch,cf,dtype",
    [("deepseek-v3-671b", None, "float32"), ("arctic-480b", None, "float32"),
     ("deepseek-v3-671b", 0.25, "float32"), ("arctic-480b", 0.25, "float32"),
     ("deepseek-v3-671b", None, "bfloat16"), ("arctic-480b", 0.25, "bfloat16")],
)
def test_moe_ffn_matches_jax(arch, cf, dtype, monkeypatch):
    """Shared experts (deepseek) and none (arctic), at the reduced configs'
    capacity and at ``capacity_factor=0.25``, where tokens drop: the output
    and ``moe_drop_frac`` (as JAX's tests/test_moe.py:13)."""
    cfg_j, p = _moe_params(arch, bias_seed=4, dtype=dtype)
    cfg = reduced_config(arch).replace(dtype=dtype)
    jx, tx = _x((B, 16, cfg.d_model), dtype, seed=2)
    routes = _Routes(monkeypatch)
    oj, mj = jmoe.moe_ffn(p, jx, cfg_j, capacity_factor=cf)
    ot, mt = tmoe.moe_ffn(_tree(p), tx, cfg, capacity_factor=cf)
    clean, n_ties = routes.judge(cfg.moe.top_k)
    assert ot.dtype == tx.dtype and ot.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(ot)[clean], _np(oj)[clean], rtol=tol, atol=tol)
    if clean.all():
        assert float(mt["moe_drop_frac"]) == pytest.approx(float(mj["moe_drop_frac"]), abs=1e-7)
    if cf is not None:
        assert float(mj["moe_drop_frac"]) > 0
    print(f"{arch} cf={cf} {dtype}: drop {float(mt['moe_drop_frac']):.4f}, "
          f"{n_ties} near-tie tokens, {int((~clean).sum())} of {B} sequences set aside")


def test_capacity_drops_as_jax():
    """JAX's tests/test_moe.py:13 config: all tokens routed, some dropped."""
    cfg_j = jax_reduced_config("arctic-480b")
    cfg_j = cfg_j.replace(moe=cfg_j.moe.__class__(n_experts=8, top_k=2, d_ff_expert=32,
                                                  capacity_factor=0.25))
    cfg = reduced_config("arctic-480b")
    cfg = cfg.replace(moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=0.25))
    p = jmoe.init_moe(jax.random.key(0), cfg_j)
    x = jax.random.normal(jax.random.key(1), (2, 16, cfg.d_model), jnp.float32)
    oj, mj = jmoe.moe_ffn(p, x, cfg_j)
    # JAX promotes its bf16 experts to x's f32 in each product; the port's
    # matmuls take one dtype, so the same values go in as f32
    ot, mt = tmoe.moe_ffn(_tree(p, torch.float32), torch.from_numpy(_np(x).copy()), cfg)
    assert tmoe.capacity(cfg, 16) == 1
    assert float(mt["moe_drop_frac"]) > 0
    assert float(mt["moe_drop_frac"]) == pytest.approx(float(mj["moe_drop_frac"]), abs=1e-7)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, monkeypatch):
    """The MoE block (arctic: the dense FFN in parallel with its own
    ``ln_dense``; deepseek: MLA + shared experts): h, the cache entry and
    the metrics of JAX's `apply_block`, then one decode step at
    ``decode_capacity_factor``."""
    kind = {"arctic-480b": "moe", "deepseek-v3-671b": "mla_moe"}[arch]
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    cfg = reduced_config(arch).replace(dtype="float32")
    pj = jblocks.init_block(jax.random.key(5), kind, cfg_j)
    if "router_bias" in pj["moe"]:
        pj["moe"]["router_bias"] = jnp.linspace(-0.05, 0.05, cfg.moe.n_experts)
    pt = _tree(pj)
    assert ("ln_dense" in pt) == ("dense_mlp" in pt) == (arch == "arctic-480b")
    jx, tx = _x((B, 12, cfg.d_model), seed=6)
    routes = _Routes(monkeypatch)
    hj, cj, mj = jblocks.apply_block(kind, pj, jx, cfg_j, positions=jnp.arange(12)[None, :])
    ht, ct, mt = tblocks.apply_block(kind, pt, tx, cfg)
    clean, _ = routes.judge(cfg.moe.top_k)
    np.testing.assert_allclose(_np(ht)[clean], _np(hj)[clean], rtol=1e-5, atol=1e-5)
    assert set(ct) == set(cj)
    for name in ct:
        np.testing.assert_allclose(_np(ct[name]), _np(cj[name]), rtol=1e-5, atol=1e-5)
    assert set(mt) == set(mj) == {"moe_aux", "moe_z", "expert_load", "moe_drop_frac"}
    if clean.all():
        for name in mt:
            np.testing.assert_allclose(_np(mt[name]), _np(mj[name]), rtol=1e-5, atol=1e-6)
    # one decode step over a cache of 16 slots holding the 12 positions
    cache_t = tblocks.init_block_cache(kind, cfg, B, 16, torch.float32, device="cpu")
    cache_j = jblocks.init_block_cache(kind, cfg_j, B, 16, jnp.float32)
    for name in cache_t:
        cache_t[name][:, :12] = ct[name]
        cache_j[name] = cache_j[name].at[:, :12].set(cj[name])
    kv_pos, valid = tlm.ring_positions(12, 16)
    jx1, tx1 = _x((B, 1, cfg.d_model), seed=7)
    hj, cj = jblocks.apply_block_decode(kind, pj, jx1, cfg_j, cache=cache_j, pos=12,
                                        kv_pos=jnp.asarray(kv_pos.numpy()),
                                        kv_valid=jnp.asarray(valid.numpy()))
    ht, ct = tblocks.apply_block_decode(kind, pt, tx1, cfg, cache=cache_t, pos=12,
                                        kv_pos=kv_pos, kv_valid=valid)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=1e-5, atol=1e-5)
    for name in ct:
        np.testing.assert_allclose(_np(ct[name]), _np(cj[name]), rtol=1e-5, atol=1e-5)


def test_decode_capacity_is_the_decode_factor():
    """A decode step (S = 1) gives each expert ceil(k / E * cf) slots:
    arctic's 128 experts at top-2 and cf 4 have one; JAX's reduced configs
    set 64, which keeps every choice."""
    full = get_config("arctic-480b")
    assert tmoe.capacity(full, 1, full.moe.decode_capacity_factor) == 1
    assert tmoe.capacity(full, 1024) == math.ceil(1024 * 2 / 128 * 1.25) == 20
    ds = get_config("deepseek-v3-671b")
    assert tmoe.capacity(ds, 1024) == 40
    red = reduced_config("arctic-480b")
    assert tmoe.capacity(red, 1, red.moe.decode_capacity_factor) == 16


def test_init_moe_layout():
    """Router and bias in f32 (the bias zero, for the sigmoid router only),
    the experts stacked (E, D, F) in the weights' dtype and drawn with the
    fan-in of JAX's `dense_init` (E * D), truncated at 3 std; the shared
    expert an MLP of ``d_ff_shared * n_shared``."""
    for arch in ARCHS:
        cfg = reduced_config(arch)
        m = cfg.moe
        p = tmoe.init_moe(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        assert p["router"].dtype == torch.float32 and p["router"].shape == (cfg.d_model, m.n_experts)
        assert p["w_gate"].shape == (m.n_experts, cfg.d_model, m.d_ff_expert)
        assert p["w_down"].shape == (m.n_experts, m.d_ff_expert, cfg.d_model)
        assert p["w_up"].dtype == torch.bfloat16
        std = 1 / math.sqrt(m.n_experts * cfg.d_model)
        w = p["w_up"].float()
        assert float(w.abs().max()) <= 3 * std * (1 + 2**-7)
        assert 0.8 * std < float(w.std()) < 1.0 * std  # a normal truncated at 3 std: 0.986 std
        assert ("router_bias" in p) == (m.router_style == "sigmoid")
        if "router_bias" in p:
            assert p["router_bias"].dtype == torch.float32 and not p["router_bias"].any()
        assert ("shared" in p) == bool(m.n_shared)
        if m.n_shared:
            assert p["shared"]["w_gate"].shape == (cfg.d_model, m.d_ff_shared * m.n_shared)
    # a stack is drawn a matrix at a time, from the generator's one stream
    a = tlayers.dense_init((3, 4, 5), dtype=torch.float32,
                           generator=torch.Generator().manual_seed(1))
    b = tlayers.dense_init((3, 4, 5), dtype=torch.float32,
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# the reduced archs end to end
# ---------------------------------------------------------------------------


def _models(arch: str, dtype: str = "float32", seed: int = 0):
    """JAX's reduced model and the port's, carried over; a nonzero
    ``router_bias`` (JAX initialises it to 0, which cannot show that it was
    carried)."""
    cfg_j = jax_reduced_config(arch).replace(dtype=dtype)
    params = jlm.init_params(jax.random.key(seed), cfg_j)
    rng = np.random.default_rng(seed + 100)
    for g in params["groups"]:
        if "moe" in g and "router_bias" in g["moe"]:
            rb = g["moe"]["router_bias"]
            g["moe"]["router_bias"] = jnp.asarray(
                rng.standard_normal(rb.shape).astype(np.float32) * 0.05)
    cfg = reduced_config(arch).replace(dtype=dtype)
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, model, cfg


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_forward_f32(arch, monkeypatch):
    params, cfg_j, model, cfg = _models(arch, seed=1)
    toks = _tokens(cfg, 6, S + 4)
    routes = _Routes(monkeypatch)
    with jax.disable_jit():  # JAX's layer scan as a loop, so that its routes are recorded
        full, _ = jlm.forward(params, cfg_j, {"tokens": jnp.asarray(toks)})
    counters.reset()
    lt, pcache = tlm.prefill(model, torch.from_numpy(toks[:, :S]))
    # every layer's attention takes the kernel route (MLA: v padded to 24 channels)
    assert counters.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    names = [{"k", "v"} if k == "moe" else {"ckv", "kr"} for k, _ in cfg.blocks]
    assert [set(g) for g in pcache["groups"]] == names
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + 8, device="cpu"), pcache, cfg)
    steps = [lt]
    for t in range(S, S + 4):
        lg, cache = tlm.decode_step(model, torch.from_numpy(toks[:, t : t + 1]), cache)
        steps.append(lg)
    # JAX's forward routes the S + 4 tokens of a layer at once; the port's
    # prefill the first S, then one token a step: aligned by layer
    n_moe = sum(c for k, c in cfg.blocks if k in ("moe", "mla_moe"))
    port = routes.port
    assert len(routes.jax) == n_moe and len(port) == n_moe * 5
    aligned = [tuple(np.concatenate([port[li][j]] + [port[n_moe * (1 + s) + li][j]
                                                    for s in range(4)], axis=1) for j in (0, 1))
               for li in range(n_moe)]
    clean, n_ties = _judge(aligned, routes.jax, cfg.moe.top_k)
    for i, lg in enumerate(steps):
        err = float(np.max(np.abs(lg.numpy()[clean] - np.asarray(full[:, S - 1 + i])[clean])))
        assert err < 2e-3, (i, err)
    print(f"{arch} f32: {n_ties} routing near-tie tokens, {int((~clean).sum())} of {B} "
          "sequences set aside")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_to_jax_f32(arch):
    params, cfg_j, model, cfg = _models(arch, seed=2)
    toks = _tokens(cfg, 3)
    mesh = make_host_mesh()
    with mesh:
        want = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    counters.reset()
    got = tengine.generate(model, torch.from_numpy(toks), steps=STEPS, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert counters.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    assert sum(counters.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax_but_at_counted_near_ties(arch, monkeypatch):
    """Teacher-forced on JAX's tokens: each step's logits within 3e-2 on the
    sequences whose routing agrees at every MoE call, each token the port's
    argmax but at a counted logit near-tie."""
    params, cfg_j, model, cfg = _models(arch, dtype="bfloat16", seed=4)
    toks = _tokens(cfg, 5)
    mesh = make_host_mesh()
    with mesh:
        gen = np.asarray(jengine.generate(params, cfg_j, jnp.asarray(toks), steps=STEPS, mesh=mesh))
    routes = _Routes(monkeypatch)
    with jax.disable_jit():
        lg, pc = jlm.prefill(params, cfg_j, {"tokens": jnp.asarray(toks)})
        cache = jengine._adopt_prefill(jlm.init_cache(cfg_j, B, S + STEPS), pc, cfg_j)
        lj = [_np(lg)]
        for t in range(STEPS - 1):
            lg, cache = jlm.decode_step(params, cfg_j, jnp.asarray(gen[:, t : t + 1], jnp.int32),
                                        cache)
            lj.append(_np(lg))
    lt_, pc = tlm.prefill(model, torch.from_numpy(toks))
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, B, S + STEPS, device="cpu"), pc, cfg)
    lt = [_np(lt_)]
    for t in range(STEPS - 1):
        lg, cache = tlm.decode_step(model, torch.tensor(gen[:, t : t + 1], dtype=torch.long), cache)
        lt.append(_np(lg))
    lj, lt = np.stack(lj, 1), np.stack(lt, 1)  # (B, STEPS, V)
    clean, n_ties = routes.judge(cfg.moe.top_k)
    np.testing.assert_allclose(lt[clean], lj[clean], rtol=3e-2, atol=3e-2)
    diff = float(np.max(np.abs(lt[clean] - lj[clean]))) if clean.any() else 0.0
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    off = (np.argmax(lt, axis=-1) != gen) & clean[:, None]
    assert np.all(margin[off] <= diff), (margin[off], diff)
    print(f"{arch} bf16: {n_ties} routing near-tie tokens, {int((~clean).sum())} of {B} sequences "
          f"set aside; max logit diff {diff:.4g}, {int(off.sum())} logit near-tie tokens")


# ---------------------------------------------------------------------------
# conversion, configs, cache entries, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_lm_params_carries_the_nested_trees(arch):
    params, _, model, cfg = _models(arch)
    state = model.state_dict()
    first = 0
    seen = set()
    for (kind, count), group in zip(cfg.blocks, params["groups"]):
        flat = {}

        def walk(t, prefix=""):
            for n, a in t.items():
                if isinstance(a, dict):
                    walk(a, f"{prefix}{n}.")
                else:
                    flat[f"{prefix}{n}"] = a

        walk(group)
        for path, arr in flat.items():
            for li in range(count):
                got = state[f"blocks.{first + li}.{path}"]
                np.testing.assert_array_equal(_np(got), _np(arr[li]))
            seen.add(path)
        first += count
    want = {"moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"}
    want |= ({"dense_mlp.w_gate", "ln_dense.scale"} if arch == "arctic-480b" else
             {"moe.router_bias", "moe.shared.w_gate", "moe.shared.w_down", "attn.q_norm.scale",
              "attn.kv_norm.scale", "attn.w_uk", "attn.w_kr"})
    assert want <= seen
    tree = jax.tree.map(np.asarray, params)
    leaf = ("moe", "router") if arch == "arctic-480b" else ("attn", "kv_norm")
    del tree["groups"][-1][leaf[0]][leaf[1]]
    with pytest.raises(ValueError, match="missing"):
        from_jax_lm_params(tree, cfg, device="cpu")


def test_get_config_keeps_the_first_layers_across_runs():
    """deepseek-v3-671b's card runs keep 4 layers: its 3 dense MLA layers and
    one MLA-MoE layer; arctic-480b keeps 2 of 35."""
    ds = get_config("deepseek-v3-671b")
    assert get_config("deepseek-v3-671b", n_layers=4).blocks == (("mla", 3), ("mla_moe", 1))
    assert get_config("deepseek-v3-671b", n_layers=2).blocks == (("mla", 2),)
    assert get_config("deepseek-v3-671b", n_layers=3).blocks == (("mla", 3),)
    assert get_config("deepseek-v3-671b", n_layers=61) == ds
    cut = get_config("deepseek-v3-671b", n_layers=10)
    assert cut.n_layers == 10 and cut.blocks == (("mla", 3), ("mla_moe", 7))
    assert cut.replace(n_layers=61, blocks=ds.blocks) == ds
    assert get_config("arctic-480b", n_layers=2).blocks == (("moe", 2),)
    for bad in (0, 62):
        with pytest.raises(ValueError, match="cannot keep"):
            get_config("deepseek-v3-671b", n_layers=bad)


def test_cache_is_keyed_by_entry_name():
    """MLA layers cache ``ckv`` / ``kr`` at the full length, attention layers
    ``k`` / ``v`` clamped to a window (JAX `lm.init_cache`); `_adopt_prefill`
    copies each entry by name and refuses entries that do not match;
    `_group_cache_len` reads ``ckv`` for the MLA kinds."""
    cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32", window=8)
    cfg_j = jax_reduced_config("deepseek-v3-671b").replace(dtype="float32", window=8)
    got = tlm.init_cache(cfg, 2, 12, device="cpu")
    want = jlm.init_cache(cfg_j, 2, 12)
    for g, w in zip(got["groups"], want["groups"]):
        assert {n: tuple(t.shape) for n, t in g.items()} == {n: tuple(t.shape) for n, t in w.items()}
    assert tlm._group_cache_len("mla", got["groups"][0]) == 12
    arctic = reduced_config("arctic-480b").replace(window=8)
    assert tlm.init_cache(arctic, 2, 12, device="cpu")["groups"][0]["k"].shape[2] == 8
    pre = {"groups": [{"ckv": torch.randn(n, 2, 5, 16), "kr": torch.randn(n, 2, 5, 8)}
                      for _, n in cfg.blocks], "pos": 5}
    cache = tengine._adopt_prefill(tlm.init_cache(cfg, 2, 12, device="cpu"), pre, cfg)
    assert cache["pos"] == 5
    for g, p in zip(cache["groups"], pre["groups"]):
        for name in ("ckv", "kr"):
            assert torch.equal(g[name][:, :, :5], p[name])
            assert not g[name][:, :, 5:].any()
    bad = {"groups": [{"k": torch.zeros(n, 2, 5, 4, 16), "v": torch.zeros(n, 2, 5, 4, 16)}
                      for _, n in cfg.blocks], "pos": 5}
    with pytest.raises(ValueError, match="entries"):
        tengine._adopt_prefill(tlm.init_cache(cfg, 2, 12, device="cpu"), bad, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_new_arch_reduced_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                 "--prompt-len", "24", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in out and "output shape (2, 4)" in out
