"""The xLSTM cells and blocks (mLSTM chunkwise, sLSTM scan) and the arch they
serve (xlstm-125m) against the JAX package on the CPU.

Inputs come from numpy seeds; the JAX package draws the parameters and
`convert.from_jax_lm_params` (or `_tree`) carries them across, the leaves
JAX initialises to constants given random values first
(`test_torch_ssm.perturbed`).  The arch-level checks are
test_torch_ssm.py's, called here for xlstm-125m.

Tolerances, with their reasons:
  * the cells and blocks in f32: rtol = atol = 1e-5 (the same f32 formulas
    summed in another order: the chunk and step loops in Python where JAX
    scans, three-operand einsums contracted pairwise); `mlstm_chunkwise`
    against a loop of `mlstm_step` the same;
  * the reduced arch: as test_torch_ssm.py states.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import reduced_config as jax_reduced_config
from repro.models import xlstm as jxl

from repro_torch.configs import reduced_config
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txl

import test_torch_ssm as common
from test_torch_moe import _tree

ARCH = "xlstm-125m"
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def _state(names_shapes: dict, seed: int) -> dict:
    """A random f32 state: numpy arrays by name."""
    return {n: _normal(s, seed + i) for i, (n, s) in enumerate(names_shapes.items())}


def _both(state: dict):
    return ({n: jnp.asarray(a) for n, a in state.items()},
            {n: torch.from_numpy(a.copy()) for n, a in state.items()})


# ---------------------------------------------------------------------------
# the mLSTM cell
# ---------------------------------------------------------------------------


def _mlstm_inputs(S, seed, NH=2, DH=8, Bsz=2):
    q, k, v = (_normal((Bsz, S, NH, DH), seed + i) for i in range(3))
    logi = _normal((Bsz, S, NH), seed + 3)
    logf = np.log(1 / (1 + np.exp(-(_normal((Bsz, S, NH), seed + 4) + 2)))).astype(np.float32)
    return q, k, v, logi, logf


def _mlstm_state(seed, NH=2, DH=8, Bsz=2):
    st = _state({"C": (Bsz, NH, DH, DH), "n": (Bsz, NH, DH), "m": (Bsz, NH)}, seed)
    st["C"] *= 0.3
    return st


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunkwise_matches_jax_and_the_step_loop(chunk, with_state):
    S = 19
    arrays = _mlstm_inputs(S, chunk)
    state = _mlstm_state(chunk + 10) if with_state else None
    jst, tst = _both(state) if with_state else (None, None)
    jh, jfin = jxl.mlstm_chunkwise(*map(jnp.asarray, arrays), chunk=chunk, state=jst)
    th, tfin = txl.mlstm_chunkwise(*(torch.from_numpy(a) for a in arrays), chunk=chunk, state=tst)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("C", "n", "m"):
        assert tfin[name].dtype == torch.float32
        np.testing.assert_allclose(tfin[name].numpy(), np.asarray(jfin[name]), **TOL)
    # the same recurrence one token at a time
    q, k, v, logi, logf = (torch.from_numpy(a) for a in arrays)
    st = tst if with_state else {
        "C": torch.zeros(2, 2, 8, 8), "n": torch.zeros(2, 2, 8), "m": torch.full((2, 2), txl.NEG)}
    hs = []
    for t in range(S):
        h, st = txl.mlstm_step(q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t], st)
        hs.append(h)
    np.testing.assert_allclose(th.numpy(), torch.stack(hs, 1).numpy(), **TOL)
    # the step loop's state carries the scale exp(m) another way: compare C / exp(m)
    for name, sl in (("C", (..., None, None)), ("n", (..., None))):
        np.testing.assert_allclose((tfin[name] * torch.exp(tfin["m"])[sl]).numpy(),
                                   (st[name] * torch.exp(st["m"])[sl]).numpy(), rtol=1e-4, atol=1e-5)


def test_mlstm_step_matches_jax():
    q, k, v, logi, logf = (a[:, 0] for a in _mlstm_inputs(1, 30))
    jst, tst = _both(_mlstm_state(31))
    jh, jnew = jxl.mlstm_step(*map(jnp.asarray, (q, k, v, logi, logf)), jst)
    th, tnew = txl.mlstm_step(*(torch.from_numpy(a) for a in (q, k, v, logi, logf)), tst)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("C", "n", "m"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]), **TOL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block(kind: str, seed=0):
    cfg_j = jax_reduced_config(ARCH).replace(dtype="float32")
    init = {"mlstm": jxl.init_mlstm_block, "slstm": jxl.init_slstm_block}[kind]
    p = common.perturbed(init(jax.random.key(seed), cfg_j), seed + 1)
    return cfg_j, p, _tree(p), reduced_config(ARCH).replace(dtype="float32")


def _block_state(kind: str, cfg, seed):
    zero = {"mlstm": txl.init_mlstm_state, "slstm": txl.init_slstm_state}[kind](cfg, 2)
    st = _state({n: tuple(t.shape) for n, t in zero.items()}, seed)
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5  # a normaliser state is positive
    return st


@pytest.mark.parametrize("S_", [19, 3])
def test_mlstm_block_matches_jax(S_):
    cfg_j, jp, tp, cfg = _block("mlstm")
    x = _normal((2, S_, cfg.d_model), S_)
    jy, jfin = jax.jit(lambda p, x: jxl.mlstm_block(p, x, cfg_j))(jp, jnp.asarray(x))
    ty, tfin = txl.mlstm_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tfin) == {"C", "n", "m", "conv"}
    for name in tfin:
        np.testing.assert_allclose(tfin[name].numpy(), np.asarray(jfin[name]), **TOL)


@pytest.mark.parametrize("S_", [1, 2])
def test_mlstm_conv_tail_is_left_padded_below_the_taps(S_):
    cfg_j, jp, tp, cfg = _block("mlstm")
    x = _normal((2, S_, cfg.d_model), S_)
    _, jfin = jax.jit(lambda p, x: jxl.mlstm_block(p, x, cfg_j))(jp, jnp.asarray(x))
    _, tfin = txl.mlstm_block(tp, torch.from_numpy(x), cfg)
    K = cfg.xlstm.d_conv
    assert tfin["conv"].shape == (2, K - 1, cfg.xlstm.d_inner_m) and jfin["conv"].shape[1] < K - 1
    xm = torch.chunk(torch.from_numpy(x) @ tp["w_up"], 2, dim=-1)[0]
    np.testing.assert_array_equal(tfin["conv"][:, K - 1 - S_ :].numpy(), xm.numpy())
    assert not tfin["conv"][:, : K - 1 - S_].any()


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_jax(kind):
    cfg_j, jp, tp, cfg = _block(kind, seed=3)
    x = _normal((2, 1, cfg.d_model), 4)
    jst, tst = _both(_block_state(kind, cfg, 5))
    decode = {"mlstm": (jxl.mlstm_block_decode, txl.mlstm_block_decode),
              "slstm": (jxl.slstm_block_decode, txl.slstm_block_decode)}[kind]
    jy, jnew = jax.jit(lambda p, x, st: decode[0](p, x, cfg_j, state=st))(jp, jnp.asarray(x), jst)
    ty, tnew = decode[1](tp, torch.from_numpy(x), cfg, state=tst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tnew) == set(jnew) == common.state_names(kind)
    for name in tnew:
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(with_state):
    cfg_j, jp, tp, cfg = _block("slstm", seed=6)
    x = _normal((2, 13, cfg.d_model), 7)
    jst, tst = _both(_block_state("slstm", cfg, 8)) if with_state else (None, None)
    jh, jfin = jxl.slstm_scan(jp, jnp.asarray(x), cfg_j, state=jst)
    th, tfin = txl.slstm_scan(tp, torch.from_numpy(x), cfg, state=tst)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("c", "n", "h", "m"):
        np.testing.assert_allclose(tfin[name].numpy(), np.asarray(jfin[name]), **TOL)
    jy, _ = jxl.slstm_block(jp, jnp.asarray(x), cfg_j, state=jst)
    ty, _ = txl.slstm_block(tp, torch.from_numpy(x), cfg, state=tst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_slstm_bias_is_added_in_the_activation_dtype():
    """bf16: x @ w_gates + bias rounds to bf16 before the f32 cast, as JAX's."""
    cfg_j = jax_reduced_config(ARCH)  # bf16
    p = common.perturbed(jxl.init_slstm_block(jax.random.key(2), cfg_j), 3)
    tp = _tree(p)
    x = jnp.asarray(_normal((1, 5, cfg_j.d_model), 9), jnp.bfloat16)
    jh, _ = jxl.slstm_scan(p, x, cfg_j)
    th, _ = txl.slstm_scan(tp, torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16(),
                           reduced_config(ARCH))
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh.astype(jnp.float32)),
                               rtol=2.0**-7, atol=1e-3)


def test_init_slstm_block_copies_jax():
    """JAX draws ``ffn.w_gate`` and ``ffn.w_up`` from one key: equal at init;
    the forget-gate bias spans linspace(3, 6) per head; ``r_gates`` is f32."""
    cfg = reduced_config(ARCH)
    p = txl.init_slstm_block(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jp = jxl.init_slstm_block(jax.random.key(0), jax_reduced_config(ARCH))
    assert torch.equal(p["ffn"]["w_gate"], p["ffn"]["w_up"])
    assert p["ffn"]["w_gate"] is not p["ffn"]["w_up"]
    assert bool(jnp.all(jp["ffn"]["w_gate"] == jp["ffn"]["w_up"]))
    np.testing.assert_array_equal(p["b_gates"].numpy(), np.asarray(jp["b_gates"]))
    for name in ("w_gates", "r_gates", "b_gates"):
        assert tuple(p[name].shape) == jp[name].shape
        assert str(p[name].dtype)[6:] == str(jp[name].dtype)
    for name in ("w_gate", "w_up", "w_down"):
        assert tuple(p["ffn"][name].shape) == jp["ffn"][name].shape


def test_init_mlstm_block_layout():
    cfg = reduced_config(ARCH)
    p = txl.init_mlstm_block(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jp = jxl.init_mlstm_block(jax.random.key(0), jax_reduced_config(ARCH))
    for name, t in p.named_parameters():
        want = jp[name] if "." not in name else jp["norm"]["scale"]
        assert tuple(t.shape) == want.shape and str(t.dtype)[6:] == str(want.dtype), name
    for name in ("conv_b", "b_i", "b_f", "norm"):
        np.testing.assert_array_equal(common._np(p[name]["scale"] if name == "norm" else p[name]),
                                      common._np(jp[name]["scale"] if name == "norm" else jp[name]))


# ---------------------------------------------------------------------------
# the reduced arch end to end (test_torch_ssm.py's checks)
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax_forward_f32():
    common.check_prefill_and_decode_match_jax_f32(ARCH)


def test_prefill_past_one_chunk_matches_jax_forward_f32():
    """37 positions: the mLSTM carries its state across chunks of 16."""
    common.check_prefill_and_decode_match_jax_f32(ARCH, S_=37)


def test_generate_tokens_identical_to_jax_f32():
    common.check_generate_tokens_identical_to_jax_f32(ARCH)


def test_bf16_logits_match_jax_but_at_counted_near_ties():
    common.check_bf16_logits_match_jax_but_at_counted_near_ties(ARCH)


@pytest.mark.parametrize("S_", [1, 2])
def test_short_prompts_decode_like_jax_forward(S_):
    common.check_short_prompts_decode_like_jax_forward(ARCH, S_)


@pytest.mark.parametrize("cache_len", [12, 100])
def test_init_cache_matches_jax(cache_len):
    common.check_cache_matches_jax(ARCH, cache_len)
    assert tlm.init_cache(reduced_config(ARCH), 1, cache_len, device="cpu")["shared"] == []


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    common.check_serve_cli(ARCH, capsys, prompt_len=2)


def test_block_kinds_and_state_entries():
    cfg = reduced_config(ARCH)
    for kind in ("mlstm", "slstm"):
        assert kind in tblocks.PORTED and kind in tblocks.STATE_KINDS
        entry = tblocks.init_block_cache(kind, cfg, 2, 99, torch.bfloat16, device="cpu")
        assert set(entry) == common.state_names(kind)
        assert all(t.dtype == torch.float32 for t in entry.values())
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not hasattr(model, "shared_block")
    assert [k for k, _ in model.groups()] == ["mlstm", "slstm"]
