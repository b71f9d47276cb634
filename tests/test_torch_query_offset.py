"""`flash_attention`'s query offset and the model axis's layout rules,
against the JAX package on the CPU.

A query offset places the S query rows at positions ``q_off`` ..
``q_off + S - 1`` of a longer sequence: a rank's slice of the queries
under the sequence-parallel layout (`sharding.rules.model_layout`).  JAX
computes the same function on the gathered queries, so the plain version
over a slice is held to JAX's kernel (interpret mode, as its own tests run
it; KV repeated over the head groups, as JAX's kernel is MHA only) on the
whole sequence, at the slice's rows; the plain backward to JAX's gradient
of `dense_attention` at the slice's positions.

Tolerances, with their reasons:
  * the forward: `kernels.attention.AGREE` (each computes in f32 and
    rounds once to the output dtype), as `tests/test_torch_gqa.py`;
  * offset 0: bit-equal to the call without an offset;
  * the backward, f32: rtol = atol = 1e-5 (the same sums in another
    order, as `tests/test_torch_train_grads_a.py`'s attention check).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.configs import get_config as jax_get_config

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.models import attention as tattn
from repro_torch.roofline.cost import CostMode
from repro_torch.sharding import rules

S_FULL = 128


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("off,rows", [(0, 32), (1, 37), (64, 64), (100, 28), (127, 1)])
@pytest.mark.parametrize("R,G", [(1, 2), (4, 2), (3, 1)], ids=lambda x: str(x))
def test_plain_slice_at_an_offset_matches_jax_on_the_whole(R, G, off, rows, dtype):
    H, hd = R * G, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, S_FULL, H, hd), (2, S_FULL, G, hd), (2, S_FULL, G, hd)], dtype, off * 10 + R)
    counters.reset()
    got = kattn.flash_attention(tq[:, off:off + rows].contiguous(), tk, tv, q_off=off)
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    want = jops.flash_attention(jq, jattn._repeat_kv(jk, R), jattn._repeat_kv(jv, R))
    rtol, atol = kattn.AGREE[tq.dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32))[:, off:off + rows],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_zero_is_the_call_without_one(dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 70, 4, 32), generator=g).to(dtype) for _ in range(3))
    assert torch.equal(kattn.flash_attention(q, k, v, q_off=0), kattn.flash_attention(q, k, v))


def test_offset_is_the_mask_only_when_not_causal():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 40, 2, 16), generator=g) for _ in range(3))
    assert torch.equal(kattn.flash_attention(q, k, v, causal=False, q_off=9),
                       kattn.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("off,rows", [(0, 48), (40, 24), (80, 48)])
def test_plain_backward_at_an_offset_matches_jax_grad(off, rows):
    R, G, hd = 2, 2, 16
    rng = np.random.default_rng(off)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, rows, R * G, hd), (2, S_FULL, G, hd), (2, S_FULL, G, hd),
                      (2, rows, R * G, hd))]
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counters.reset()
    out = kattn.flash_attention(q, k, v, q_off=off)
    out.backward(dout)
    assert counters.BACKWARD_CALLS["flash_attention"] == 1
    q_pos, kv_pos = jnp.arange(off, off + rows), jnp.arange(S_FULL)

    def f(q_, k_, v_):
        o = jattn.dense_attention(q_, k_, v_, causal=True, q_pos=q_pos, kv_pos=kv_pos,
                                  grouped=True)
        return jnp.sum(o * jnp.asarray(arrs[3]))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs[:3]))
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,T,off", [(10, 30, 0), (10, 30, 5), (10, 30, 25), (7, 4, 2),
                                     (64, 128, 64)])
def test_causal_pairs_and_the_meta_route_count_the_slice(S, T, off):
    want = sum(min(off + i + 1, T) for i in range(S))
    assert kattn.causal_pairs(S, T, True, off) == want
    assert kattn.causal_pairs(S, T, False, off) == S * T
    q = torch.empty((2, S, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, T, 2, 16), dtype=torch.bfloat16, device="meta")
    with CostMode() as cm:
        kattn.flash_attention(q, k, k, q_off=off)
    assert cm.by_kernel["flash_attention"]["flops"] == 4.0 * 2 * 4 * 16 * want


@pytest.mark.parametrize("bad", [-1, 1.5, True])
def test_a_query_offset_must_be_an_int_of_at_least_zero(bad):
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="q_off"):
        kattn.flash_attention(q, q, q, q_off=bad)


def test_kernel_route_reads_the_offset_against_the_window():
    q, k = torch.zeros((1, 16, 2, 16)), torch.zeros((1, 32, 2, 16))
    assert tattn.kernel_route(q, k, k, window=32, q_off=16)
    assert not tattn.kernel_route(q, k, k, window=31, q_off=16)
    assert not tattn.kernel_route(q, k, k, window=32, q_off=17)


@pytest.mark.parametrize("hd,soft_cap,window", [(16, None, None), (12, None, None),
                                                (16, 30.0, None), (16, None, 20)])
def test_attention_at_an_offset_is_the_slice_of_the_whole(hd, soft_cap, window):
    """On the kernel route (hd 16) and off it (hd 12, a soft cap, a window
    the slice's positions pass): the slice's rows of the whole call."""
    g = torch.Generator().manual_seed(hd)
    q = torch.randn((2, 48, 4, hd), generator=g)
    k, v = (torch.randn((2, 48, 2, hd), generator=g) for _ in range(2))
    kw = dict(soft_cap=soft_cap, window=window)
    whole = tattn.attention(q, k, v, **kw)
    part = tattn.attention(q[:, 24:].contiguous(), k, v, q_off=24, **kw)
    np.testing.assert_allclose(_np(part), _np(whole[:, 24:]), rtol=2e-5, atol=2e-5)


# -- the layout rules ---------------------------------------------------------

POD = rules.MeshShape((16, 16), ("data", "model"))
MULTIPOD = rules.MeshShape((2, 16, 16), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["pod", "multipod"])
def test_model_layout_reads_jax_hint_table(arch, mesh):
    """"tp" exactly where JAX's ``"heads_q"`` hint splits the heads over
    "model"; None where the batch takes the axis (xlstm) or one position
    does not divide it (decode); "sp" elsewhere."""
    cfg = get_config(arch)
    table = rules.make_hint(mesh, cfg).table
    layout = rules.model_layout(cfg, mesh, 4096)
    dp = rules.dp_axes(mesh, cfg)
    if "model" in dp:
        assert layout is None
    elif table["heads_q"] == rules.P(dp, None, "model", None):
        assert layout == "tp"
    else:
        assert layout == "sp" and table["heads_q"] == rules.P(dp, "model", None, None)
    assert rules.model_layout(cfg, mesh, 1) is None
    jcfg = jax_get_config(arch)
    assert (layout == "tp") == (jcfg.heads_shardable and jcfg.kv_heads_shardable)


def test_layouts_of_the_archs_on_the_pod():
    got = {a: rules.model_layout(get_config(a), POD, 4096) for a in ARCHS}
    assert got == {"gemma-7b": "tp", "qwen2-72b": "sp", "starcoder2-7b": "sp",
                   "h2o-danube-3-4b": "sp", "arctic-480b": "sp", "deepseek-v3-671b": "tp",
                   "zamba2-2.7b": "tp", "xlstm-125m": None, "llama-3.2-vision-11b": "sp",
                   "seamless-m4t-large-v2": "tp"}
    # seamless's 256206 rows do not divide 16: its embedding and head stay whole
    assert [a for a in ARCHS if not rules.vocab_parallel(get_config(a), POD)] == [
        "seamless-m4t-large-v2"]


def test_a_tensor_parallel_leaf_keeps_its_model_shard():
    cfg = reduced_config("gemma-7b").replace(n_heads=16, n_kv_heads=16, head_dim=8)
    mesh = rules.MeshShape((4, 2), ("data", "model"))
    tp = rules.Hint(mesh, cfg, {}, layout=rules.model_layout(cfg, mesh, 32))
    sp = rules.Hint(mesh, reduced_config("gemma-7b"), {}, layout="sp")
    assert tp.layout == "tp" and tp.vocab_parallel
    keep = rules.local_leaves(tp)
    assert keep == rules.TP_LEAVES | rules.VOCAB_LEAVES
    assert rules.local_leaves(sp) == rules.VOCAB_LEAVES
    assert rules.local_leaves(None) == frozenset()
    assert rules.gather_axes(mesh, "w_q", 2, keep) == ("data",)
    assert rules.gather_axes(mesh, "w_up", 3, keep) is None  # an expert stack
    assert rules.gather_axes(mesh, "scale", 1, keep) is None
