"""The training loss and the gradient of `flash_attention`, against the JAX
package, on the CPU.

  * `layers.softmax_cross_entropy` against JAX's: value, ``nll``,
    ``z_loss`` and the gradient, at z_loss 0 and 1e-4, over bf16 and f32
    logits and int32 / int64 labels, within 1e-6 relative (both reduce in
    f32; measured: a few 1e-8);
  * `kernels.attention.FlashAttention` (the plain version's forward and
    `flash_attention_backward` on a CPU tensor) against `jax.grad` of JAX's
    `dense_attention` and against autograd through the port's
    `dense_attention`: MHA and GQA, causal and not, S != T, head dims 16 and
    64, within 1e-5 in relative L2 (measured: ~2e-7), also with the query
    rows cut into many blocks (`BWD_SCRATCH_BYTES` made small); in bf16
    each gradient within bf16's rounding of the f32 one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

CE_RTOL, GRAD_RTOL = 1e-6, 1e-5


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
def test_softmax_cross_entropy_matches_jax(z_loss, dtype, label_dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(label_dtype)
    jl = jnp.asarray(logits).astype(dtype)

    def jloss(x):
        return jlayers.softmax_cross_entropy(x, jnp.asarray(labels), z_loss=z_loss)

    (want, wm), wg = jax.value_and_grad(jloss, has_aux=True)(jl)
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got, gm = tlayers.softmax_cross_entropy(x, torch.from_numpy(labels), z_loss=z_loss)
    got.backward()
    assert set(gm) == set(wm) == ({"nll", "z_loss"} if z_loss else {"nll"})
    for k in gm:
        np.testing.assert_allclose(float(gm[k].detach()), float(wm[k]), rtol=CE_RTOL)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=CE_RTOL)
    gw = np.asarray(jnp.asarray(wg).astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else 2.0**-8  # the gradient rounded to bf16 once
    np.testing.assert_allclose(x.grad.float().numpy(), gw, rtol=tol, atol=tol * np.abs(gw).max())


def test_softmax_cross_entropy_detaches_the_max():
    """The shift by the row max carries no gradient (JAX's stop_gradient):
    the gradient of the mean nll is softmax - onehot, over the rows."""
    x = torch.tensor([[1.0, 3.0, 2.0]], requires_grad=True)
    loss, _ = tlayers.softmax_cross_entropy(x, torch.tensor([2]))
    loss.backward()
    want = torch.softmax(x.detach(), -1) - torch.tensor([[0.0, 0.0, 1.0]])
    torch.testing.assert_close(x.grad, want)


CASES = [  # B, S, T, H, Hkv, hd, causal
    (2, 37, 37, 4, 4, 16, True),
    (2, 37, 37, 4, 4, 16, False),
    (1, 40, 40, 6, 2, 64, True),
    (2, 24, 56, 4, 1, 16, False),
    (1, 56, 24, 4, 2, 64, True),
    (2, 20, 45, 8, 4, 64, True),
]


def _qkv(B, S, T, H, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, G, hd)).astype(np.float32),
            rng.standard_normal((B, T, G, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_grads(q, k, v, do, causal, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = kattn.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("B,S,T,H,G,hd,causal", CASES)
def test_flash_gradient_matches_jax_dense_attention(B, S, T, H, G, hd, causal):
    q, k, v, do = _qkv(B, S, T, H, G, hd)

    def f(q, k, v):
        o = jattn.dense_attention(q, k, v, causal=causal, grouped=H != G)
        return jnp.sum(o * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    counters.reset()
    _, got = _port_grads(q, k, v, do, causal)
    assert counters.BACKWARD_CALLS["flash_attention"] == 1
    assert counters.PLAIN_CALLS["flash_attention"] == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= GRAD_RTOL


@pytest.mark.parametrize("B,S,T,H,G,hd,causal", CASES)
def test_flash_gradient_matches_autograd_of_the_ports_dense_attention(
        B, S, T, H, G, hd, causal, monkeypatch):
    q, k, v, do = _qkv(B, S, T, H, G, hd, seed=1)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tattn.dense_attention(*ts, causal=causal, grouped=H != G).backward(torch.from_numpy(do))
    want = [t.grad for t in ts]
    # one block of all rows, then blocks of a few rows (the scratch bound)
    for scratch in (kattn.BWD_SCRATCH_BYTES, 4 * B * H * T * 5):
        monkeypatch.setattr(kattn, "BWD_SCRATCH_BYTES", scratch)
        _, got = _port_grads(q, k, v, do, causal)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w.numpy()) <= GRAD_RTOL


def test_backward_rows():
    assert kattn.backward_rows(4, 16, 1024, 1024) == 1024  # gemma-7b training: one block
    assert kattn.backward_rows(8, 128, 1024, 1024) == 64  # deepseek-v3: 256 MiB blocks
    assert kattn.backward_rows(1, 1, 5, 7) == 5
    assert kattn.backward_rows(128, 128, 4096, 4096) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_gradient_in_16_bit(dtype):
    """Each gradient in q's dtype, within that dtype's rounding of the f32
    gradient of the same (rounded) inputs: the backward is f32 inside."""
    q, k, v, do = _qkv(2, 33, 33, 4, 2, 16, seed=2)
    r = [torch.from_numpy(a).to(dtype).float().numpy() for a in (q, k, v, do)]
    _, want = _port_grads(*r, causal=True)
    _, got = _port_grads(q, k, v, do, True, dtype)
    eps = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-11
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w, rtol=eps, atol=eps * float(w.abs().max()))


def test_no_graph_without_grad():
    """Serving calls (no input requires grad, or grad off) run the wrapper
    directly: no autograd node, no backward counted."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 8))
    assert kattn.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert kattn.flash_attention(qg, k, v).grad_fn is None
    out = kattn.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


def test_backward_counter_is_outside_the_kernel_counters():
    # its own dict: LAUNCHES and PLAIN_CALLS keep exactly the kernels' keys
    assert set(counters.BACKWARD_CALLS) == {"flash_attention"}
    assert set(counters.LAUNCHES) == set(counters.PLAIN_CALLS) == set(counters.KERNELS)
    counters.BACKWARD_CALLS["flash_attention"] = 3
    counters.reset()
    assert counters.snapshot()["backward_calls"] == {"flash_attention": 0}
    assert set(counters.snapshot()["launches"]) == set(counters.KERNELS)


class _CardTensor(torch.Tensor):
    """A meta tensor that reports a CUDA device: the card's stand-in, since
    a meta tensor takes `flash_attention`'s meta route (the dry run's)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_still_launches_or_raises(monkeypatch):
    """Under autograd a non-CPU tensor goes to the kernel's loader: with the
    loader made to fail, the error propagates and no plain version runs
    (a meta tensor reporting a CUDA device stands in for the card)."""
    def fail():
        raise RuntimeError("loader failed")

    monkeypatch.setattr(kattn, "_launcher", fail)
    q = torch.zeros((1, 64, 2, 16), device="meta", requires_grad=True).as_subclass(_CardTensor)
    k = torch.zeros((1, 64, 2, 16), device="meta").as_subclass(_CardTensor)
    counters.reset()
    with pytest.raises(RuntimeError, match="loader failed"):
        kattn.flash_attention(q, k, k)
    assert counters.PLAIN_CALLS["flash_attention"] == 0
