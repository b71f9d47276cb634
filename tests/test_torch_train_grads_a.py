"""The port's training forward, loss and gradients against the JAX
package's, on the CPU, for every arch's reduced config in f32 (this file:
the first four archs of `ARCHS`; `test_torch_train_grads_b.py` and
`_c.py` the rest, so that pytest-xdist's workers share them).

The JAX package draws the parameters (`lm.init_params`), the gates of the
cross-attention archs are set to 0.5 in its tree (JAX's init of 0 makes a
gated layer the identity), and `convert.from_jax_lm_params` carries the
tree across; tokens, labels and the context input come from a numpy seed.
On the CPU the port's attention runs `flash_attention`'s plain version
under `FlashAttention` (its plain backward) where JAX autodiffs
`dense_attention`.  JAX's gradient tree is carried across the same way and
compared parameter by parameter.

Tolerances, with their reasons (f32 throughout; the two packages sum in
other orders and the port keeps the attention probabilities in f32):
  * the loss and its metrics (``nll``, ``z_loss``, the MoE metrics) within
    1e-5 relative (measured: <= 2e-7);
  * logits within 1e-4 (atol and rtol; measured: a few 1e-6);
  * each parameter's gradient within 1e-4 in relative L2 (measured: <=
    5e-6, but 4.7e-5 for llama-3.2-vision-11b's scalar ``gate_mlp``, a sum
    over every position with cancellation); a gradient that is 0 in JAX
    (``router_bias``: its path to the loss is a ``stop_gradient``) is None
    in the port, which leaves it frozen.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import extra_inputs as jax_extra_inputs
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.train import step as jstep

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import counters
from repro_torch.models import lm as tlm
from repro_torch.train import step as tstep

B, S = 2, 24
LOSS_RTOL, LOGITS_TOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4
GATE = 0.5


def set_gates(params):
    """JAX's tree with every cross-attention gate at `GATE`."""
    def f(path, x):
        name = str(getattr(path[-1], "key", ""))
        return jnp.full_like(x, GATE) if name in ("gate_attn", "gate_mlp") else x

    return jax.tree_util.tree_map_with_path(f, params)


def arch_setup(arch, seed=0, dtype="float32"):
    """-> (JAX params, JAX cfg, port model (trainable), port cfg)."""
    cfg_j = jax_reduced_config(arch).replace(dtype=dtype)
    cfg = reduced_config(arch).replace(dtype=dtype)
    params = set_gates(jlm.init_params(jax.random.key(seed), cfg_j))
    model = from_jax_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, cfg_j, tlm.make_trainable(model), cfg


def np_batch(cfg, seed=1, *, labels=True, batch=B, seq=S):
    """Tokens (and labels, and the arch's context input, normals x 0.02)
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq))
    for name, (shape, _) in jax_extra_inputs(cfg, batch, seq).items():
        out[name] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def carried(tree, cfg) -> dict:
    """A JAX tree shaped as the parameters -> the port's names."""
    return from_jax_lm_params(jax.tree.map(np.asarray, tree), cfg, device="cpu").state_dict()


def assert_rel(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (what, got, want)


def assert_grads(model, jax_grads, cfg, rtol=GRAD_RTOL):
    want = carried(jax_grads, cfg)
    for name, p in model.named_parameters():
        w = want[name]
        if p.grad is None:
            assert not p.requires_grad and name.endswith("router_bias"), name
            assert float(w.abs().max()) == 0.0, name
            continue
        err = float((p.grad - w).norm())
        assert err <= rtol * float(w.norm()) or err <= 1e-12, (name, err, float(w.norm()))


def check_arch(arch):
    params, cfg_j, model, cfg = arch_setup(arch)
    batch = np_batch(cfg)
    jb = to_jax(batch)
    jlogits, jmetrics = jax.jit(lambda p: jlm.forward(p, cfg_j, jb))(params)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, cfg_j, jb), has_aux=True))(params)

    tb = to_torch(batch)
    extras = {k: v for k, v in tb.items() if k not in ("tokens", "labels")} or None
    with torch.no_grad():
        logits, metrics = tlm.forward(model, tb["tokens"], extras=extras)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)

    loss, m = tstep.loss_fn(model, tb)
    loss.backward()
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].detach().numpy(), np.asarray(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert_rel(loss.detach(), jloss, LOSS_RTOL, "loss")
    assert_grads(model, jgrads, cfg)


@pytest.mark.parametrize("arch", ARCHS[:4])
def test_loss_and_gradients_match_jax(arch):
    check_arch(arch)


def test_remat_recomputes_each_layer_with_the_same_gradients():
    """cfg.remat wraps each layer in torch.utils.checkpoint: the gradients
    are bit-equal to a run without it, and each layer's attention runs
    twice (the forward and the recompute) against one plain backward."""
    _, _, model, cfg = arch_setup("gemma-7b")
    tb = to_torch(np_batch(cfg))
    grads = {}
    for remat in (False, True):
        model.cfg = cfg.replace(remat=remat)
        model.zero_grad(set_to_none=True)
        counters.reset()
        loss, _ = tstep.loss_fn(model, tb)
        loss.backward()
        n = cfg.n_layers
        assert counters.PLAIN_CALLS["flash_attention"] == (2 * n if remat else n)
        assert counters.BACKWARD_CALLS["flash_attention"] == n
        assert not any(counters.LAUNCHES.values())
        grads[remat] = {k: p.grad.clone() for k, p in model.named_parameters()}
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k


def test_labels_default_to_the_shifted_tokens():
    params, cfg_j, model, cfg = arch_setup("gemma-7b")
    batch = np_batch(cfg, labels=False)
    (jloss, _), _ = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, cfg_j, to_jax(batch)), has_aux=True))(params)
    with torch.no_grad():
        loss, _ = tstep.loss_fn(model, to_torch(batch))
    assert_rel(loss, jloss, LOSS_RTOL, "loss")
    # the shifted tokens given as labels give the same loss
    t = batch["tokens"]
    with torch.no_grad():
        again, _ = tstep.loss_fn(model, to_torch(
            dict(batch, labels=np.concatenate([t[:, 1:], t[:, -1:]], axis=1))))
    assert float(again) == float(loss)


def test_make_trainable_leaves_router_bias_frozen_and_serving_frozen():
    _, _, model, cfg = arch_setup("deepseek-v3-671b")
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.endswith("moe.router_bias") for n in frozen)
    fresh = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in fresh.parameters())
