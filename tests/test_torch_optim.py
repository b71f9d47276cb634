"""The optimizers, the schedule, the compression helpers and the train step
against the JAX package's, on the CPU.

  * `cosine_schedule` equal to JAX's at every step tried (both f32);
  * `quantize` / `dequantize` / `compress_with_feedback` equal to JAX's;
  * `lm.param_leaves` names JAX's parameter tree leaf for leaf, in JAX's
    flattening order, and the optimizers' state has JAX's shapes, for
    every arch's reduced config;
  * two and three steps of `make_train_step` with AdamW and with Adafactor
    on reduced gemma-7b and deepseek-v3-671b (its ``router_bias`` update),
    in f32, from JAX's parameters carried across: ``loss``, ``nll``,
    ``z_loss``, the MoE metrics and ``grad_norm`` within 1e-5 relative,
    ``lr`` within 1e-6 (the f32 cosine may differ by an ulp), and every
    parameter and optimizer-state tensor within 1e-4 in relative L2
    (measured: <= 6e-6 after three steps at peak lr 1e-2);
  * `make_accum_train_step` at accum 2 the same way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.launch.mesh import make_host_mesh
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro.train import step as jstep

from repro_torch.configs import ARCHS
from repro_torch.models import lm as tlm
from repro_torch.optim import compression as tcomp
from repro_torch.optim import cosine_schedule
from repro_torch.train import step as tstep
from test_torch_train_grads_a import arch_setup, carried, np_batch, to_jax, to_torch

METRIC_RTOL, LR_RTOL, STATE_RTOL = 1e-5, 1e-6, 1e-4
PEAK_LR, WARMUP, TOTAL = 1e-2, 1, 10


@pytest.mark.parametrize("warmup,total", [(200, 10000), (1, 4), (5, 5), (0, 1)])
def test_cosine_schedule_matches_jax(warmup, total):
    for s in (0, 1, 2, 3, 4, 5, 6, 199, 200, 201, 5000, 9999, 10000, 12000):
        got = cosine_schedule(s, peak_lr=3e-4, warmup=warmup, total=total)
        want = jsched.cosine_schedule(jnp.asarray(s, jnp.int32), peak_lr=3e-4, warmup=warmup,
                                      total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=LR_RTOL, atol=1e-12)
    assert float(cosine_schedule(0, peak_lr=1.0, warmup=1)) == 0.0


def test_compression_matches_jax():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((33, 17)) * 3).astype(np.float32)
    r = (rng.standard_normal((33, 17)) * 0.01).astype(np.float32)
    q, scale = tcomp.quantize(torch.from_numpy(g))
    jq, jscale = jcomp.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(tcomp.dequantize(q, scale).numpy(),
                                  np.asarray(jcomp.dequantize(jq, jscale)))
    got = tcomp.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(r))
    want = jcomp.compress_with_feedback(jnp.asarray(g), jnp.asarray(r))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # an all-zero tensor keeps the 1e-12 floor on its scale
    q0, s0 = tcomp.quantize(torch.zeros(4))
    assert float(s0) == float(jcomp.quantize(jnp.zeros(4))[1]) and not q0.any()


def _dotted(keypath) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_leaves_and_optimizer_state_are_jaxs(arch):
    params, _, model, _ = arch_setup(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    leaves = tlm.param_leaves(model)
    assert [lf.name for lf in leaves] == [_dotted(kp) for kp, _ in flat]
    for lf, (_, arr) in zip(leaves, flat):
        stacked = torch.stack(lf.params) if lf.stacked else lf.params[0]
        assert tuple(stacked.shape) == arr.shape, lf.name
    jf = jstep.adafactor_init(params)["f"]
    tf = tstep.init_state(None, optimizer="adafactor", model=model)["opt"]["f"]
    assert list(tf) == [lf.name for lf in leaves]
    for f_t, f_j in zip(tf.values(), jf):
        assert {k: tuple(v.shape) for k, v in f_t.items()} == {k: v.shape for k, v in f_j.items()}


def _jax_state(params, optimizer):
    init = jstep.adamw_init if optimizer == "adamw" else jstep.adafactor_init
    return {"params": params, "opt": init(params), "step": jnp.zeros((), jnp.int32)}


def _assert_state(state, jstate, cfg, optimizer):
    want = carried(jstate["params"], cfg)
    for name, p in state["model"].named_parameters():
        assert float((p - want[name]).norm()) <= STATE_RTOL * float(want[name].norm()), name
    leaves = tlm.param_leaves(state["model"])
    opt, jopt = state["opt"], jstate["opt"]
    assert opt["count"] == int(jopt["count"])
    if optimizer == "adamw":
        pairs = [(opt[k][lf.name], jax.tree_util.tree_leaves(jopt[k])[i])
                 for k in ("m", "v") for i, lf in enumerate(leaves)]
    else:
        pairs = [(f_t[k], f_j[k]) for f_t, f_j in zip(opt["f"].values(), jopt["f"]) for k in f_t]
    for got, w in pairs:
        w = torch.from_numpy(np.asarray(w))
        assert got.shape == w.shape
        assert float((got - w).norm()) <= STATE_RTOL * float(w.norm()) + 1e-30


def _assert_metrics(m, jm):
    assert set(m) == set(jm) - {"expert_load"}
    for k, v in m.items():
        rtol = LR_RTOL if k == "lr" else METRIC_RTOL
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v3-671b"])
def test_train_steps_match_jax(arch, optimizer):
    params, cfg_j, model, cfg = arch_setup(arch)
    kw = dict(optimizer=optimizer, peak_lr=PEAK_LR, warmup=WARMUP, total_steps=TOTAL)
    jts = jax.jit(jstep.make_train_step(cfg_j, make_host_mesh(), **kw))
    ts = tstep.make_train_step(cfg, **kw)
    jstate = _jax_state(params, optimizer)
    state = tstep.init_state(cfg, optimizer=optimizer, model=model)
    bias0 = [p.clone() for n, p in model.named_parameters() if n.endswith("router_bias")]
    for i in range(3):
        batch = np_batch(cfg, seed=10 + i, labels=False)
        jstate, jm = jts(jstate, to_jax(batch))
        state, m = ts(state, to_torch(batch))
        _assert_metrics(m, jm)
        assert state["step"] == int(jstate["step"]) == i + 1
        if i >= 1:  # two and three steps (step 0 runs at lr 0)
            _assert_state(state, jstate, cfg, optimizer)
    bias = [p for n, p in model.named_parameters() if n.endswith("router_bias")]
    assert bool(bias) == (arch == "deepseek-v3-671b")
    for b0, b in zip(bias0, bias):  # a sign step of 1e-3 a step
        assert float((b - b0).abs().max()) > 0 and not b.requires_grad


def test_accum_train_step_matches_jax():
    params, cfg_j, model, cfg = arch_setup("gemma-7b")
    kw = dict(optimizer="adamw", accum=2, peak_lr=PEAK_LR, warmup=WARMUP, total_steps=TOTAL)
    jts = jax.jit(jstep.make_accum_train_step(cfg_j, make_host_mesh(), **kw))
    ts = tstep.make_accum_train_step(cfg, **kw)
    jstate = _jax_state(params, "adamw")
    state = tstep.init_state(cfg, model=model)
    for i in range(2):
        batch = np_batch(cfg, seed=20 + i, batch=4)
        jstate, jm = jts(jstate, to_jax(batch))
        state, m = ts(state, to_torch(batch))
        _assert_metrics(m, jm)
    _assert_state(state, jstate, cfg, "adamw")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstep.make_train_step(None, optimizer="sgd")
