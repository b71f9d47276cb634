"""The sharded LM stack on 8 gloo ranks on the CPU, a (4, 2) ("data",
"model") mesh, against the port's single-process run and the JAX package.

The ranks run once (`tests/torch_sharding_job.py`, one spawn with its own
timeout) and so does the JAX side on 8 host devices (`run_subprocess`,
JAX's own multi-device tests' way); the two run at the same time.  The
single-process references run here.

Tolerances, with their reasons (f32 throughout):
  * the sharded forward of reduced deepseek-v3-671b (the all-to-all MoE
    path, which the plan must take): logits within 1e-4 and every
    gradient within 1e-3 of the single-process port and of JAX's
    `lm.forward` / `jax.grad` with the same parameters: JAX's own bounds
    for its all-to-all path against its scatter path (`tests/test_moe.py`);
    the loss differs from the single-process one only by the aux loss,
    which the all-to-all path takes per shard, as JAX's (`moe_aux_weight`
    times the difference, within 1e-6);
  * `compressed_psum`: the mean within the quantization scale of the true
    mean (JAX's `tests/test_compression.py`) and within 1e-6 of JAX's
    output; `bf16_psum` within bfloat16's rounding of its inputs and
    partial sums (2^-9 relative each) of the true mean, and within twice
    that of JAX's (the two sum in other orders);
  * two train steps of reduced gemma-7b (AdamW, Adafactor, the
    accumulation step): losses within 1e-5 and parameters within 1e-4 of
    the single-process steps (the training parity bounds of
    `tests/test_torch_optim.py`);
  * two train steps of reduced deepseek-v3-671b (AdamW, ``router_bias``
    moved): losses within 1e-5 and parameters within 1e-4 of JAX's
    sharded steps on the same mesh, which take the aux loss per shard as
    the port does; the single-process steps take it over the whole batch,
    so against them the first loss differs by the aux loss's share only;
  * two Adafactor steps of reduced arctic-480b (the all-to-all MoE, its
    expert stacks and their Adafactor factors split over ("data",
    "model"), its aux loss weighted 0, the one term that path takes per
    shard): losses within 1e-5 and parameters within 1e-4 of JAX's
    `train_step`, run unsharded (the same function);
  * the optimizer state of gemma's AdamW and Adafactor, deepseek's AdamW
    and arctic's Adafactor runs: on every rank the local shapes of
    `rules.opt_state_specs` (ZeRO-1), `opt_bytes_zero1` bytes, and a leaf
    split over an axis its parameter does not use; a spec naming a
    dimension's axes out of the mesh's order (("model", "data")) holds
    JAX's block and gathers whole (`comm.spec_full`), exact;
  * the elastic restore and the resharded training state: equal;
  * the model axis's layouts (`LAYOUT_CASES`: reduced gemma-7b and
    seamless-m4t-large-v2 at 16 q and 16 KV heads, tensor-parallel;
    reduced qwen2-72b with random biases, sequence-parallel; reduced
    deepseek-v3-671b above, sequence-parallel MLA with the all-to-all MoE
    on the sequence slices; reduced zamba2-2.7b, its 4 SSD heads split 2
    a rank, JAX's ``"ssm_heads"``): the sharded forward's logits within
    1e-4 and its gradients within 1e-3, two AdamW steps' losses within
    1e-5 and parameters within 1e-4, of the single-process port and of
    JAX's sharded run on the same mesh (deepseek: its logits and gradients
    against JAX's sharded ones as well; zamba2 against JAX unsharded,
    `JAX_WHOLE`); the "tp" case's sharded `generate` equal to the
    single-process one; zamba2's every scan over 2 heads, ``out_proj``
    read as the rank's rows, and its prefill decoded 4 steps
    teacher-forced within 1e-4 of the single process;
  * decode over the model axis (`DECODE_CASES`: "tp", split-K alone, the
    window ring wrapped over both model ranks, MLA split-K and "tp" with
    the MoE expert-parallel over ("data", "model"), the MoE over "model"
    alone with a pruned cache, zamba2's shared ring split beside its whole
    Mamba2 states, the cross-attention's context split): the
    teacher-forced logits of every step within 1e-4 of the single-process
    port and of JAX's `lm.decode_step` on the same adopted cache, run
    unsharded (the merged softmax sums in another order), and every
    rank's cache entries `rules.cache_specs`' parts (T / 2 slots where the
    axis divides T, whole where it does not; a state whole).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from conftest import run_subprocess
from torch_sharding_job import (DECODE_B, DECODE_CASES, DECODE_CTX, DECODE_STEPS, LAYOUT_CASES,
                                SSM_CACHE, SSM_STEPS, arctic_config, decode_config, decode_run,
                                layout_config, ssm_case)
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.train import step as jstep

from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_lm_params
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import lm as tlm
from repro_torch.serve.cv_engine import generate
from repro_torch.train import step as tstep

HERE = os.path.dirname(os.path.abspath(__file__))
JOB_TIMEOUT_S = 300
B, S = 4, 32
LOGITS_TOL, GRAD_TOL = 1e-4, 1e-3
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 32, 8, 1e-3  # the job's
LAYOUT_B, LAYOUT_S, LAYOUT_T = 8, 32, 16  # the layout cases' batch, sequence, context
# layout cases JAX runs unsharded (one device): the same function, a
# shorter compile; a MoE case's aux loss would change with the sharding
JAX_WHOLE = ("zamba2 ssm_heads",)

JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map
from repro.launch.mesh import make_mesh
from repro.configs import reduced_config
from repro.data.synthetic import TokenStream
from repro.optim.compression import compressed_psum, bf16_psum
from repro.train import step as step_mod
out = {}
mesh = make_mesh((8,), ("data",))
g = jnp.asarray(np.load(%(g)r))
def body(gl, rl):
    return compressed_psum(gl, rl, "data")
mean, res = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")))(g, jnp.zeros_like(g))
out["psum_mean"], out["psum_residuals"] = np.asarray(mean), np.asarray(res)
bf = shard_map(lambda gl: bf16_psum(gl, "data"), mesh=mesh, in_specs=P("data"),
               out_specs=P("data"))(g)
out["bf16_mean"] = np.asarray(bf)
mesh = make_mesh((4, 2), ("data", "model"))
cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
from repro.models import lm
from repro.optim import adamw_init
params = jax.jit(lambda k: lm.init_params(k, cfg))(jax.random.key(0))
state = {"params": params, "opt": adamw_init(params), "step": jnp.zeros((), jnp.int32)}
fn = jax.jit(step_mod.make_train_step(cfg, mesh, peak_lr=%(lr)r, warmup=1))
stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=%(seq)d, global_batch=%(batch)d)
with mesh:
    for i in range(2):
        state, m = fn(state, stream.batch_at(i))
        out[f"loss{i}"] = np.asarray(m["loss"])
flat = jax.tree_util.tree_flatten_with_path(state["params"])[0]
for kp, v in flat:
    out["p." + ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)] = np.asarray(v)
np.savez(%(out)r, **out)
print("JAX_SIDE_OK")
"""

# JAX's sharded forward and gradients of deepseek and the layout cases, and the
# layout cases' two steps: a second subprocess, beside `JAX_SIDE`, and a third
# for the `JAX_WHOLE` cases and arctic's Adafactor steps (``deepseek`` None),
# so that the three take about as long
JAX_LAYOUT = """
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.configs import reduced_config
from repro.models import lm
from repro.optim import adamw_init
from repro.sharding import rules
from repro.train import step as step_mod
out = {}
mesh = make_mesh((4, 2), ("data", "model"))
one = make_mesh((1, 1), ("data", "model"))
JAX_WHOLE = %(whole)r
def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]
def sharded(cfg, params, batch, tag, mesh=mesh):
    hint = rules.make_hint(mesh, cfg)
    def both(p, b):
        return (lm.forward(p, cfg, b, hint=hint)[0],
                jax.grad(lambda q: step_mod.loss_fn(q, cfg, b, hint=hint)[0])(p))
    with mesh:
        logits, grads = jax.jit(both)(params, batch)
    out[tag + ":logits"] = np.asarray(logits)
    for i, g in enumerate(leaves(grads)):
        out[f"{tag}:grad{i}"] = g
if %(deepseek)r is not None:
    ds = np.load(%(deepseek)r)
    cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
    sharded(cfg, jax.jit(lambda k: lm.init_params(k, cfg))(jax.random.key(0)),
            {k: jnp.asarray(ds[k]) for k in ("tokens", "labels")}, "deepseek")
for tag, (arch, kw, _) in %(cases)r.items():
    cfg = reduced_config(arch).replace(dtype="float32", **kw)
    z = np.load(%(layout)r %% tag.replace(" ", "_"))
    shapes = jax.eval_shape(lambda k: lm.init_params(k, cfg), jax.random.key(0))
    n = len(jax.tree.leaves(shapes))
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(z[f"param{i}"]) for i in range(n)])
    def batch_of(pre):
        return {k[len(pre):]: jnp.asarray(z[k]) for k in z.files if k.startswith(pre)}
    m = one if tag in JAX_WHOLE else mesh
    sharded(cfg, params, batch_of("b."), tag, m)
    state = {"params": params, "opt": adamw_init(params), "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(step_mod.make_train_step(cfg, m, peak_lr=%(lr)r, warmup=1))
    with m:
        for i in range(2):
            state, m = fn(state, batch_of(f"s{i}."))
            out[f"{tag}:loss{i}"] = np.asarray(m["loss"])
    for i, v in enumerate(leaves(state["params"])):
        out[f"{tag}:param{i}"] = v
if %(arctic)r is not None:
    import dataclasses
    from repro.data.synthetic import TokenStream
    from repro.optim import adafactor_init
    cfg = reduced_config("arctic-480b").replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, aux_loss_weight=0.0))
    z = np.load(%(arctic)r)
    shapes = jax.eval_shape(lambda k: lm.init_params(k, cfg), jax.random.key(0))
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(z[f"param{i}"]) for i in range(len(z.files))])
    state = {"params": params, "opt": adafactor_init(params), "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(step_mod.make_train_step(cfg, one, optimizer="adafactor", peak_lr=%(lr)r,
                                          warmup=1))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=%(seq)d, global_batch=%(batch)d)
    with one:
        for i in range(2):
            state, m = fn(state, stream.batch_at(i))
            out[f"arctic:loss{i}"] = np.asarray(m["loss"])
            out[f"arctic:grad_norm{i}"] = np.asarray(m["grad_norm"])
    for i, v in enumerate(leaves(state["params"])):
        out[f"arctic:param{i}"] = v
np.savez(%(out)r, **out)
print("JAX_LAYOUT_OK")
"""


def _layout_inputs(tag: str, d: str, seed: int):
    """A layout case's JAX parameters (JAX's init, reduced qwen2-72b's q, k
    and v biases drawn at random, as JAX inits them to zero), its forward
    batch and two train batches: the port's model, the batches as tensors,
    and the same in an npz for JAX's side."""
    cfg_j = layout_config(jax_reduced_config, tag)
    cfg = layout_config(reduced_config, tag)
    params = jax.jit(lambda k: jlm.init_params(k, cfg_j))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    if cfg.qkv_bias:
        params = jax.tree_util.tree_map_with_path(
            lambda kp, x: jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
            if str(getattr(kp[-1], "key", "")) in ("b_q", "b_k", "b_v") else x, params)

    def batch():
        b = {"tokens": rng.integers(0, cfg.vocab_size, (LAYOUT_B, LAYOUT_S)),
             "labels": rng.integers(0, cfg.vocab_size, (LAYOUT_B, LAYOUT_S))}
        if cfg.encdec:
            b["audio_frames"] = rng.standard_normal(
                (LAYOUT_B, LAYOUT_T, cfg.d_model)).astype(np.float32)
        return b

    batches = [batch() for _ in range(3)]
    z = {f"param{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    for pre, b in zip(("b.", "s0.", "s1."), batches):
        z |= {pre + k: v for k, v in b.items()}
    np.savez(os.path.join(d, f"layout_{tag.replace(' ', '_')}.npz"), **z)
    model = from_jax_lm_params(params, cfg, device="cpu")
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    return params, model, {"state": model.state_dict(), "batch": tb[0], "steps": tb[1:]}


def _decode_inputs(tag: str, seed: int):
    """A decode case's JAX parameters (every leaf of JAX's tree drawn from
    N(0, 0.1^2) with numpy: a decode's parity needs the same weights on
    both sides, not JAX's initializers, and drawing them this way skips a
    compile of `init_params` a config), prompts, teacher-forced tokens and
    context input (seamless: `DECODE_CTX` frames): the JAX tree and the
    port's case."""
    cfg_j = decode_config(jax_reduced_config, tag)
    cfg = decode_config(reduced_config, tag)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, cfg_j), jax.random.key(seed))
    params = jax.tree.map(
        lambda x: jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype), shapes)
    S = DECODE_CASES[tag][2]
    case = {"prompts": torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE_B, S))),
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE_B, DECODE_STEPS))),
            "state": from_jax_lm_params(params, cfg, device="cpu").state_dict()}
    if cfg.encdec:
        case["extras"] = {"audio_frames": torch.from_numpy(
            rng.standard_normal((DECODE_B, DECODE_CTX, cfg.d_model)).astype(np.float32))}
    return params, case


def _arctic_inputs(d: str):
    """Reduced arctic-480b's parameters for its Adafactor steps (`arctic_config`),
    every leaf of JAX's tree drawn from N(0, 0.1^2) with numpy, as
    `_decode_inputs` draws them: the JAX tree, written to an npz for JAX's
    side, and the port's state."""
    cfg_j = arctic_config(jax_reduced_config)
    rng = np.random.default_rng(21)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, cfg_j), jax.random.key(0))
    params = jax.tree.map(
        lambda x: jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype), shapes)
    np.savez(os.path.join(d, "arctic.npz"),
             **{f"param{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))})
    return params, from_jax_lm_params(params, arctic_config(reduced_config),
                                      device="cpu").state_dict()


def _jax_steps(params, jax_side: dict, tag: str, cfg) -> dict:
    """JAX's two train steps ``<tag>:loss<i>``, ``<tag>:grad_norm<i>`` and
    ``<tag>:param<i>`` in `_single_train`'s form, with the parameters as
    the port's named tensors (`params`: the JAX tree they started from)."""
    n = len(jax.tree.leaves(params))
    tree = jax.tree.unflatten(jax.tree.structure(params),
                              [jnp.asarray(jax_side[f"{tag}:param{i}"]) for i in range(n)])
    return {"metrics": [{k: float(jax_side[f"{tag}:{k}{i}"]) for k in ("loss", "grad_norm")}
                        for i in range(2)],
            "params": {k: v.detach() for k, v in
                       from_jax_lm_params(tree, cfg, device="cpu").named_parameters()}}


def _single_decode(tag: str, params, case: dict) -> dict:
    """A decode case in one process (`decode_run`), and JAX's
    `lm.decode_step` from the same adopted cache with the same tokens."""
    cfg_j = decode_config(jax_reduced_config, tag)
    cfg = decode_config(reduced_config, tag)
    model = tlm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    out = decode_run(model, cfg, tag, case)
    adopted = out.pop("adopted")
    cache = {part: [{n: jnp.asarray(t.numpy()) for n, t in g.items()} for g in adopted[part]]
             for part in ("groups", "shared")} | {"pos": jnp.asarray(adopted["pos"], jnp.int32)}
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, cfg_j, t, c))
    logits = []
    for t in range(DECODE_STEPS):
        lg, cache = step(params, jnp.asarray(case["tokens"][:, t : t + 1].numpy(), jnp.int32),
                         cache)
        logits.append(np.asarray(lg))
    out["jax"] = torch.from_numpy(np.stack(logits))
    return out


def _single_layout(tag: str, case: dict) -> dict:
    """A layout case in one process: logits, gradients, two AdamW steps and
    (gemma's "tp" case) `generate`."""
    cfg = layout_config(reduced_config, tag)
    batch = case["batch"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")} or None
    model = tlm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    tlm.make_trainable(model)
    logits, _ = tlm.forward(model, batch["tokens"], extras=extras)
    loss, _ = tstep.loss_fn(model, batch)
    loss.backward()
    out = {"logits": logits.detach(),
           "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}}
    if tag == "gemma tp":
        with torch.no_grad():
            out["generate"] = generate(model, batch["tokens"][:, :12], steps=6, device="cpu")
    if cfg.ssm is not None:
        out["decode"] = decode_run(model, cfg, tag, ssm_case(batch), cache_len=SSM_CACHE)
    model = tlm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    state = tstep.init_state(cfg, device="cpu", model=model)
    fn = tstep.make_train_step(cfg, peak_lr=TRAIN_LR, warmup=1)
    metrics = []
    for b in case["steps"]:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    out["steps"] = {"metrics": metrics, "params": {
        n: p.detach().clone() for n, p in state["model"].named_parameters()}}
    return out


def _jax_deepseek():
    cfg_j = jax_reduced_config("deepseek-v3-671b").replace(dtype="float32")
    # jitted, as the JAX side draws them (eager dispatch takes ~10 s)
    return jax.jit(lambda k: jlm.init_params(k, cfg_j))(jax.random.key(0)), cfg_j


def _port_from_jax(params):
    cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
    return tlm.make_trainable(from_jax_lm_params(params, cfg, device="cpu")), cfg


def _single_train(cfg, *, optimizer="adamw", model=None, accum=None):
    state = tstep.init_state(cfg, optimizer=optimizer, device="cpu", model=model,
                             generator=torch.Generator().manual_seed(0))
    kw = dict(optimizer=optimizer, peak_lr=TRAIN_LR, warmup=1)
    fn = (tstep.make_accum_train_step(cfg, accum=accum, **kw) if accum
          else tstep.make_train_step(cfg, **kw))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    metrics = []
    for i in range(2):
        state, m = fn(state, stream.batch_at(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {n: p.detach().clone() for n, p in state["model"].named_parameters()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharding"))
    params_j, cfg_j = _jax_deepseek()
    model, cfg = _port_from_jax(params_j)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    g = rng.standard_normal((8, 64)).astype(np.float32)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 12)))
    np.save(os.path.join(d, "g.npy"), g)
    np.savez(os.path.join(d, "deepseek_batch.npz"), tokens=tokens.numpy(), labels=labels.numpy())
    layout = {tag: _layout_inputs(tag, d, seed) for seed, tag in enumerate(LAYOUT_CASES, 1)}
    decode = {tag: _decode_inputs(tag, seed) for seed, tag in enumerate(DECODE_CASES, 11)}
    arctic_j, arctic = _arctic_inputs(d)
    torch.save({"deepseek": model.state_dict(), "arctic": arctic, "tokens": tokens,
                "labels": labels,
                "g": torch.from_numpy(g), "prompts": prompts,
                "layout": {tag: case for tag, (_, _, case) in layout.items()},
                "decode": {tag: case for tag, (_, case) in decode.items()}},
               os.path.join(d, "inputs.pt"))
    job = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharding_job.py"), d],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jax_out = os.path.join(d, "jax.npz")
    jax_layout_out = [os.path.join(d, f"jax_layout{i}.npz") for i in range(2)]
    pool = ThreadPoolExecutor(3)
    try:
        jax_side = pool.submit(run_subprocess, JAX_SIDE % dict(
            g=os.path.join(d, "g.npy"), out=jax_out, lr=TRAIN_LR, seq=TRAIN_SEQ,
            batch=TRAIN_BATCH), timeout=JOB_TIMEOUT_S)
        jax_layout = [pool.submit(run_subprocess, JAX_LAYOUT % dict(
            out=out, lr=TRAIN_LR, deepseek=ds, layout=os.path.join(d, "layout_%s.npz"),
            cases={t: c for t, c in LAYOUT_CASES.items() if (t in JAX_WHOLE) == whole},
            whole=JAX_WHOLE, arctic=os.path.join(d, "arctic.npz") if whole else None,
            seq=TRAIN_SEQ, batch=TRAIN_BATCH), timeout=JOB_TIMEOUT_S)
            for out, ds, whole in ((jax_layout_out[0], os.path.join(d, "deepseek_batch.npz"),
                                    False), (jax_layout_out[1], None, True))]
        ref = {}
        # the single-process port and JAX, unsharded
        logits, _ = tlm.forward(model, tokens)
        loss, metrics = tstep.loss_fn(model, {"tokens": tokens, "labels": labels})
        loss.backward()
        ref["port"] = {"logits": logits.detach(), "loss": float(loss.detach()),
                       "moe_aux": float(metrics["moe_aux"]),
                       "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                                 if p.grad is not None}}
        batch_j = {"tokens": jnp.asarray(tokens.numpy()), "labels": jnp.asarray(labels.numpy())}
        logits_j, _ = jlm.forward(params_j, cfg_j, batch_j)
        grads_j = jax.jit(jax.grad(lambda p: jstep.loss_fn(p, cfg_j, batch_j)[0]))(params_j)
        ref["jax"] = {"logits": np.asarray(logits_j),
                      "grads": tlm.make_trainable(from_jax_lm_params(grads_j, cfg, device="cpu"))}
        gemma = reduced_config("gemma-7b").replace(dtype="float32")
        for tag, kw in (("gemma adamw", {}), ("gemma adafactor", {"optimizer": "adafactor"}),
                        ("gemma accum", {"accum": 2})):
            ref[tag] = _single_train(gemma, **kw)
        ref["deepseek adamw"] = _single_train(cfg, model=_port_from_jax(params_j)[0])
        from repro_torch.train import loop

        _, h = loop.train(gemma, TokenStream(vocab_size=gemma.vocab_size, seq_len=TRAIN_SEQ,
                                             global_batch=TRAIN_BATCH),
                          steps=3, peak_lr=TRAIN_LR, warmup=1, log_every=1, log=lambda m: None,
                          device="cpu")
        ref["loop"] = [x["loss"] for x in h]
        ref["generate"] = generate(_port_from_jax(params_j)[0], prompts, steps=6, device="cpu")
        for tag, (params, _, case) in layout.items():
            ref[tag] = _single_layout(tag, case)
            ref[tag]["jax params"] = params
        ref["decode"] = {tag: _single_decode(tag, params, case)
                         for tag, (params, case) in decode.items()}
        assert "JAX_SIDE_OK" in jax_side.result()
        assert all("JAX_LAYOUT_OK" in f.result() for f in jax_layout)
        ref["jax sharded"] = {**np.load(jax_out), **np.load(jax_layout_out[0]),
                              **np.load(jax_layout_out[1])}
        ref["arctic adafactor"] = _jax_steps(arctic_j, ref["jax sharded"], "arctic",
                                             arctic_config(reduced_config))
        log, _ = job.communicate(timeout=JOB_TIMEOUT_S)
    finally:
        job.kill()
        pool.shutdown(wait=False)
    assert job.returncode == 0, log[-4000:]
    return torch.load(os.path.join(d, "out.pt")), ref, g


def test_the_all_to_all_path_is_taken(run):
    out, _, _ = run
    assert out["plan"] == {"a2a_axes": ("data", "model"), "L": B // 4 * S // 2,
                           "C": out["plan"]["C"], "n_ep": 8}


def test_sharded_forward_and_gradients(run):
    out, ref, _ = run
    for want in (ref["port"]["logits"], torch.from_numpy(ref["jax"]["logits"])):
        assert float((out["logits"] - want).abs().max()) < LOGITS_TOL
    port_g = ref["port"]["grads"]
    jax_g = dict(ref["jax"]["grads"].named_parameters())
    assert set(out["grads"]) == set(port_g)
    for name, g in out["grads"].items():
        assert float((g - port_g[name]).abs().max()) < GRAD_TOL, name
        assert float((g - jax_g[name].detach()).abs().max()) < GRAD_TOL, name
    # the loss differs only by the aux loss, per shard here (JAX's a2a path)
    aux_w = reduced_config("deepseek-v3-671b").moe.aux_loss_weight
    d_aux = aux_w * (out["moe_aux"] - ref["port"]["moe_aux"])
    assert abs(out["loss"] - ref["port"]["loss"] - d_aux) < 1e-6


def test_compressed_psum_over_8_ranks(run):
    out, ref, g = run
    jax_side = ref["jax sharded"]
    scale = float(np.abs(g).max() / 127.0)
    assert float((out["psum_mean"] - torch.from_numpy(g.mean(0))).abs().max()) <= scale
    # JAX's shard_map holds one row a device: every row the mean
    np.testing.assert_allclose(out["psum_mean"].numpy(), jax_side["psum_mean"][0], atol=1e-6)
    np.testing.assert_allclose(out["psum_residuals"].numpy().reshape(8, 64),
                               jax_side["psum_residuals"], atol=1e-6)
    # bf16_psum: the 8 inputs and the 7 partial sums each rounded to bfloat16
    # (2^-9 relative), so the mean within 2^-9 * sum |g| of the true one;
    # the packages within twice that of each other (gloo and XLA sum in
    # other orders)
    bound = 2.0**-9 * np.abs(g).sum(0)
    assert (np.abs(out["bf16_mean"].numpy() - g.mean(0)) <= bound).all()
    assert (np.abs(out["bf16_mean"].numpy() - jax_side["bf16_mean"][0]) <= 2 * bound).all()
    # make_compressed_allreduce over "data": the mean over each model column
    cols = g.reshape(4, 2, 64)
    for r in range(8):
        want = cols[:, r % 2].mean(0)
        assert float(np.abs(out["data_means"][r].numpy() - want).max()) <= np.abs(
            cols[:, r % 2]).max() / 127.0


@pytest.mark.parametrize("tag", ["gemma adamw", "gemma adafactor", "gemma accum",
                                 "arctic adafactor"])
def test_two_sharded_train_steps(run, tag):
    out, ref, _ = run
    got, want = out[tag], ref[tag]
    for a, b in zip(got["metrics"], want["metrics"]):
        assert abs(a["loss"] - b["loss"]) < LOSS_TOL, (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-4 * b["grad_norm"]
    for name, p in want["params"].items():
        assert float((got["params"][name] - p).abs().max()) < PARAM_TOL, name


def test_two_sharded_moe_train_steps_against_jax(run):
    out, ref, _ = run
    got, jax_side = out["deepseek adamw"], ref["jax sharded"]
    for i in range(2):
        assert abs(got["metrics"][i]["loss"] - float(jax_side[f"loss{i}"])) < LOSS_TOL
    leaves = {lf.name: lf for lf in tlm.param_leaves(
        tlm.LM(reduced_config("deepseek-v3-671b"), device="meta"))}
    names = {n: p for n, p in got["params"].items()}
    start = 0
    for key, arr in jax_side.items():
        if not key.startswith("p."):
            continue
        leaf = key[2:]
        port = [n for n in names if _leaf_of(n) == leaf]
        stacked = torch.stack([names[n] for n in port]) if leaves[leaf].stacked else names[port[0]]
        assert float((stacked - torch.from_numpy(arr)).abs().max()) < PARAM_TOL, leaf
        start += 1
    assert start == len(leaves)
    # router_bias moved by the aux-free rule, as in the single-process steps
    rb = [n for n in names if n.endswith("router_bias")]
    assert rb and all(float(names[n].abs().max()) > 0 for n in rb)
    single = ref["deepseek adamw"]
    for n in rb:
        assert torch.equal(names[n], single["params"][n])
    # against the single-process steps: the first loss by the aux share only
    m0, s0 = got["metrics"][0], single["metrics"][0]
    assert abs(m0["nll"] - s0["nll"]) < LOSS_TOL
    assert abs(m0["loss"] - s0["loss"]) < 1e-3


@pytest.mark.parametrize("tag", ["gemma adamw", "gemma adafactor", "deepseek adamw",
                                 "arctic adafactor"])
def test_train_state_lies_in_zero1_layout(run, tag):
    """Every rank's optimizer state: the local shapes of `opt_state_specs`,
    `opt_bytes_zero1` bytes, and a leaf split over an axis its parameter
    does not use."""
    out, _, _ = run
    assert out[tag]["zero1"] == {"shapes": True, "bytes": True, "extra axis": True}


def _leaf_of(param_name: str) -> str:
    """A parameter's leaf in JAX's tree, for reduced deepseek-v3-671b
    (layer 0 the ``mla`` run, layers 1-2 the ``mla_moe`` run)."""
    parts = param_name.split(".")
    if parts[0] != "blocks":
        return param_name
    run_ = 0 if int(parts[1]) == 0 else 1
    return ".".join(["groups", str(run_), *parts[2:]])


def test_elastic_restore_onto_another_mesh(run):
    out, ref, _ = run
    e = out["elastic"]
    assert e["step"] == 7 and e["mesh"] == (2, 4)
    assert e["placements"] == ["S(1)", "S(0)"] or e["placements"] == [
        "Shard(dim=1)", "Shard(dim=0)"]
    assert torch.equal(e["value"], torch.arange(64, dtype=torch.float32).reshape(8, 8))
    assert out["state_remesh"] == {"equal": True, "step": 2, "mesh": (2, 4)}
    # the loop resumed onto (2, 4) from (4, 2)'s checkpoint: the losses of an
    # unbroken single-process run, rank 0 logging
    loop_out = out["loop"]
    assert loop_out["steps"] == [0, 1, 2]
    assert loop_out["logged"][0] == "[train] resumed from step 2"
    for a, b in zip(loop_out["losses"], ref["loop"]):
        assert abs(a - b) < LOSS_TOL, (loop_out["losses"], ref["loop"])


def test_a_spec_out_of_the_mesh_order_gathers_whole(run):
    """JAX's ("model", "data") on one dimension of the (4, 2) mesh: rank 0
    (data 0, model 0) holds block 0 of 8, and `comm.spec_full` rebuilds
    the tensor on every rank."""
    out, _, _ = run
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    assert torch.equal(out["spec_full"]["block"], w[:1]) and out["spec_full"]["whole"]


def test_constrain_and_generate(run):
    out, ref, _ = run
    assert out["constrain"][0] == [str(p) for p in out["constrain"][0]]
    odd, even = out["constrain"]
    assert all("Replicate" in p or p == "R" for p in odd)
    assert all("Shard" in p or p.startswith("S(") for p in even)
    assert torch.equal(out["generate"], ref["generate"])


def _jax_tree(ref_tag: dict, jax_side: dict, key: str, tag: str):
    """JAX's leaves ``<tag>:<key><i>`` in the tree of the case's parameters,
    as the port's named tensors."""
    params = ref_tag["jax params"]
    n = len(jax.tree.leaves(params))
    tree = jax.tree.unflatten(jax.tree.structure(params),
                              [jnp.asarray(jax_side[f"{tag}:{key}{i}"]) for i in range(n)])
    cfg = layout_config(reduced_config, tag)
    return {k: v.detach() for k, v in
            from_jax_lm_params(tree, cfg, device="cpu").named_parameters()}


@pytest.mark.parametrize("tag", list(LAYOUT_CASES))
def test_layout_case_takes_its_layout(run, tag):
    out, _, _ = run
    assert out[tag]["layout"] == LAYOUT_CASES[tag][2]


@pytest.mark.parametrize("tag", list(LAYOUT_CASES))
def test_layout_forward_and_gradients(run, tag):
    out, ref, _ = run
    got, single, jax_side = out[tag], ref[tag], ref["jax sharded"]
    for want in (single["logits"], torch.from_numpy(jax_side[f"{tag}:logits"])):
        assert float((got["logits"] - want).abs().max()) < LOGITS_TOL
    jax_g = _jax_tree(single, jax_side, "grad", tag)
    assert set(got["grads"]) == set(single["grads"])
    for name, g in got["grads"].items():
        assert float((g - single["grads"][name]).abs().max()) < GRAD_TOL, name
        assert float((g - jax_g[name]).abs().max()) < GRAD_TOL, name


@pytest.mark.parametrize("tag", list(LAYOUT_CASES))
def test_layout_two_train_steps(run, tag):
    out, ref, _ = run
    got, single, jax_side = out[tag]["steps"], ref[tag]["steps"], ref["jax sharded"]
    for i, (a, b) in enumerate(zip(got["metrics"], single["metrics"])):
        assert abs(a["loss"] - b["loss"]) < LOSS_TOL, (a, b)
        assert abs(a["loss"] - float(jax_side[f"{tag}:loss{i}"])) < LOSS_TOL
    jax_p = _jax_tree(ref[tag], jax_side, "param", tag)
    for name, p in single["params"].items():
        assert float((got["params"][name] - p).abs().max()) < PARAM_TOL, name
        assert float((got["params"][name] - jax_p[name]).abs().max()) < PARAM_TOL, name


def test_layout_tp_generate_decodes_over_the_model_axis(run):
    out, ref, _ = run
    assert torch.equal(out["gemma tp"]["generate"], ref["gemma tp"]["generate"])


def test_ssm_heads_split_over_the_model_axis(run):
    """Reduced zamba2-2.7b: every Mamba2 layer of the forward scans 2 of its
    4 SSD heads on a rank (no (B, S, H, P) tensor over all H), and the
    mixer reads ``out_proj`` as its rank's rows."""
    out, _, _ = run
    got = out["zamba2 ssm_heads"]["ssm"]
    cfg = layout_config(reduced_config, "zamba2 ssm_heads")
    assert got["split"] and cfg.ssm.n_heads == 4
    assert got["heads"] == [2] * sum(1 for k in cfg.block_list if k == "mamba")
    assert got["out_proj"] == (cfg.ssm.d_inner // 2, cfg.d_model)


def test_ssm_heads_prefill_decodes_like_the_single_process(run):
    """The zamba2 case's prefill under the split (the ranks' states
    gathered), adopted and decoded `SSM_STEPS` steps teacher-forced: every
    step's logits within 1e-4 of the single process."""
    out, ref, _ = run
    got, want = out["zamba2 ssm_heads"]["decode"], ref["zamba2 ssm_heads"]["decode"]
    assert got["logits"].shape[0] == SSM_STEPS
    assert float((got["logits"] - want["logits"]).abs().max()) < LOGITS_TOL


@pytest.mark.parametrize("tag", list(DECODE_CASES))
def test_decode_over_the_model_axis(run, tag):
    """Every teacher-forced step's logits, every row's, against the single
    process and JAX's `decode_step` on the same cache."""
    out, ref, _ = run
    got, want = out["decode"][tag], ref["decode"][tag]
    assert got["layout"] == DECODE_CASES[tag][4]
    cfg = decode_config(reduced_config, tag)
    assert got["logits"].shape == (DECODE_STEPS, DECODE_B, cfg.vocab_size)
    for step in range(DECODE_STEPS):
        for ref_logits in (want["logits"], want["jax"]):
            err = float((got["logits"][step] - ref_logits[step]).abs().max())
            assert err < LOGITS_TOL, (step, err)


def _global_slots(cfg, name: str, T: int) -> int | None:
    """The global slots of a decode case's cache entry; None for a state."""
    if name in ("xk", "xv"):
        return DECODE_CTX
    if name.startswith("shared."):
        return min(T, tlm.SHARED_ATTN_SLOTS)
    if name not in ("k", "v", "ckv", "kr"):
        return None
    return min(T, cfg.window) if cfg.window and cfg.mla is None else T


@pytest.mark.parametrize("tag", list(DECODE_CASES))
def test_decode_cache_holds_the_rank_slots(run, tag):
    """A rank's cache: its 2 of the 8 rows, and T / 2 slots of an entry whose
    T the model axis divides (`rules.cache_specs`), else all T; a
    recurrent state whole but for its rows."""
    out, ref, _ = run
    cfg = decode_config(reduced_config, tag)
    T = DECODE_CASES[tag][3]
    one = ref["decode"][tag]["shapes"]
    for name, shape in out["decode"][tag]["shapes"].items():
        full = _global_slots(cfg, name, T)
        rows = 0 if name.startswith("shared.") else 1
        assert shape[rows] == DECODE_B // 4, name
        if full is None:
            assert shape[2:] == one[name][2:], name
        else:
            t = shape[rows + 1]
            assert t == (full // 2 if full % 2 == 0 else full), (name, shape, full)


def test_decode_cases_split_and_prune_and_empty_a_rank(run):
    """The cases cover a cache split over "model", one it prunes (whole),
    a ring wrapped over both ranks, and steps where model rank 1's slots
    hold no valid position (whose logits agree, above)."""
    out, _, _ = run
    shapes = {tag: out["decode"][tag]["shapes"] for tag in DECODE_CASES}
    assert shapes["gemma tp"]["k"][2] == 12 and shapes["arctic 6 experts"]["k"][2] == 19
    assert shapes["seamless tp"]["xk"][2] == DECODE_CTX // 2
    assert shapes["seamless tp"]["k"][2] == 21
    assert shapes["zamba2"]["shared.k"][1] == 10
    S, T = DECODE_CASES["gemma tp"][2:4]
    for step in range(T // 2 - S):  # positions S .. T / 2 - 1
        _, valid = tlm.ring_positions(S + step, T)
        assert not bool(valid[T // 2:].any())
    S, T = DECODE_CASES["danube ring"][2:4]
    pos, _ = tlm.ring_positions(S, 32)  # the window's ring: 32 slots
    assert int(pos[:16].max()) >= 32 and int(pos[16:].max()) < 32 <= S


def test_deepseek_sharded_forward_and_gradients_against_jax_sharded(run):
    """Reduced deepseek-v3-671b's sequence-parallel MLA and its all-to-all
    MoE on the sequence slices against JAX's sharded run, which takes the
    aux loss per shard too."""
    out, ref, _ = run
    jax_side = ref["jax sharded"]
    assert float((out["logits"] - torch.from_numpy(jax_side["deepseek:logits"])).abs().max()) \
        < LOGITS_TOL
    params_j, _ = _jax_deepseek()
    n = len(jax.tree.leaves(params_j))
    tree = jax.tree.unflatten(jax.tree.structure(params_j),
                              [jnp.asarray(jax_side[f"deepseek:grad{i}"]) for i in range(n)])
    jax_g = dict(_port_from_jax(tree)[0].named_parameters())
    for name, g in out["grads"].items():
        assert float((g - jax_g[name].detach()).abs().max()) < GRAD_TOL, name
