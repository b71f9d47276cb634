"""The port's dry run (`repro_torch.launch.dryrun`) against JAX's
(`repro.launch.dryrun`): the shape cells, which (arch, shape) cells run,
the parameter counts, the inputs, the decode caches' bytes and the ZeRO-1
optimizer-state specs, all exact; a skip cell through the command line;
and a meta trace against the same step run on CPU tensors.

`repro.launch.dryrun` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so JAX's side runs once, in a subprocess (`conftest.run_subprocess`),
and hands its numbers back as JSON.  No full-size cell is traced here: the
port builds the full configs on the meta device only to count them.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import run_subprocess
from repro.configs import get_config as jax_get_config
from repro.configs.gemma_7b import FULL_ATTN_SKIP as JAX_FULL_ATTN_SKIP
from repro.configs.registry import cell_status as jax_cell_status
from repro.models.config import SHAPES as JAX_SHAPES

from repro_torch.configs import ARCHS, cell_status, get_config, reduced_config
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.roofline.cost import CostMode
from repro_torch.sharding import rules
from repro_torch.train.step import jax_path

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
DECODE_CELLS = [(a, s) for a, s in CELLS
                if SHAPES[s].kind == "decode" and not cell_status(get_config(a), s)]
OPT_CASES = [(a, m) for a in ("gemma-7b", "deepseek-v3-671b") for m in ("pod", "multipod")]
MESH_SHAPES = {"pod": ((16, 16), ("data", "model")),
               "multipod": ((2, 16, 16), ("pod", "data", "model"))}

# JAX's side: counts, inputs, cache bytes and optimizer specs, as JSON
JAX_SIDE = r"""
import json, math
from functools import partial
import jax
from jax.sharding import PartitionSpec as P
from repro.launch import dryrun as D
from repro.configs import ARCHS, get_config
from repro.configs.registry import cell_status
from repro.models import lm
from repro.models.config import SHAPES
from repro.sharding import rules
from repro.launch.mesh import make_production_mesh

def spec(s):
    return [list(a) if isinstance(a, tuple) and len(a) > 1
            else (a[0] if isinstance(a, tuple) else a) for a in s]

def nbytes(tree):
    return sum(math.prod(l.shape) * l.dtype.itemsize for l in jax.tree.leaves(tree))

key = jax.random.key(0)
out = {"params": {}, "inputs": {}, "cache": {}, "opt": {}}
shapes = {}
for a in ARCHS:
    cfg = get_config(a)
    ps = jax.eval_shape(partial(lm.init_params, cfg=cfg), key)
    shapes[a] = ps
    out["params"][a] = [D.count_params(ps, False, cfg), D.count_params(ps, True, cfg)]
    for s, sh in SHAPES.items():
        out["inputs"][f"{a}:{s}"] = {k: [list(v.shape), str(v.dtype)]
                                      for k, v in D.input_specs(cfg, s).items()}
        if sh.kind == "decode" and not cell_status(cfg, s):
            ctx_len = None
            if cfg.encdec or any(k == "xattn" for k, _ in cfg.blocks):
                ctx_len = 4096 if cfg.encdec else cfg.n_image_tokens
            cs = jax.eval_shape(lambda: lm.init_cache(cfg, sh.global_batch, sh.seq_len,
                                                      ctx_len=ctx_len))
            out["cache"][f"{a}:{s}"] = {"total": nbytes(cs), "ctx": nbytes(cs.get("ctx", [])),
                                        "pos": nbytes(cs["pos"])}
for a, opt in (("gemma-7b", "adamw"), ("deepseek-v3-671b", "adafactor")):
    cfg = get_config(a)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        pspecs = rules.param_specs(shapes[a], cfg, mesh)
        ospecs = D.opt_state_specs(None, shapes[a], pspecs, mesh, opt)
        flat, _ = jax.tree_util.tree_flatten_with_path(ospecs, is_leaf=lambda x: isinstance(x, P))
        out["opt"][f"{a}:{'multipod' if mp else 'pod'}"] = {
            jax.tree_util.keystr(p): spec(s) for p, s in flat}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    return json.loads(run_subprocess(JAX_SIDE, devices=512, timeout=600).strip().splitlines()[-1])


@pytest.fixture(scope="module")
def leaves():
    """`lm.param_leaves` of each full config, built on the meta device."""
    out = {}
    for a in ARCHS:
        m = lm.LM(get_config(a), device="meta", generator=torch.Generator())
        out[a] = (m, lm.param_leaves(m))
    return out


def _spec(s) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in s]


@pytest.mark.parametrize("name", list(JAX_SHAPES))
def test_shapes_are_jax_shapes(name):
    j, t = JAX_SHAPES[name], SHAPES[name]
    assert (t.name, t.seq_len, t.global_batch, t.kind, t.is_decode) == (
        j.name, j.seq_len, j.global_batch, j.kind, j.is_decode)
    assert list(SHAPES) == list(JAX_SHAPES)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_status_is_jax_cell_status(arch, shape):
    assert cell_status(get_config(arch), shape) == jax_cell_status(jax_get_config(arch), shape)


def test_seven_archs_skip_long_500k_with_jax_reasons():
    skipped = [(a, s) for a, s in CELLS if cell_status(get_config(a), s)]
    assert len(skipped) == 7 and {s for _, s in skipped} == {"long_500k"}
    assert cell_status(get_config("gemma-7b"), "long_500k") == JAX_FULL_ATTN_SKIP[0][1]
    for a in ARCHS:  # a reduced config keeps its arch's skips
        assert reduced_config(a).skip_shapes == get_config(a).skip_shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_is_jax_count(arch, jax_side, leaves):
    _, lv = leaves[arch]
    cfg = get_config(arch)
    got = [dryrun.count_params(lv, False, cfg), dryrun.count_params(lv, True, cfg)]
    assert got == jax_side["params"][arch]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_jax_input_specs(arch, shape, jax_side):
    got = {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
           for k, v in dryrun.input_specs(get_config(arch), shape).items()}
    assert got == jax_side["inputs"][f"{arch}:{shape}"]
    assert all(v.device.type == "meta" for v in dryrun.input_specs(get_config(arch), shape).values())


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_bytes_global_is_jax_but_the_stated_departures(arch, shape, jax_side):
    """Exact, but for two stated departures of `lm.init_cache`: the port
    keeps no ``ctx`` entry (the context itself, which JAX's decode never
    reads; only the cross-attention archs have it) and ``pos`` is a Python
    int, not a 4-byte int32 array."""
    cfg, sh = get_config(arch), SHAPES[shape]
    got = dryrun.tree_bytes(lm.init_cache(cfg, sh.global_batch, sh.seq_len,
                                          ctx_len=dryrun._ctx_len(cfg), device="meta"))
    j = jax_side["cache"][f"{arch}:{shape}"]
    assert j["pos"] == 4
    assert got == j["total"] - j["ctx"] - j["pos"]


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_cache_ctx_departure_is_the_context_input(arch, jax_side):
    """The one departure with bytes behind it: JAX's decode cache holds the
    context input, (B, ctx_len, d) in the weights' dtype."""
    cfg = get_config(arch)
    B = SHAPES["decode_32k"].global_batch
    ctx = dryrun._ctx_len(cfg)
    assert jax_side["cache"][f"{arch}:decode_32k"]["ctx"] == B * ctx * cfg.d_model * 2


@pytest.mark.parametrize("arch,mesh", OPT_CASES)
def test_opt_state_specs_are_jax_zero1(arch, mesh, jax_side, leaves):
    _, lv = leaves[arch]
    cfg = get_config(arch)
    opt = dryrun.OPTIMIZER.get(arch, "adamw")
    ms = rules.MeshShape(*MESH_SHAPES[mesh])
    specs = dryrun.opt_state_specs(lv, rules.param_specs(lv, cfg, ms), ms, opt)
    flat = {"['count']": _spec(specs["count"])}
    if opt == "adamw":
        flat |= {jax_path(k, n): _spec(s) for k in ("m", "v") for n, s in specs[k].items()}
    else:
        flat |= {jax_path("f", str(i), k): _spec(s)
                 for i, d in enumerate(specs["f"]) for k, s in d.items()}
    assert flat == jax_side["opt"][f"{arch}:{mesh}"]


def test_skip_cell_subprocess_writes_jax_reason(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
                           "gemma-7b:long_500k:pod", "--out", str(tmp_path)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads((tmp_path / "gemma-7b__long_500k__16x16.json").read_text())
    assert rec == {"arch": "gemma-7b", "shape": "long_500k", "mesh": "16x16", "status": "skip",
                   "reason": jax_cell_status(jax_get_config("gemma-7b"), "long_500k")}


# The meta trace counts what the same step counts on real tensors.  On the
# CPU a wrapper runs its plain version, so these archs' reduced configs
# reach no kernel (starcoder2's head dim 12; xlstm has no attention).
TRACE_CASES = [(a, k) for a in ("starcoder2-7b", "xlstm-125m")
               for k in ("train", "prefill", "decode")]


def _cpu_cost(cfg, sh) -> dict:
    """The step `trace_cell` traces, on CPU tensors of the same shapes."""
    from repro_torch.serve import cv_engine as engine
    from repro_torch.train import step as step_mod

    gen = torch.Generator().manual_seed(0)
    model = lm.LM(cfg, device="cpu", generator=gen)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             dryrun.input_specs(cfg, sh).items()}
    cm = CostMode()
    if sh.kind == "train":
        opt = dryrun.OPTIMIZER.get(cfg.name, "adamw")
        state = step_mod.init_state(cfg, optimizer=opt, model=model)
        fn = step_mod.make_train_step(cfg, optimizer=opt)
        with cm:
            fn(state, batch)
    elif sh.kind == "prefill":
        with torch.inference_mode(), cm:
            engine.make_prefill_step(cfg)(model, batch["tokens"])
    else:
        with torch.inference_mode():
            cache = lm.init_cache(cfg, sh.global_batch, sh.seq_len, device="cpu")
            with cm:
                engine.make_decode_step(cfg)(model, cache, batch["tokens"])
    return cm.summary()


@pytest.mark.parametrize("arch,kind", TRACE_CASES)
def test_meta_trace_counts_as_the_cpu_step(arch, kind):
    cfg = reduced_config(arch)
    sh = ShapeConfig(kind, 32, 2, kind)
    rec = dryrun.trace_cell(cfg, sh)
    want = _cpu_cost(cfg, sh)
    got = rec["cost"]
    assert got["by_kernel"] == want["by_kernel"] == {}
    assert (got["flops"], got["hbm_bytes"], got["n_ops"]) == (
        want["flops"], want["hbm_bytes"], want["n_ops"])
    assert got["flops"] > 0 and got["link_bytes"] == 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
