"""The port's roofline (`repro_torch.roofline`) against JAX's
(`repro.roofline`): the cost counter against `hlo_cost.analyze` on
`tests/test_hlo_cost.py`'s two functions and on a reduced gemma-7b train
step; traces over an 8-rank fake (4, 2) mesh, at both ranks of its first
"model" column, against one-rank traces of a rank's rows and against the
collectives the test derives from `sharding.rules.param_specs`, the
sequence-parallel layout (`sharding.rules.model_layout`) and the MoE
all-to-all plan; `analyze_cell`
against JAX's on synthetic records; the ring model; and the
`flash_attention` meta route.

The fake process group is process-wide, so the mesh traces run once a
traced rank, in subprocesses side by side, and hand their numbers back as
JSON.
"""

import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from repro.launch.mesh import make_host_mesh
from repro.roofline import analyze as jax_analyze
from repro.roofline.hlo_cost import _collective_traffic, analyze
from repro.configs import reduced_config as jax_reduced_config
from repro.train import step as jstep

from repro_torch.configs import reduced_config
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import counters
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models.config import ShapeConfig
from repro_torch.roofline import analyze as tanalyze
from repro_torch.roofline import collectives as coll
from repro_torch.roofline.cost import CostMode
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parents[1]

# -- the cost counter against JAX's walker -------------------------------------


def _mlp(w1, w2, x):
    return torch.mean((F.gelu(x @ w1, approximate="tanh") @ w2) ** 2)


def _mlp_scanned(w1, w2, x):
    h = x
    for _ in range(10):
        h = F.gelu(h @ w1, approximate="tanh") @ w2
    return torch.mean(h**2)


def _jax_mlp(w1, w2, x):
    return jnp.mean((jax.nn.gelu(x @ w1) @ w2) ** 2)


def _jax_mlp_scanned(w1, w2, x):
    def body(h, _):
        return jax.nn.gelu(h @ w1) @ w2, None

    h, _ = jax.lax.scan(body, x, None, length=10)
    return jnp.mean(h**2)


@pytest.mark.parametrize("fns", [(_mlp, _jax_mlp), (_mlp_scanned, _jax_mlp_scanned)],
                         ids=["mlp", "mlp_scanned_10"])
def test_cost_counter_flops_match_jax_walker(fns):
    """JAX's own test bounds its walker within 0.9-1.1 of XLA; the same band
    here (the products are exact; elementwise ops fuse differently)."""
    ours, theirs = fns
    shapes = {"w1": (256, 512), "w2": (512, 256), "x": (64, 256)}
    sds = [jax.ShapeDtypeStruct(shapes[k], jnp.float32) for k in ("w1", "w2", "x")]
    want = analyze(jax.jit(theirs).lower(*sds).compile().as_text())["flops"]
    with CostMode() as cm:
        ours(*(torch.empty(shapes[k], device="meta") for k in ("w1", "w2", "x")))
    assert 0.9 < cm.flops / want < 1.1


def test_reduced_gemma_train_step_flops_match_jax_walker():
    """One reduced gemma-7b AdamW step, 4 x 64 tokens, on one rank.  Band
    0.9-1.1, JAX's walker's own against XLA: both count the products
    exactly, the elementwise ops differ (XLA fuses and rewrites them,
    the port counts each eager op once; measured 0.978)."""
    B, S = 4, 64
    cfg = jax_reduced_config("gemma-7b")
    state = jax.eval_shape(lambda k: jstep.init_state(k, cfg, optimizer="adamw"),
                           jax.random.key(0))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    fn = jax.jit(jstep.make_train_step(cfg, make_host_mesh(), optimizer="adamw"))
    want = analyze(fn.lower(state, batch).compile().as_text())["flops"]
    rec = dryrun.trace_cell(reduced_config("gemma-7b"), ShapeConfig("t", S, B, "train"))
    assert 0.9 < rec["cost"]["flops"] / want < 1.1
    assert rec["cost"]["by_kernel"]["flash_attention"]["launches"] == 2


# -- traces over an 8-rank fake mesh -------------------------------------------

MESH = ((4, 2), ("data", "model"))
GB, SEQ = 8, 64  # the global batch: 2 rows a "data" rank
CASES = [("gemma-7b", "adamw"), ("deepseek-v3-671b", "adafactor")]
KINDS = ("train", "prefill", "decode")

MESH_JOB = r"""
import json, sys
import torch
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models.config import ShapeConfig

M.init_fake_process_group(8, int(sys.argv[2]))
mesh = M.make_mesh((4, 2), ("data", "model"), device="cpu", backend="fake")
out = {}
for arch, _ in json.loads(sys.argv[1]):
    cfg = reduced_config(arch)
    for kind in ("train", "prefill", "decode"):
        r8 = dryrun.trace_cell(cfg, ShapeConfig(kind, %(S)d, %(B)d, kind), mesh)
        r1 = dryrun.trace_cell(cfg, ShapeConfig(kind, %(S)d, %(B)d // 4, kind), None)
        out[f"{arch}:{kind}"] = {
            "mesh": r8["cost"], "rows": r1["cost"], "records": r8["collectives"]}
print(json.dumps(out))
""" % {"S": SEQ, "B": GB}


@pytest.fixture(scope="module")
def mesh_traces():
    """Rank 0's traces, and under ``"model 1"`` those of rank 1 (data 0,
    model 1)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-W", "ignore", "-c", MESH_JOB, json.dumps(CASES),
                               str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for rank in (0, 1)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return {**outs[0], "model 1": outs[1]}


@pytest.mark.parametrize("arch,opt", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_rank_flops_equal_the_rows_trace(arch, opt, kind, mesh_traces):
    """Decode: the two ranks of "model" hold the same 2 rows whole and split
    their cache's slots (split-K), the vocabulary and deepseek's experts
    (`rules.decode_layout`: "splitk" at 4 heads), so their products are
    equal and below the one-rank trace of those rows, whose projections and
    MLPs they both compute (at least half of it: the attention over half
    the slots, half the head), and no kernel runs.  Train and prefill: both reduced configs
    (4 heads) take the sequence-parallel layout, so the two ranks of the
    "model" axis split their rows' work: the attention kernel's pairs
    exactly by the query offset (rank 1, the later slice, the busier), and
    each rank's flops about half the rows' (0.45-0.6).  gemma-7b's prefill
    products split exactly, its train step's within 3% (the plain
    backward reads the keys up to each slice's last query, so the halves
    skip more of the masked corner than the whole); deepseek's differ by
    what the all-to-all plan saves and by the MLA latents each rank expands
    to K and V over the whole sequence."""
    t, t1 = mesh_traces[f"{arch}:{kind}"], mesh_traces["model 1"][f"{arch}:{kind}"]
    cfg = reduced_config(arch)
    rows, r0, r1 = t["rows"], t["mesh"], t1["mesh"]
    if kind == "decode":
        assert r0["matmul_flops"] == r1["matmul_flops"] < rows["matmul_flops"]
        if cfg.moe is None:
            assert r0["matmul_flops"] >= 0.5 * rows["matmul_flops"]
        assert r0["by_kernel"] == rows["by_kernel"] == {}
        return
    k, k0, k1 = (x["by_kernel"]["flash_attention"] for x in (rows, r0, r1))
    assert k0["launches"] == k1["launches"] == k["launches"]
    assert k0["flops"] + k1["flops"] == k["flops"] and k1["flops"] > k0["flops"]
    for r in (r0, r1):
        assert 0.45 < r["flops"] / rows["flops"] < 0.6
    if cfg.moe is None:
        split = (r0["matmul_flops"] + r1["matmul_flops"]) / rows["matmul_flops"]
        assert split == 1.0 if kind == "prefill" else 0.97 < split <= 1.0


def _placements(spec):
    return rules.placements(spec, rules.MeshShape(*MESH))


def _expected_collectives(arch: str, kind: str) -> list:
    """(kind, result bytes, group size) of every collective rank 0 issues,
    derived from the parameter specs (each parameter gathered where a layer
    reads it, minor mesh dimension first, a leaf the layout keeps local
    (`rules.local_leaves`: here the vocab-parallel embedding) over "data"
    only; its gradient reduce-scattered over the dimensions gathered and
    all-reduced over the replicated ones, major first), the
    sequence-parallel layout's activations in train and prefill (the
    embedding's reduce-scatter, each layer's K / V or MLA latents gathered
    over the sequence, the head's gather, the vocab-parallel loss's three
    all-reduces or the prefill's last position and its logits gathered;
    in train each with its adjoint), the metrics' all-reduces, and the MoE
    plan (on the sequence slices already: nothing sliced or gathered).
    Decode ("splitk": the rows whole on both ranks of "model"): the
    embedding's sum, each layer's split-K merges of the softmax's max and
    sum and of the p.v partials (f32), the logits gathered over the
    vocabulary, and each MoE layer's rows, choices and weights gathered
    over "data" and its outputs summed over the experts' ("data",
    "model"); the expert stacks read where they lie."""
    cfg = reduced_config(arch)
    sizes = dict(zip(MESH[1], MESH[0]))
    ms = rules.MeshShape(*MESH)
    model = lm.LM(cfg, device="meta", generator=torch.Generator())
    lm.make_trainable(model)
    leaves = lm.param_leaves(model)
    specs = rules.param_specs(leaves, cfg, ms)
    train = kind == "train"
    decode = kind == "decode"
    layout = rules.decode_layout(cfg, ms) if decode else rules.model_layout(cfg, ms, SEQ)
    keep = rules.local_leaves(rules.Hint(ms, cfg, {}, layout=layout, decode=decode))
    out = []

    def gather(p, spec, name, grad=True, uses=1, keep=frozenset()):
        pls = _placements(spec)
        axes = rules.gather_axes(ms, name, p.ndim, keep)
        use = [axes is None or ax in axes for ax in MESH[1]]
        full = p.numel() * p.element_size()
        local = full // math.prod(sizes[a] for a, pl in zip(MESH[1], pls) if pl.is_shard())
        for _ in range(uses):
            x = local
            for ax, pl, u in reversed(list(zip(MESH[1], pls, use))):
                if pl.is_shard() and u:
                    x *= sizes[ax]
                    out.append(("all-gather", x, sizes[ax]))
            if train and grad and p.requires_grad:
                g = x
                for ax, pl, u in zip(MESH[1], pls, use):
                    if pl.is_shard():
                        if u:
                            g //= sizes[ax]
                            out.append(("reduce-scatter", g, sizes[ax]))
                    else:
                        out.append(("all-reduce", g, sizes[ax]))

    a2a = cfg.moe is not None and kind != "decode"
    plan = moe._a2a_plan(ms, cfg, (GB, SEQ, cfg.d_model), None) if a2a else None
    for lf in leaves:
        spec = specs[lf.name]
        if lf.stacked:
            spec = rules.P(*spec[1:])
        name = lf.name.rsplit(".", 1)[-1]
        for p in lf.params:
            expert = name in ("w_gate", "w_up", "w_down") and ".moe.w" in lf.name
            if expert and (a2a or decode):
                continue  # read where they lie (`p.local`): sharded on every mesh dim
            uses = 2 if lf.name == "embed" and cfg.tie_embeddings else 1
            gather(p, spec, name, uses=uses, keep=keep)
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    rows, D, m = GB // 4, cfg.d_model, sizes["model"]
    seq = SEQ // m

    def seq_gather(per_token):  # a gather over the sequence and its adjoint
        out.append(("all-gather", rows * SEQ * per_token, m))
        if train:
            out.append(("reduce-scatter", rows * seq * per_token, m))

    if decode:
        assert layout == "splitk" and rules.vocab_parallel(cfg, ms)
        f32 = 4
        out.append(("all-reduce", rows * D * item, m))  # the embedding
        for kind_ in cfg.block_list:
            if kind_ in ("mla", "mla_moe"):
                H, r = cfg.n_heads, cfg.mla.kv_lora_rank
                out += [("all-reduce", rows * H * f32, m)] * 2 + [
                    ("all-reduce", rows * H * r * f32, m)]
            else:
                out += [("all-reduce", rows * cfg.n_heads * f32, m)] * 2 + [
                    ("all-reduce", rows * cfg.n_heads * cfg.head_dim * f32, m)]
            if kind_ in ("moe", "mla_moe"):
                n, k = rows * sizes["data"], cfg.moe.top_k
                out += [("all-gather", n * D * item, sizes["data"]),
                        ("all-gather", n * k * 8, sizes["data"]),
                        ("all-gather", n * k * f32, sizes["data"]),
                        ("all-reduce", n * D * f32, sizes["data"] * m)]
        out.append(("all-gather", rows * cfg.vocab_size * item, m))  # the logits
    elif layout is not None:
        assert layout == "sp" and rules.vocab_parallel(cfg, ms)
        out.append(("reduce-scatter", rows * seq * D * item, m))  # the embedding
        if train:
            out.append(("all-gather", rows * SEQ * D * item, m))
        for kind_ in cfg.block_list:
            if kind_ in ("mla", "mla_moe"):
                seq_gather(cfg.mla.kv_lora_rank * item)
                seq_gather(cfg.mla.qk_rope_dim * item)
            else:
                seq_gather(cfg.n_kv_heads * cfg.head_dim * item)
                seq_gather(cfg.n_kv_heads * cfg.head_dim * item)
        if train:
            seq_gather(D * item)  # the head
            out += [("all-reduce", rows * SEQ * 4, m)] * 3  # max, sum of exp, the label's logit
            out += [("all-reduce", rows * SEQ * 4, m)] * 2  # the two sums' adjoints
        else:
            out += [("all-gather", rows * m * D * item, m),
                    ("all-gather", rows * cfg.vocab_size * item, m)]
    if a2a:
        E, C = cfg.moe.n_experts, plan["C"]
        n_moe = sum(1 for k in cfg.block_list if k in ("moe", "mla_moe"))
        per_layer = [("all-to-all", E * C * D * item, 8)] * 2 + [
            ("all-reduce", 3 * 4, 8), ("all-reduce", E * 4, 8)]
        if train:  # the adjoints; the expert load takes no gradient
            per_layer += [("all-reduce", 3 * 4, 8)] + [("all-to-all", E * C * D * item, 8)] * 2
        out += per_layer * n_moe
    if train:
        # loss, nll, z_loss; the MoE's aux, z and drop share, and its load
        n_metrics = 3 + (3 if cfg.moe is not None else 0)
        load = [("all-reduce", cfg.moe.n_experts * 4, 8)] if cfg.moe is not None else []
        out += [("all-reduce", 4, 8)] * n_metrics + load + [("all-reduce", 4, 8)]
        out += _optimizer_collectives(leaves, specs, dict(CASES)[arch], ms, sizes)
    return out


def _optimizer_collectives(leaves, specs, opt: str, ms, sizes) -> list:
    """The ZeRO-1 update's collectives (`rules.opt_state_specs`), rank 0's:
    for a factored Adafactor leaf its row and column sums (f32) all-reduced
    over the axes that split the reduced dimension, each factor gathered
    over the axes ZeRO-1 adds to it (the minor first), the denominator's
    sums all-reduced like the column sums; one all-reduce of every leaf's
    squared step; then each updated slice gathered over the axes ZeRO-1
    adds to the parameter's spec, or, on a stacked leaf's layer axis (a
    leaf of matrices, taken layer by layer), each layer broadcast from its
    owner.  An unfactored leaf's state lies in its parameter's spec: no
    collective."""
    def axes(ax):
        return (ax,) if isinstance(ax, str) else tuple(ax or ())

    def numel(shape, spec):  # of the rank's block
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return math.prod(d // math.prod(sizes[a] for a in axes(ax)) for d, ax in zip(shape, spec))

    def extra(base, spec):  # (dim, axis) of each axis `spec` adds, the major first
        base = tuple(base) + (None,) * (len(spec) - len(base))
        return [(d, a) for d, (b, z) in enumerate(zip(base, spec)) for a in axes(z)[len(axes(b)):]]

    out, trained = [], 0
    for lf in leaves:
        if not lf.params[0].requires_grad:
            continue
        trained += 1
        shape = rules._leaf_shape(lf)
        nd = len(shape)
        ps = tuple(specs[lf.name]) + (None,) * (nd - len(specs[lf.name]))
        factored = opt == "adafactor" and nd >= 2
        if factored:
            f = rules.factor_specs(rules.P(*ps), shape, ms)
            vc_base, vc_shape = ps[:-2] + (ps[-1],), shape[:-2] + shape[-1:]
            sums = [(ps[-1], numel(shape[:-1], ps[:-1])), (ps[-2], numel(vc_shape, vc_base))]
            for key, base, sh in (("vr", ps[:-1], shape[:-1]), ("vc", vc_base, vc_shape)):
                block = numel(sh, f[key]) * 4
                for _, a in reversed(extra(base, f[key])):
                    block *= sizes[a]
                    out.append(("all-gather", block, sizes[a]))
            sums.append((ps[-2], numel(shape[:-2], ps[:-2])))
            out += [("all-reduce", n * 4, math.prod(sizes[a] for a in axes(ax)))
                    for ax, n in sums if axes(ax)]
            update = rules.zero1(rules.P(*ps), shape, ms)
        else:
            update = rules.zero1(rules.P(*ps), shape, ms) if opt == "adamw" else rules.P(*ps)
        cuts = extra(ps, update)
        whole = not lf.stacked or (factored and nd == 2)
        lead = [] if whole else [a for d, a in cuts if d == 0]
        inner = cuts if whole else [(d, a) for d, a in cuts if d > 0]
        unit = (numel(shape, ps) if whole else numel(shape[1:], ps[1:])) * lf.params[0].element_size()
        units = 1 if whole else shape[0]
        for _ in range(units // math.prod(sizes[a] for a in lead)):
            block = unit // math.prod(sizes[a] for _, a in inner)
            for _, a in reversed(inner):
                block *= sizes[a]
                out.append(("all-gather", block, sizes[a]))
        for k, a in enumerate(lead):
            dom = units // math.prod(sizes[b] for b in lead[:k])
            out += [("collective-broadcast", unit, sizes[a])] * dom
    if opt == "adafactor":
        out.append(("all-reduce", trained * 4, 8))
    return out


def _by_kind(ops) -> dict:
    tot = {}
    for kind, b, n in ops:
        if n > 1:
            tot[kind] = tot.get(kind, 0.0) + coll.traffic(kind, b, n)
    return tot


@pytest.mark.parametrize("arch,opt", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_by_kind_follow_the_specs_and_plan(arch, opt, kind, mesh_traces):
    t = mesh_traces[f"{arch}:{kind}"]
    want = _by_kind(_expected_collectives(arch, kind))
    got = t["mesh"]["coll_by_kind"]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert t["records"]["count"] == sum(1 for _, _, n in _expected_collectives(arch, kind) if n > 1)
    # a (4, 2) mesh over ranks 0-7 is one host: every group goes by NVLink
    assert t["mesh"]["link_by_fabric"]["ib"] == 0.0
    assert t["rows"]["link_bytes"] == 0.0


# -- the ring model and the fabric -----------------------------------------------

RING = [(k, n) for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                         "collective-permute") for n in (1, 2, 16)]


@pytest.mark.parametrize("kind,n", RING)
def test_ring_model_is_jax_model(kind, n):
    assert coll.traffic(kind, 12345, n) == _collective_traffic(kind, 12345, n)


@pytest.mark.parametrize("ranks,fabric", [((0, 1, 7), "nvlink"), ((8, 15), "nvlink"),
                                          ((7, 8), "ib"), (tuple(range(0, 256, 16)), "ib")])
def test_fabric_is_nvlink_within_one_host(ranks, fabric):
    assert coll.fabric(ranks) == fabric


# -- analyze_cell against JAX's ---------------------------------------------------

SYNTH = [
    ("gemma-7b", "train_4k", "16x16", 1.1e15, 3.0e13, 2.0e12, 8.5e9, 1048576),
    ("qwen2-72b", "prefill_32k", "16x16", 9.0e14, 5.0e14, 7.0e10, 7.27e10, 1048576),
    ("deepseek-v3-671b", "decode_32k", "2x16x16", 2.0e11, 4.0e11, 9.0e11, 3.5e10, 128),
    ("xlstm-125m", "long_500k", "2x16x16", 3.0e8, 2.0e8, 0.0, 1.55e8, 1),
]


def _synthetic(arch, shape, mesh, flops, hbm, link, n, tokens):
    """A record both packages read: JAX's fallback keys (``cost`` "flops"
    and "bytes accessed", ``collectives`` "link_bytes") and the port's
    (every link byte over InfiniBand, so one bandwidth prices it)."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "params_total": n, "params_active": n, "tokens_per_step": tokens,
            "cost": {"flops": flops, "bytes accessed": hbm, "hbm_bytes": hbm,
                     "link_bytes": link, "link_by_fabric": {"nvlink": 0.0, "ib": link},
                     "score_bytes": 0.0},
            "collectives": {"link_bytes": link}}


@pytest.mark.parametrize("case", SYNTH, ids=[f"{c[0]}:{c[1]}:{c[2]}" for c in SYNTH])
def test_analyze_cell_follows_jax_formulas(case):
    rec = _synthetic(*case)
    j = jax_analyze.analyze_cell(rec, None)
    t = tanalyze.analyze_cell(rec)
    # each term times its own peak is the same count
    assert t["t_compute"] * tanalyze.PEAK_FLOPS == pytest.approx(j["t_compute"] * jax_analyze.PEAK_FLOPS)
    assert t["t_memory"] * tanalyze.HBM_BW == pytest.approx(j["t_memory"] * jax_analyze.HBM_BW)
    assert t["t_collective"] * tanalyze.IB_BW == pytest.approx(
        j["t_collective"] * jax_analyze.LINK_BW)
    assert (t["chips"], t["model_flops"], t["useful_ratio"]) == (
        j["chips"], j["model_flops"], j["useful_ratio"])
    step = max(t["t_compute"], t["t_memory"], t["t_collective"])
    assert t["est_step_time"] == step
    assert t["est_mfu"] == pytest.approx(t["model_flops"] / (t["chips"] * tanalyze.PEAK_FLOPS * step))
    assert t["est_mfu_flash"] == t["est_mfu"]  # no score bytes
    assert t["est_tokens_per_s"] == pytest.approx(t["tokens_per_step"] / step)


def test_analyze_prices_nvlink_and_ib_apart():
    rec = _synthetic("gemma-7b", "train_4k", "16x16", 0.0, 0.0, 0.0, 1.0, 1)
    rec["cost"]["link_by_fabric"] = {"nvlink": 450e9, "ib": 50e9}
    rec["cost"]["score_bytes"] = 0.0
    assert tanalyze.analyze_cell(rec)["t_collective"] == pytest.approx(2.0)


def test_the_roofline_is_priced_for_the_h100():
    """989 TFLOP/s bf16 and 3.35 TB/s (NVIDIA's H100 SXM data sheet), and no
    TPU constant anywhere in the port."""
    assert (tanalyze.PEAK_FLOPS, tanalyze.HBM_BW, tanalyze.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert tanalyze.IB_BW == 400e9 / 8
    tpu = re.compile(r"197e12|819e9|197 ?TFLOP|819 ?GB")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not tpu.search(path.read_text()), path


# -- the flash_attention meta route ---------------------------------------------

FLASH = [((2, 100, 8, 64), (2, 120, 2, 64), True), ((2, 100, 8, 64), (2, 120, 2, 64), False),
         ((1, 300, 4, 128), (1, 200, 4, 128), True), ((3, 64, 16, 256), (3, 64, 16, 256), True)]


@pytest.mark.parametrize("qs,ks,causal", FLASH)
def test_flash_meta_route_shapes_and_records_without_launching(qs, ks, causal):
    q = torch.empty(qs, dtype=torch.bfloat16, device="meta")
    k = torch.empty(ks, dtype=torch.bfloat16, device="meta")
    v = torch.empty_like(k)
    before = counters.snapshot()
    with CostMode() as cm:
        out = kattn.flash_attention(q, k, v, causal=causal)
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype, "meta")
    assert counters.snapshot() == before  # no launch, no plain call
    B, S, H, hd = qs
    T = ks[1]
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    assert cm.by_kernel == {"flash_attention": {
        "launches": 1, "flops": 4.0 * B * H * hd * pairs,
        "bytes": float((2 * q.numel() + k.numel() + v.numel()) * 2)}}


def test_flash_meta_route_refuses_a_block_over_the_shared_memory_budget():
    q = torch.empty((1, 64, 2, 256), dtype=torch.bfloat16, device="meta")
    lc = dataclasses.replace(kattn.DEFAULT, smem_budget=kattn.smem_bytes(256, 2) - 1)
    with pytest.raises(ValueError, match="shared memory"):
        kattn.flash_attention(q, q, q, lc=lc)


def test_flash_meta_route_computes_no_work_without_a_recorder(monkeypatch):
    def unwanted(*args):
        raise AssertionError("flash_work called with no recorder active")

    monkeypatch.setattr(kattn, "flash_work", unwanted)
    q = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device="meta")
    assert kattn.flash_attention(q, q, q).shape == q.shape


def test_flash_meta_route_refuses_mixed_devices():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        kattn.flash_attention(q, torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16)))
