"""The dry run (the counterpart of `repro.launch.dryrun`): every (arch x
shape x mesh) cell of JAX's dry run, traced through the port's own step
functions on the meta device as one rank of a fake process group of 256
ranks (mesh (16, 16), ("data", "model")) or 512 ((2, 16, 16), ("pod",
"data", "model")), its cost counted by `roofline.cost.CostMode` and
priced for the H100 by `roofline.analyze`.  No card is needed.  The
traced rank is the last of the "model" axis (`TRACED`: the first of every
other axis): under the sequence-parallel layout with a causal mask its
slice of the queries sees the most keys, so it is the busiest rank; the
record names it (``rank``, ``coords``).

JAX lowers and compiles each cell for 512 host devices and reads XLA's
cost and memory analyses and the partitioned HLO.  The port has no
compiler in between.  A meta tensor holds no data, so a trace runs the
step's Python while every ATen op only shapes its outputs; each kernel
wrapper reports its work (`kernels.attention.flash_attention`'s meta
route); the fake backend's collectives return at once while
`sharding.comm` records them.  So a record holds the work of the port as
it runs, a rank's own: its rows of the batch, their work split over the
"model" axis as JAX's hints lay it out (`sharding.rules.model_layout`) in
training and prefill, and in decode as JAX's decode lays it out
(`sharding.rules.decode_layout`): the rank's part of the cache
(`rules.cache_specs`, the time axis over "model": split-K), "tp"'s heads
and FFN hidden, the vocab-parallel embedding and head, the MoE experts
where they lie.  A train cell's optimizer state is the rank's block of
ZeRO-1's layout (`sharding.rules.opt_state_specs`, JAX's in and out
shardings of the state), which the train step stores and updates in place
(`optim.zero`): the record's ``opt_bytes``, traced, against
``opt_bytes_zero1``, computed from the specs.

    python -m repro_torch.launch.dryrun --all --mesh pod   # a process a cell
    python -m repro_torch.launch.dryrun --cell gemma-7b:train_4k:pod
    python -m repro_torch.roofline.analyze                 # the table

Records go to ``chiprun_out/dryrun/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs import ARCHS, cell_status, extra_inputs, get_config
from ..models import lm
from ..models.config import SHAPES, ShapeConfig
from ..roofline.collectives import top_collectives
from ..roofline.cost import CostMode, storages
from ..serve import cv_engine as engine
from ..sharding import rules
from ..sharding.rules import MeshShape, P, opt_state_specs
from ..train import step as step_mod
from .mesh import init_fake_process_group, make_production_mesh

SRC = Path(__file__).resolve().parents[2]
ART_DIR = SRC.parent / "chiprun_out" / "dryrun"

# Production optimizer choice per arch, JAX's: Adafactor where full Adam
# state cannot fit the pod.
OPTIMIZER = {
    "deepseek-v3-671b": "adafactor",
    "arctic-480b": "adafactor",
    "qwen2-72b": "adamw",
}

# --mesh name -> (the record's mesh name, ranks)
MESHES = {"pod": ("16x16", 256), "multipod": ("2x16x16", 512)}
# the traced rank on either mesh, row-major over its axes: the last of "model"
# (16 ranks, the last axis), the first of every other axis
TRACED = 16 - 1

F32_BYTES = 4


def _shape_config(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg, shape) -> dict:
    """Meta-tensor stand-ins for every model input of this cell (JAX's
    ShapeDtypeStructs): tokens and labels for training, the prompt for a
    prefill, one new token for a decode (the cache covers ``seq_len``), and
    the context input of a cross-attention arch but in a decode.  `shape`:
    a `SHAPES` name or a `ShapeConfig`."""
    sh = _shape_config(shape)
    B, S = sh.global_batch, sh.seq_len

    def sds(shp, dtype):
        return torch.empty(tuple(shp), dtype=dtype, device="meta")

    if sh.kind == "train":
        batch = {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
    elif sh.kind == "prefill":
        batch = {"tokens": sds((B, S), torch.int32)}
    else:
        batch = {"tokens": sds((B, 1), torch.int32)}
    for name, (shp, dt) in extra_inputs(cfg, B, S).items():
        if sh.kind != "decode":
            batch[name] = sds(shp, getattr(torch, dt))
    return batch


def count_params(leaves, active: bool, cfg) -> float:
    """Total (or MoE-active) parameter count of `lm.param_leaves`, JAX's
    rule: with `active`, a leaf of rank >= 3 named ``w_gate``, ``w_up`` or
    ``w_down`` under a ``moe`` key counts top_k / n_experts of itself (JAX's
    stacked shared-expert weights too, as its rule has them)."""
    total = 0.0
    for lf in leaves:
        names = lf.name.split(".")
        shape = rules._leaf_shape(lf)
        n = float(math.prod(shape))
        if (active and cfg.moe is not None and len(shape) >= 3
                and names[-1] in ("w_gate", "w_up", "w_down") and "moe" in names):
            n *= cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return total


def spec_bytes(shape, spec: P, mesh, itemsize: int) -> float:
    """Bytes of a rank's part of a tensor of `shape` under `spec`."""
    sizes = rules.mesh_axis_sizes(mesh)
    split = 1
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            split *= sizes[a]
    return math.prod(shape) * itemsize / split


def opt_bytes_zero1(leaves, pspecs: dict, mesh, optimizer: str) -> float:
    """A rank's optimizer-state bytes (f32) as `opt_state_specs` lays them
    out (`sharding.rules`; the train step stores them so, and a record's
    ``opt_bytes`` traces them)."""
    specs = opt_state_specs(leaves, pspecs, mesh, optimizer)
    total = 0.0
    for i, lf in enumerate(leaves):
        sh = rules._leaf_shape(lf)
        if optimizer == "adamw":
            total += 2 * spec_bytes(sh, specs["m"][lf.name], mesh, F32_BYTES)
        elif len(sh) >= 2:
            f = specs["f"][i]
            total += spec_bytes(sh[:-1], f["vr"], mesh, F32_BYTES)
            total += spec_bytes(sh[:-2] + sh[-1:], f["vc"], mesh, F32_BYTES)
        else:
            total += spec_bytes(sh, specs["f"][i]["v"], mesh, F32_BYTES)
    return total


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages in `tree` (a DTensor's local part)."""
    return sum(st.nbytes() for st in storages(tree))


def mesh_name(mesh) -> str:
    return "1" if mesh is None else "x".join(str(s) for s in tuple(mesh.shape))


def _ctx_len(cfg) -> int | None:
    """The decode cache's context rows, JAX's: 4096 frames for an
    encoder-decoder, the image tokens for an arch with ``xattn`` layers."""
    if cfg.encdec or any(k == "xattn" for k, _ in cfg.blocks):
        return 4096 if cfg.encdec else cfg.n_image_tokens
    return None


def trace_cell(cfg, shape, mesh=None) -> dict:
    """Trace one step of `cfg` at `shape` (a `SHAPES` name or a
    `ShapeConfig`) on the meta device as this rank of `mesh` (None: one
    device, nothing sharded), JAX's step for its kind as `lower_cell` builds
    it: `train.step.make_train_step` with `OPTIMIZER`'s optimizer (else
    AdamW), `serve.cv_engine.make_prefill_step`, or
    `make_decode_step` over `lm.init_cache`'s cache of ``seq_len``
    positions, this rank's part of it (``cache_bytes``; the whole batch's
    whole cache: ``cache_bytes_global``) -> the record (module
    docstring)."""
    sh = _shape_config(shape)
    opt_name = OPTIMIZER.get(cfg.name, "adamw")
    ranks = 1 if mesh is None else dist.get_world_size()
    rec = {"arch": cfg.name, "shape": sh.name, "mesh": mesh_name(mesh), "ranks": ranks,
           "status": "ok"}
    if mesh is not None:
        rec["rank"] = dist.get_rank()
        rec["coords"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    spec_mesh = mesh if mesh is not None else MeshShape((1, 1), ("data", "model"))
    t0 = time.time()
    model = lm.LM(cfg, device="meta", generator=torch.Generator())
    leaves = lm.param_leaves(model)
    rec["params_total"] = count_params(leaves, False, cfg)
    rec["params_active"] = count_params(leaves, True, cfg)
    pspecs = rules.param_specs(leaves, cfg, spec_mesh)
    batch = input_specs(cfg, sh)
    if mesh is not None:
        lm.shard_model(model, mesh)
    cm = CostMode()
    memory = {"param_bytes": tree_bytes(model)}
    B, S = sh.global_batch, sh.seq_len
    if sh.kind == "train":
        state = step_mod.init_state(cfg, optimizer=opt_name, model=model)
        fn = step_mod.make_train_step(cfg, mesh, optimizer=opt_name)
        memory["opt_bytes"] = tree_bytes(state["opt"])
        memory["opt_bytes_zero1"] = opt_bytes_zero1(leaves, pspecs, spec_mesh, opt_name)
        cm.hold((model, state["opt"], batch))
        with cm:
            fn(state, batch)
        rec["optimizer"] = opt_name
        rec["tokens_per_step"] = B * S
    elif sh.kind == "prefill":
        fn = engine.make_prefill_step(cfg, mesh)
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        cm.hold((model, batch))
        with torch.inference_mode(), cm:
            fn(model, batch["tokens"], extras or None)
        rec["tokens_per_step"] = B * S
    else:
        ctx_len = _ctx_len(cfg)
        tokens = batch["tokens"]
        if mesh is not None:
            tokens = rules.shard_batch({"tokens": tokens}, mesh, cfg)["tokens"]
        rec["cache_bytes_global"] = float(tree_bytes(
            lm.init_cache(cfg, B, S, ctx_len=ctx_len, device="meta")))
        fn = engine.make_decode_step(cfg, mesh)
        with torch.inference_mode():
            cache = lm.init_cache(cfg, B, S, ctx_len=ctx_len, device="meta", mesh=mesh)
            memory["cache_bytes"] = tree_bytes(cache)
            cm.hold((model, cache, tokens))
            with cm:
                fn(model, cache, tokens)
        rec["tokens_per_step"] = B
    rec["seconds_trace"] = time.time() - t0
    rec["cost"] = cm.summary()
    c = cm.collective_summary()
    rec["collectives"] = {"link_bytes": c["link_bytes"], "count": c["count"],
                          "bytes_by_kind": c["bytes_by_kind"],
                          "link_by_fabric": c["link_by_fabric"], "top": top_collectives(c, 8)}
    rec["memory"] = {**cm.memory(), **memory}
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir) -> dict:
    """One cell of the production mesh -> its record, written to
    ``<out_dir>/<arch>__<shape>__<mesh>.json``: ``status`` "skip" with the
    arch's reason (`configs.cell_status`), "ok", or "error" with the
    traceback.  Joins the fake process group of the mesh's ranks first."""
    label, world = MESHES["multipod" if multi_pod else "pod"]
    try:
        cfg = get_config(arch)
        skip = cell_status(cfg, shape_name)
        if skip:
            rec = {"arch": arch, "shape": shape_name, "mesh": label, "status": "skip",
                   "reason": skip}
        else:
            if not dist.is_initialized():
                init_fake_process_group(world, TRACED)
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu", backend="fake")
            rec = trace_cell(cfg, shape_name, mesh)
    except Exception as e:  # noqa: BLE001 — a cell's failure is its record
        rec = {"arch": arch, "shape": shape_name, "mesh": label, "status": "error",
               "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{rec['mesh']}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    extra = rec.get("reason") or rec.get("error", "")
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: {rec['status']} {extra}", flush=True)
    return rec


def _done(out_dir, arch: str, shape: str, mesh: str) -> bool:
    path = os.path.join(out_dir, f"{arch}__{shape}__{MESHES[mesh][0]}.json")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return json.load(f).get("status") in ("ok", "skip")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", default=None, help="arch:shape:mesh (subprocess mode)")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true", help="re-run cells with records")
    args = ap.parse_args()

    if args.cell:
        arch, shape_name, mesh = args.cell.split(":")
        if mesh not in MESHES:
            ap.error(f"--cell: mesh {mesh!r} is not one of {sorted(MESHES)}")
        rec = run_cell(arch, shape_name, mesh == "multipod", args.out)
        sys.exit(0 if rec["status"] in ("ok", "skip") else 1)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": ["pod"], "multipod": ["multipod"], "both": ["pod", "multipod"]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if not args.force:
        cells = [c for c in cells if not _done(args.out, *c)]
    print(f"[dryrun] {len(cells)} cells to run", flush=True)

    # one subprocess a cell: its own process group and memory, in parallel
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p))
    procs: list = []
    pending = list(cells)
    fails = []
    t0 = time.time()
    while pending or procs:
        while pending and len(procs) < args.jobs:
            cell = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", ":".join(cell),
                   "--out", args.out]
            procs.append((subprocess.Popen(cmd, env=env), cell))
        for pr, cell in list(procs):
            if pr.poll() is not None:
                procs.remove((pr, cell))
                if pr.returncode != 0:
                    fails.append(cell)
        time.sleep(0.2)
    print(f"[dryrun] complete in {time.time() - t0:.1f} s; {len(fails)} failures: {fails}",
          flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
