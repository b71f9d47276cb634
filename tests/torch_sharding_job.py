"""The multi-rank half of `tests/test_torch_sharding.py`: 8 gloo ranks on
the CPU, a (4, 2) ("data", "model") mesh, every check in one spawn.

    python tests/torch_sharding_job.py OUT_DIR

reads ``OUT_DIR/inputs.pt`` (the reduced deepseek-v3-671b model in f32
carried across from JAX, its batch; reduced arctic-480b's model from JAX's
tree; the seeded gradients of the
compressed all-reduce; the models and batches of `LAYOUT_CASES`) and
writes rank 0's results to ``OUT_DIR/out.pt``: the sharded forward's
logits, loss and gradients (whole), the compressed all-reduces, two
sharded train steps of reduced gemma-7b (AdamW, Adafactor, the
accumulation step), reduced deepseek-v3-671b (AdamW) and reduced
arctic-480b (Adafactor, `arctic_config`), each
optimizer's state checked against ZeRO-1's specs on every rank
(`_zero1_state`), the elastic restore from (4, 2) onto (2, 4) (a tensor,
a training state, the training loop's restart), a block of a spec out of
the mesh's order gathered whole, a DTensor under `constrain`, a sharded
`generate`, for each of `LAYOUT_CASES` the layout the model axis takes,
the sharded forward's logits and gradients and two train steps (gemma's
"tp" case also a sharded `generate`; zamba2's the SSD heads each rank
scans, the rows of ``out_proj`` it reads, and a prefill decoded
teacher-forced, `SSM_PROMPT`), and for each of `DECODE_CASES` a prefill
and teacher-forced decode steps over the model axis (`decode_run`).
Every rank waits at most `TIMEOUT_S` in a collective, so a hung
rendezvous fails instead of stalling.
"""

import dataclasses
import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLD, SHAPE, AXES = 8, (4, 2), ("data", "model")
TIMEOUT_S = 120
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 32, 8, 1e-3

# The model axis's layouts (`sharding.rules.model_layout`) on the (4, 2)
# mesh: tag -> (arch, the reduced config's changes, the layout).  16 q and
# 16 KV heads pass JAX's 16-way test (tensor-parallel heads and FFN);
# reduced qwen2-72b's 8 over 2 do not (sequence-parallel, with its biases),
# and its vocabulary of 511 does not divide the model axis (the embedding
# and the head whole, the logits and the loss on the sequence slices).
# Reduced zamba2-2.7b's 4 SSD heads divide the model axis (JAX's
# "ssm_heads"): each rank scans 2; its 4 attention heads do not pass the
# 16-way test, so its shared block is sequence-parallel.
LAYOUT_CASES = {
    "gemma tp": ("gemma-7b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8}, "tp"),
    "qwen2 sp": ("qwen2-72b", {"vocab_size": 511}, "sp"),
    "seamless tp": ("seamless-m4t-large-v2", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8},
                    "tp"),
    "zamba2 ssm_heads": ("zamba2-2.7b", {}, "sp"),
}
# the zamba2 case's prefill: the batch's first tokens, then the next
# `SSM_STEPS` teacher-forced into a cache of `SSM_CACHE` slots
SSM_PROMPT, SSM_STEPS, SSM_CACHE = 16, 4, 24


# Decode over the model axis (`sharding.rules.decode_layout`) on the (4, 2)
# mesh: tag -> (arch, the reduced config's changes, prompt length, cache
# length, the decode layout), each prefilled (`DECODE_B` rows) and decoded
# `DECODE_STEPS` steps teacher-forced.  gemma's 6-token prompt in 24 slots
# leaves model rank 1's 12 slots without a valid position for the first 6
# steps; qwen2 (8 over 2 heads, its biases) splits the cache alone; danube's
# 40-token prompt wraps its 32-slot window ring over both ranks' 16 slots;
# deepseek's MLA (4 heads: split-K alone; 16: "tp") and its 8 experts one a
# rank over ("data", "model"); arctic at 6 experts, over "model" alone, a
# prompt and a cache of odd length (the prefill unsplit, the cache whole:
# `cache_specs` prunes the axis); zamba2's Mamba2 states whole and its
# shared block's ring split; seamless's cross-attention over the rank's
# `DECODE_CTX` / 2 context rows (its 21-slot self cache whole)
DECODE_CASES = {
    "gemma tp": ("gemma-7b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8}, 6, 24, "tp"),
    "qwen2 splitk": ("qwen2-72b", {}, 12, 20, "splitk"),
    "danube ring": ("h2o-danube-3-4b", {}, 40, 48, "splitk"),
    "deepseek": ("deepseek-v3-671b", {}, 12, 24, "splitk"),
    "deepseek tp": ("deepseek-v3-671b", {"n_heads": 16, "n_kv_heads": 16}, 12, 24, "tp"),
    "arctic 6 experts": ("arctic-480b", {"n_experts": 6}, 11, 19, "splitk"),
    "zamba2": ("zamba2-2.7b", {}, 12, 20, "splitk"),
    "seamless tp": ("seamless-m4t-large-v2", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8},
                    12, 21, "tp"),
}
DECODE_B, DECODE_STEPS, DECODE_CTX = 8, 8, 16


def decode_config(reduced_config, tag: str):
    """The f32 reduced config of a `DECODE_CASES` case, in the package of
    `reduced_config`."""
    arch, kw, *_ = DECODE_CASES[tag]
    kw = dict(kw)
    cfg = reduced_config(arch).replace(dtype="float32")
    if "n_experts" in kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=kw.pop("n_experts")))
    return cfg.replace(**kw)


def decode_run(model, cfg, tag: str, case: dict, mesh=None, cache_len=None) -> dict:
    """A `DECODE_CASES` case (or a cache of `cache_len` slots): the prompts
    prefilled, adopted into a cache of the case's length and decoded with
    the case's tokens, teacher-forced;
    on `mesh` (a `shard_model` model) every rank runs its rows over the
    model axis.  -> the logits of every step (steps, B, V), every row's;
    the first run's cache entries' shapes and the first shared-block
    application's (``shared.k``), a rank's; unsharded, the adopted cache
    before the first step (for JAX's `decode_step`)."""
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine as engine
    from repro_torch.sharding import comm, rules

    T = cache_len or DECODE_CASES[tag][3]
    prompts, tokens, extras = case["prompts"], case["tokens"], case.get("extras")
    B = prompts.shape[0]
    hint = rules.make_hint(mesh, cfg) if mesh is not None else None
    out: dict = {}
    with torch.inference_mode():
        _, pc = lm.prefill(model, prompts, extras=extras, hint=hint)
        cache = lm.init_cache(cfg, B, T, ctx_len=lm.context_len(cfg, extras, B), device="cpu",
                              mesh=mesh)
        cache = engine._adopt_prefill(cache, pc, cfg, mesh=mesh)
        out["shapes"] = {n: tuple(t.shape) for n, t in cache["groups"][0].items()}
        for n, t in (cache["shared"][0].items() if cache["shared"] else ()):
            out["shapes"][f"shared.{n}"] = tuple(t.shape)
        if mesh is None:
            out["adopted"] = {part: [{n: t.clone() for n, t in g.items()} for g in cache[part]]
                              for part in ("groups", "shared")} | {"pos": cache["pos"]}
        else:
            tokens = rules.shard_batch({"tokens": tokens}, mesh, cfg)["tokens"]
        logits = []
        for t in range(tokens.shape[1]):
            lg, cache = lm.decode_step(model, tokens[:, t : t + 1], cache, hint=hint)
            logits.append(lg)
    logits = torch.stack(logits)
    if mesh is not None:
        logits = comm.all_gather(logits, 1, comm.axes_group(mesh, ("data",)))
    out["logits"] = logits
    return out


def _decode_case(tag: str, case: dict, mesh) -> dict:
    """A `DECODE_CASES` case on `mesh`: its decode layout and `decode_run`."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.sharding import rules

    cfg = decode_config(reduced_config, tag)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    lm.shard_model(model, mesh)
    return {"layout": rules.decode_layout(cfg, mesh), **decode_run(model, cfg, tag, case, mesh)}


def arctic_config(reduced_config):
    """The f32 reduced arctic-480b of the Adafactor run, in the package of
    `reduced_config`: its aux loss weighted 0, the one term the all-to-all
    path takes per shard, so that the single process computes the same
    function."""
    cfg = reduced_config("arctic-480b").replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, aux_loss_weight=0.0))


def layout_config(reduced_config, tag: str):
    """The f32 reduced config of a `LAYOUT_CASES` case, in the package of
    `reduced_config`."""
    arch, kw, _ = LAYOUT_CASES[tag]
    return reduced_config(arch).replace(dtype="float32", **kw)


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _zero1_state(state: dict, cfg, mesh, optimizer: str) -> dict:
    """Every rank's optimizer state against ZeRO-1's specs: each tensor of
    the local shape `rules.opt_state_specs` gives, their bytes summing to
    `launch.dryrun.opt_bytes_zero1`, and some leaf's state split over an
    axis its parameter does not use; each a bool, true on every rank."""
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.sharding import comm, rules

    leaves = lm.param_leaves(state["model"])
    pspecs = rules.param_specs(leaves, cfg, mesh)
    specs = rules.opt_state_specs(leaves, pspecs, mesh, optimizer)
    opt = state["opt"]
    shapes, nbytes, extra = True, 0, False
    for i, lf in enumerate(leaves):
        sh = rules._leaf_shape(lf)
        full = {"m": sh, "v": sh, "vr": sh[:-1], "vc": sh[:-2] + sh[-1:]}
        own = ({k: (opt[k][lf.name], specs[k][lf.name]) for k in ("m", "v")} if "m" in opt
               else {k: (opt["f"][lf.name][k], sp) for k, sp in specs["f"][i].items()})
        used = {a for ax in pspecs[lf.name] for a in rules.spec_axes(ax)}
        for k, (t, sp) in own.items():
            shapes &= tuple(t.shape) == rules.spec_shape(full.get(k, sh), sp, mesh)
            nbytes += t.numel() * t.element_size()
            extra |= bool({a for ax in sp for a in rules.spec_axes(ax)} - used)
    ok = torch.tensor([shapes, nbytes == dryrun.opt_bytes_zero1(leaves, pspecs, mesh, optimizer),
                       extra], dtype=torch.float32)
    ok = comm.all_reduce(ok, dist.group.WORLD, op=dist.ReduceOp.MIN)
    return dict(zip(("shapes", "bytes", "extra axis"), map(bool, ok.tolist())))


def _train(cfg, mesh, *, optimizer="adamw", model=None, accum=None):
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import step as tstep

    state = tstep.init_state(cfg, optimizer=optimizer, device="cpu", model=model, mesh=mesh,
                             generator=torch.Generator().manual_seed(0))
    kw = dict(optimizer=optimizer, peak_lr=TRAIN_LR, warmup=1)
    fn = (tstep.make_accum_train_step(cfg, mesh, accum=accum, **kw) if accum
          else tstep.make_train_step(cfg, mesh, **kw))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    metrics = []
    for i in range(2):
        state, m = fn(state, stream.batch_at(i))
        metrics.append({k: float(v) for k, v in m.items()})
    params = {n: _full(p) for n, p in state["model"].named_parameters()}
    return state, {"metrics": metrics, "params": params,
                   "zero1": _zero1_state(state, cfg, mesh, optimizer)}


def _extras(batch: dict) -> dict | None:
    return {k: v for k, v in batch.items() if k not in ("tokens", "labels")} or None


def ssm_case(batch: dict) -> dict:
    """The zamba2 layout case's prefill and teacher-forced tokens."""
    tokens = batch["tokens"]
    return {"prompts": tokens[:, :SSM_PROMPT],
            "tokens": tokens[:, SSM_PROMPT:SSM_PROMPT + SSM_STEPS]}


def _layout_case(tag: str, case: dict, mesh) -> dict:
    """A `LAYOUT_CASES` case on `mesh`: the layout, the forward's logits
    (every row), the loss's gradients (whole) and two AdamW steps."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve.cv_engine import generate
    from repro_torch.sharding import comm, rules
    from repro_torch.train import step as tstep

    from repro_torch.models import ssm

    cfg = layout_config(reduced_config, tag)
    hint = rules.make_hint(mesh, cfg)
    batch = case["batch"]
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    lm.make_trainable(lm.shard_model(model, mesh))
    S = batch["tokens"].shape[1]
    out = {"layout": rules.model_layout(cfg, mesh, S)}
    scan, heads = ssm.ssd_scan, []

    def counted(x, *args, **kwargs):  # the heads of every scan a rank runs
        heads.append(x.shape[2])
        return scan(x, *args, **kwargs)

    ssm.ssd_scan = counted
    try:
        logits, _ = lm.forward(model, batch["tokens"], extras=_extras(batch), hint=hint)
    finally:
        ssm.ssd_scan = scan
    if cfg.ssm is not None:
        mixer = lm._at(model.blocks[0], hint.at(S))["mixer"]
        out["ssm"] = {"split": rules.ssm_heads(cfg, mesh, out["layout"]), "heads": heads,
                      "out_proj": tuple(mixer["out_proj"].shape)}
    out["logits"] = comm.all_gather(logits.detach(), 0, comm.axes_group(mesh, ("data",)))
    loss, _ = tstep.loss_fn(model, batch, hint=hint)
    (loss / WORLD).backward()
    out["grads"] = {n: _full(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    if tag == "gemma tp":
        with torch.no_grad():
            out["generate"] = generate(model, batch["tokens"][:, :12], steps=6, device="cpu",
                                       mesh=mesh)
    if cfg.ssm is not None:
        out["decode"] = decode_run(model, cfg, tag, ssm_case(batch), mesh, cache_len=SSM_CACHE)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(case["state"])
    state = tstep.init_state(cfg, device="cpu", model=model, mesh=mesh)
    fn = tstep.make_train_step(cfg, mesh, peak_lr=TRAIN_LR, warmup=1)
    metrics = []
    for b in case["steps"]:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    out["steps"] = {"metrics": metrics,
                    "params": {n: _full(p) for n, p in state["model"].named_parameters()}}
    return out


def rank_main(rank: int, out_dir: str, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe
    from repro_torch.optim import compression
    from repro_torch.serve.cv_engine import generate
    from repro_torch.sharding import comm, rules
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import step as tstep

    inp = torch.load(os.path.join(out_dir, "inputs.pt"))
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    out: dict = {}

    # -- the sharded forward and gradients of reduced deepseek-v3-671b --------
    cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(inp["deepseek"])
    lm.make_trainable(lm.shard_model(model, mesh))
    hint = rules.make_hint(mesh, cfg)
    tokens, labels = inp["tokens"], inp["labels"]
    plan = moe._a2a_plan(mesh, cfg, (*tokens.shape, cfg.d_model), None)
    out["plan"] = {k: plan[k] for k in ("a2a_axes", "L", "C", "n_ep")}
    logits, _ = lm.forward(model, tokens, hint=hint)
    out["logits"] = comm.all_gather(logits.detach(), 0, comm.axes_group(mesh, ("data",)))
    loss, metrics = tstep.loss_fn(model, {"tokens": tokens, "labels": labels}, hint=hint)
    (loss / WORLD).backward()
    out["loss"] = float(comm.all_reduce(loss.detach().clone(), dist.group.WORLD) / WORLD)
    out["moe_aux"] = float(metrics["moe_aux"])
    out["grads"] = {n: _full(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    del model

    # -- the compressed all-reduce ---------------------------------------------
    g = inp["g"][rank]
    mean, res = compression.compressed_psum(g, torch.zeros_like(g))
    out["psum_mean"] = mean
    out["psum_residuals"] = comm.all_gather(res[None], 0, dist.group.WORLD)
    out["bf16_mean"] = compression.bf16_psum(g)
    allreduce = compression.make_compressed_allreduce(mesh, "data")
    means, _ = allreduce({"a": [g]}, {"a": [torch.zeros_like(g)]})
    out["data_means"] = comm.all_gather(means["a"][0][None], 0, dist.group.WORLD)

    # -- two sharded train steps -----------------------------------------------
    gemma = reduced_config("gemma-7b").replace(dtype="float32")
    for tag, kw in (("gemma adamw", {}), ("gemma adafactor", {"optimizer": "adafactor"}),
                    ("gemma accum", {"accum": 2})):
        _, out[tag] = _train(gemma, mesh, **kw)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(inp["deepseek"])
    ds_state, out["deepseek adamw"] = _train(cfg, mesh, model=model)
    arctic = arctic_config(reduced_config)
    model = lm.LM(arctic, device="cpu")
    model.load_state_dict(inp["arctic"])
    _, out["arctic adafactor"] = _train(arctic, mesh, optimizer="adafactor", model=model)

    # -- elastic restore: (4, 2) -> (2, 4) --------------------------------------
    mesh_b = make_mesh((2, 4), AXES, device="cpu")
    with tempfile.TemporaryDirectory() as d0:
        d = [d0]
        dist.broadcast_object_list(d, src=0)
        w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        t = {"w": rules.shard_tensor(w, mesh, rules.placements(rules.P("data", "model"), mesh))}
        ck.save(os.path.join(d[0], "w"), 7, t)
        back, step = ck.restore(os.path.join(d[0], "w"), t,
                                shardings={"w": rules.NamedSharding(mesh_b, rules.P("model", "data"))})
        out["elastic"] = {"step": step, "placements": [str(p) for p in back["w"].placements],
                          "mesh": tuple(back["w"].device_mesh.shape), "value": _full(back["w"])}
        # a spec out of the mesh's order (JAX's ("model", "data"): model-major)
        spec = rules.P(("model", "data"), None)
        part = rules.spec_part(w, mesh, spec)
        out["spec_full"] = {"block": part.clone(),
                            "whole": torch.equal(comm.spec_full(part, mesh, spec), w)}
        # the deepseek training state, saved from (4, 2), resumed onto (2, 4)
        ck.save(os.path.join(d[0], "state"), 2, tstep.state_tensors(ds_state))
        fresh = tstep.init_state(cfg, device="cpu", mesh=mesh_b,
                                 generator=torch.Generator().manual_seed(5))
        tensors, _ = ck.restore(os.path.join(d[0], "state"), tstep.state_tensors(fresh))
        tstep.load_state_tensors(fresh, tensors)
        same = all(torch.equal(_full(a), _full(b)) for a, b in zip(
            tstep.state_tensors(fresh).values(), tstep.state_tensors(ds_state).values()))
        out["state_remesh"] = {"equal": same, "step": fresh["step"],
                               "mesh": tuple(fresh["model"].embed.device_mesh.shape)}
        # the loop: 2 steps on (4, 2), an elastic restart onto (2, 4) for the third
        from repro_torch.data.synthetic import TokenStream
        from repro_torch.train import loop

        stream = TokenStream(vocab_size=gemma.vocab_size, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
        kw = dict(peak_lr=TRAIN_LR, warmup=1, log_every=1, async_save=False, device="cpu")
        _, h1 = loop.train(gemma, stream, steps=2, mesh=mesh, ckpt_dir=os.path.join(d[0], "loop"),
                           ckpt_every=2, log=lambda m: None, **kw)
        logged = []
        _, h2 = loop.train(gemma, stream, steps=3, mesh=mesh_b,
                           ckpt_dir=os.path.join(d[0], "loop"), log=logged.append, **kw)
        out["loop"] = {"losses": [h["loss"] for h in h1 + h2],
                       "steps": [h["step"] for h in h1 + h2], "logged": logged}
        dist.barrier()

    # -- constrain on DTensors ------------------------------------------------
    odd = rules.shard_tensor(torch.ones(3, 7), mesh, rules.placements(rules.P(), mesh))
    even = rules.shard_tensor(torch.ones(8, 4), mesh, rules.placements(rules.P(), mesh))
    out["constrain"] = [
        [str(p) for p in rules.constrain(x, rules.P("data", "model"), mesh).placements]
        for x in (odd, even)]

    # -- sharded generate --------------------------------------------------------
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(inp["deepseek"])
    lm.shard_model(model, mesh)
    out["generate"] = generate(model, inp["prompts"], steps=6, device="cpu", mesh=mesh)

    # -- the model axis's layouts ------------------------------------------------
    for tag in LAYOUT_CASES:
        out[tag] = _layout_case(tag, inp["layout"][tag], mesh)

    # -- decode over the model axis ----------------------------------------------
    out["decode"] = {tag: _decode_case(tag, inp["decode"][tag], mesh) for tag in DECODE_CASES}

    if rank == 0:
        torch.save(out, os.path.join(out_dir, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()


def main(out_dir: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")])
    from repro_torch.launch.mesh import free_port

    mp.spawn(rank_main, args=(out_dir, free_port()), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
