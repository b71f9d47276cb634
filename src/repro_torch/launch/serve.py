"""Serving launcher: batched greedy generation (the counterpart of
`repro.launch.serve`).

    python -m repro_torch.launch.serve --arch gemma-7b [--reduced] [--layers N] \\
        --requests 8 --prompt-len 1024 --gen-len 32 [--device cuda] [--seed 0]

``--arch`` takes each ported arch (`configs.ARCHS`: gemma-7b, qwen2-72b,
starcoder2-7b, h2o-danube-3-4b, arctic-480b, deepseek-v3-671b, zamba2-2.7b,
xlstm-125m, llama-3.2-vision-11b, seamless-m4t-large-v2).  ``--layers N`` keeps the first N layers of the published
config, across runs of block kinds: qwen2-72b's 80 (~145 GB of bf16
weights) do not fit one 80 GB card, nor arctic-480b's 35 (~27.2 GB a layer;
2 fit) or deepseek-v3-671b's 61 (4, 3 dense MLA and 1 MLA-MoE, are ~30 GB).
zamba2-2.7b (~4.8 GB), xlstm-125m (~0.3 GB), llama-3.2-vision-11b (~16 GB)
and seamless-m4t-large-v2 (~3.3 GB) need no ``--layers``; a zamba2-2.7b
prompt past its shared block's 4096-slot ring raises `ValueError`.

Parameters come from the model's own seeded init (no weights are
downloaded or needed); prompts from ``np.random.default_rng(seed)``; a
cross-attention arch's context input (`configs.extra_inputs`:
llama-3.2-vision-11b's ``image_embeds`` (B, 1600, 4096), seamless's
``audio_frames`` (B, min(prompt_len, 4096), 1024)) from the model's
generator after the init, standard normals in the weights' dtype times
0.02, as JAX's launcher makes them (`make_extras`).  The
device defaults to CUDA and the launcher raises without one; ``--device
cpu --reduced`` runs the plain versions on the CPU.

Under torchrun (``WORLD_SIZE`` set) every rank builds the same model,
shards it over a ("data", "model") mesh of the world
(`launch.mesh.make_host_mesh`, as JAX's launcher serves on its host mesh)
and generates its rows of the requests; every rank prints every row's
tokens.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import extra_inputs, get_config, reduced_config
from ..core.device import resolve_device
from ..models.lm import LM, shard_model
from ..serve.cv_engine import generate


def make_extras(cfg, batch: int, seq: int, *, generator: torch.Generator, device) -> dict:
    """The context inputs of `cfg` for `batch` prompts of `seq` tokens
    (`configs.extra_inputs`): normals drawn from `generator` on `device`,
    rounded to the input's dtype, then times 0.02 (JAX's launcher)."""
    return {
        name: torch.randn(shape, generator=generator, device=device).to(getattr(torch, dt)) * 0.02
        for name, (shape, dt) in extra_inputs(cfg, batch, seq).items()
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.reduced:
        cfg = reduced_config(args.arch)
    else:
        cfg = get_config(args.arch, n_layers=args.layers)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = LM(cfg, device=dev, generator=gen)
    extras = make_extras(cfg, args.requests, args.prompt_len, generator=gen, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int64)
    )

    mesh = None
    if "WORLD_SIZE" in os.environ:
        from .mesh import init_process_group, make_host_mesh

        init_process_group(dev)
        mesh = make_host_mesh(device=dev)
        shard_model(model, mesh)
    t0 = time.perf_counter()
    out = generate(model, prompts, steps=args.gen_len, extras=extras, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_s = time.perf_counter() - t0
    toks = args.requests * args.gen_len

    def say(line: str) -> None:
        # one write a line: the ranks under torchrun share one stdout
        print(line + "\n", end="", flush=True)

    say(f"[serve] {cfg.name} on {dev}: generated {toks} tokens in {dt_s:.2f}s "
        f"({toks / dt_s:.1f} tok/s, first call, kernel builds included) - "
        f"output shape {tuple(out.shape)}")
    for name, t in extras.items():
        say(f"[serve] context input {name} {tuple(t.shape)} {t.dtype}")
    say(f"[serve] first request tokens: {out[0].tolist()}")


if __name__ == "__main__":
    main()
