"""Serving launcher: batched greedy generation (the counterpart of
`repro.launch.serve`).

    python -m repro_torch.launch.serve --arch gemma-7b [--reduced] [--layers N] \\
        --requests 8 --prompt-len 1024 --gen-len 32 [--device cuda] [--seed 0]

``--arch`` takes each ported arch (`configs.ARCHS`: gemma-7b, qwen2-72b,
starcoder2-7b, h2o-danube-3-4b, arctic-480b, deepseek-v3-671b, zamba2-2.7b,
xlstm-125m).  ``--layers N`` keeps the first N layers of the published
config, across runs of block kinds: qwen2-72b's 80 (~145 GB of bf16
weights) do not fit one 80 GB card, nor arctic-480b's 35 (~27.2 GB a layer;
2 fit) or deepseek-v3-671b's 61 (4, 3 dense MLA and 1 MLA-MoE, are ~30 GB).
zamba2-2.7b (~4.8 GB) and xlstm-125m (~0.3 GB) need no ``--layers``; a
zamba2-2.7b prompt past its shared block's 4096-slot ring raises
`ValueError`.

Parameters come from the model's own seeded init (no weights are
downloaded or needed); prompts from ``np.random.default_rng(seed)``.  The
device defaults to CUDA and the launcher raises without one; ``--device
cpu --reduced`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..models.lm import LM
from ..serve.cv_engine import generate


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
    model = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int64)
    )

    t0 = time.perf_counter()
    out = generate(model, prompts, steps=args.gen_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_s = time.perf_counter() - t0
    toks = args.requests * args.gen_len
    print(
        f"[serve] {cfg.name} on {dev}: generated {toks} tokens in {dt_s:.2f}s "
        f"({toks / dt_s:.1f} tok/s, first call, kernel builds included) - "
        f"output shape {tuple(out.shape)}"
    )
    print("[serve] first request tokens:", out[0].tolist())


if __name__ == "__main__":
    main()
