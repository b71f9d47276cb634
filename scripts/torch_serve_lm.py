"""Batched LM serving example (the counterpart of `examples/serve_lm.py`):
prefill + greedy decode with the KV / state caches, on an arch's reduced
config.

    PYTHONPATH=src python3 scripts/torch_serve_lm.py [--arch zamba2-2.7b] [--device cpu]

Runs on the card by default (the attention kernel builds on first use);
``--device cpu`` runs the plain versions.  The parameters come from a
seeded init, the prompts (16 tokens) from a numpy seed, a cross-attention
arch's context input as `launch.serve.make_extras` draws it.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import make_extras  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.cv_engine import generate  # noqa: E402

PROMPT = 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch)
    gen = torch.Generator(dev).manual_seed(0)
    model = LM(cfg, device=dev, generator=gen)
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (args.batch, PROMPT)))
    extras = make_extras(cfg, args.batch, PROMPT, generator=gen, device=dev)
    t0 = time.perf_counter()
    out = generate(model, prompts, steps=args.gen, extras=extras, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name}] {args.batch}x{args.gen} tokens in {dt:.2f}s on {dev} (first call, "
          f"builds included); sample: {out[0][:10].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
