"""Training launcher (the counterpart of `repro.launch.train`).

    python -m repro_torch.launch.train --arch gemma-7b [--reduced] [--layers N] \\
        [--steps 100] [--seq S] [--batch B] [--lr 3e-4] [--optimizer adamw|adafactor] \\
        [--ckpt-dir DIR] [--ckpt-every 100] [--device cuda]

``--arch`` takes each ported arch (`configs.ARCHS`); ``--reduced`` its
CPU-sized config (seq 128 and batch 8 by default, 4096 and 256 otherwise,
as JAX's); ``--layers N`` keeps the first N layers of the published config
(`configs.get_config`), as the serving launcher does.  The data is
`data.synthetic.TokenStream`; a cross-attention arch's context input is
drawn once as `launch.serve.make_extras` draws it and fed every step.  The
device defaults to CUDA and the launcher raises without one; ``--device
cpu --reduced`` trains with the plain versions on the CPU.  JAX's mesh
flags wait for sharding (ROADMAP Queue 1 item 8 step 9), and its TPU XLA
flags have no counterpart.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..data.synthetic import TokenStream
from ..train.loop import train
from .serve import make_extras


class _WithExtras:
    """A token stream whose batches also carry fixed context inputs."""

    def __init__(self, stream, extras: dict):
        self.stream, self.extras = stream, extras

    def batch_at(self, step: int) -> dict:
        return self.stream.batch_at(step) | self.extras


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch, n_layers=args.layers)
    seq = args.seq or (128 if args.reduced else 4096)
    batch = args.batch or (8 if args.reduced else 256)
    print(f"[launch] arch={cfg.name} seq={seq} batch={batch} device={dev} "
          f"optimizer={args.optimizer}")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    extras = make_extras(cfg, batch, seq, generator=torch.Generator().manual_seed(1), device="cpu")
    state, history = train(cfg, _WithExtras(stream, extras) if extras else stream,
                           steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, optimizer=args.optimizer,
                           peak_lr=args.lr, device=dev)
    if history:
        print(f"[launch] done: loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
