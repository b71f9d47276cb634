"""Training launcher (the counterpart of `repro.launch.train`).

    python -m repro_torch.launch.train --arch gemma-7b [--reduced] [--layers N] \\
        [--steps 100] [--seq S] [--batch B] [--lr 3e-4] [--optimizer adamw|adafactor] \\
        [--ckpt-dir DIR] [--ckpt-every 100] [--device cuda] \\
        [--warmup 200] [--model-parallel M] [--production-mesh]
    torchrun --nproc-per-node N -m repro_torch.launch.train --arch ... --model-parallel M

``--arch`` takes each ported arch (`configs.ARCHS`); ``--reduced`` its
CPU-sized config (seq 128 and batch 8 by default, 4096 and 256 otherwise,
as JAX's); ``--layers N`` keeps the first N layers of the published config
(`configs.get_config`), as the serving launcher does.  The data is
`data.synthetic.TokenStream`; a cross-attention arch's context input is
drawn once as `launch.serve.make_extras` draws it and fed every step.  The
device defaults to CUDA and the launcher raises without one; ``--device
cpu --reduced`` trains with the plain versions on the CPU.

Under torchrun (``WORLD_SIZE`` set), or with ``--model-parallel`` above 1
or ``--production-mesh``, the launcher joins the process group
(`launch.mesh.init_process_group`: NCCL on the card, gloo on the CPU) and
trains on a ("data", "model") mesh of the world (`make_host_mesh`, model
= ``--model-parallel``) or on JAX's production mesh (256 ranks); a
single torchrun rank trains on a (1, 1) mesh.  Rank 0 prints.  JAX's TPU XLA flags have no
counterpart.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..data.synthetic import TokenStream
from ..train.loop import train
from .mesh import init_process_group, make_host_mesh, make_production_mesh
from .serve import make_extras


class _WithExtras:
    """A token stream whose batches also carry fixed context inputs."""

    def __init__(self, stream, extras: dict):
        self.stream, self.extras = stream, extras

    def batch_at(self, step: int) -> dict:
        return self.stream.batch_at(step) | self.extras


def launch_mesh(args, dev):
    """The mesh the flags ask for (joining the process group), or None."""
    import os

    import torch.distributed as dist

    if not ("WORLD_SIZE" in os.environ or args.model_parallel > 1 or args.production_mesh):
        return None
    if not dist.is_initialized():
        init_process_group(dev)
    if args.production_mesh:
        return make_production_mesh(device=dev)
    return make_host_mesh(args.model_parallel, device=dev)


def main(argv=None):
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
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="JAX's (16, 16) production mesh (256 ranks)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = launch_mesh(args, dev)
    say = print if mesh is None or mesh.get_rank() == 0 else (lambda *_: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch, n_layers=args.layers)
    seq = args.seq or (128 if args.reduced else 4096)
    batch = args.batch or (8 if args.reduced else 256)
    where = "" if mesh is None else f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    say(f"[launch] arch={cfg.name} seq={seq} batch={batch} device={dev} "
          f"optimizer={args.optimizer}{where}")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    extras = make_extras(cfg, batch, seq, generator=torch.Generator().manual_seed(1), device="cpu")
    state, history = train(cfg, _WithExtras(stream, extras) if extras else stream,
                           steps=args.steps, mesh=mesh, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, optimizer=args.optimizer,
                           peak_lr=args.lr, warmup=args.warmup, device=dev)
    if history:
        say(f"[launch] done: loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return state, history


if __name__ == "__main__":
    main()
