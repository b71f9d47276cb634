"""End-to-end LM training script (the counterpart of `examples/train_lm.py`):
trains a ~20M-parameter gemma-family model with checkpoints, or with
``--full`` an arch's published config.

    PYTHONPATH=src python3 scripts/torch_train_lm.py [--steps 200] [--device cpu]

Runs on the card by default (the attention kernel builds on first use);
``--device cpu`` runs the plain versions.  Checkpoints go under
``build/train_lm_ckpt`` of the checkout unless ``--ckpt`` names another
directory; a second run resumes from the latest.  Exits non-zero if the
last logged loss is not below the first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="the arch's published config")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = (get_config(args.arch) if args.full else
           reduced_config(args.arch).replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                                             head_dim=64, d_ff=1024, vocab_size=4096,
                                             blocks=(("attn", 4),)))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=8)
    _, history = train(cfg, stream, steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=50,
                       peak_lr=1e-3, warmup=args.warmup, device=dev)
    if not history:
        print(f"nothing to do: {args.ckpt} already holds step {args.steps}")
        return 0
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over steps {history[0]['step']}-"
          f"{history[-1]['step']} on {dev}")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
