#!/usr/bin/env python3
"""Plant known faults in a copy of the flash-attention kernel and report
which of `chip_smoke.py`'s LM checks catch each one.

    python3 scripts/torch_flash_faults.py [--arch gemma-7b] [--batch 8]
        [--prompt-len 1024] [--gen-len 32] [--faults none,zeros,...]

Each fault is one textual edit of ``src/repro_torch/csrc/flash_attn.cu``.
The edited source goes to ``build/flash_faults/<fault>/`` with the shared
headers, the kernel library is rebuilt from there, and `chip_smoke.lm_phase`
runs untimed on the model at full width with every check's verdict recorded
instead of raised.  ``none`` is the unedited source, the control.  Prints
the checks each fault fails and one JSON summary (also written to
``chiprun_out/torch_flash_faults.json``).  Exits non-zero when the control
fails a check or a planted fault passes them all.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (what it breaks, the source text, its replacement)
FAULTS = {
    "zeros": (
        "every output written as 0, in every dtype",
        "f[e] = acc[r][c * PW + e] / den;",
        "f[e] = 0.f;",
    ),
    "diag_bf16": (
        "in f16 / bf16, query rows from 512 on mask their own key (one key of a late tile)",
        "const bool ok = ki < Tk && (!causal || ki <= qi);",
        "const bool ok = ki < Tk && (!causal || ki <= qi) && !(PW == 2 && ki == qi && qi >= 512);",
    ),
    "last_key_bf16": (
        "in f16 / bf16, the last key of each 64-key tile is unpacked with each odd channel "
        "of v replaced by the even one before it",
        "E::unpack(v_s[j * W + w], vf);",
        "E::unpack(v_s[j * W + w], vf);\n          if (PW == 2 && j == BKV - 1) vf[1] = vf[0];",
    ),
    "den_1pct_bf16": (
        "in f16 / bf16, every row's softmax sum is taken 1% too large",
        "const float den = fmaxf(l_s[ty * TR + r], 1e-30f);",
        "const float den = fmaxf(l_s[ty * TR + r], 1e-30f) * (PW == 2 ? 1.01f : 1.f);",
    ),
}


def plant(name: str, csrc: Path) -> Path:
    """The kernel source with fault `name` (``none``: as it is) and the
    shared headers, in a directory of their own."""
    dst = ROOT / "build" / "flash_faults" / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, dst)
    text = (csrc / "flash_attn.cu").read_text()
    if name != "none":
        _, old, new = FAULTS[name]
        if text.count(old) != 1:
            raise SystemExit(f"fault {name}: its source text is not in flash_attn.cu once")
        text = text.replace(old, new)
    (dst / "flash_attn.cu").write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--faults", default=",".join(["none", *FAULTS]))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, counters
    from repro_torch.kernels import attention as kattn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    csrc = _build.CSRC
    print(f"card: {chip_smoke.card_line()}")
    summary = {}
    for name in args.faults.split(","):
        # point the loader at the planted source; its library is keyed by
        # the source's hash, so it is built anew
        _build.CSRC = plant(name, csrc)
        _build._LIBS.pop("flash_attn", None)
        kattn._launcher.cache_clear()
        failed: list[str] = []

        def judge(ok: bool, msg: str) -> None:
            if not ok:
                failed.append(msg)

        print(f"== fault {name}: {FAULTS[name][0] if name in FAULTS else 'the source as it is'}")
        out = chip_smoke.lm_phase(
            dev, cfg, batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len,
            max_err=dict.fromkeys(counters.KERNELS, 0.0), judge=judge, timed=False)
        path = [c for n, c in out["checks"].items() if "of the prefill" in n]
        shapes = [c for n, c in out["checks"].items() if "JAX test shape" in n]
        summary[name] = {
            "failed_checks": failed,
            "path_share_of_tol": max(c["share_of_tol"] for c in path),
            "path_share_of_jax_test_tol": max(c["share_of_jax_test_tol"] for c in path),
            "path_max_abs_err": max(c["max_abs_err"] for c in path),
            "jax_shapes_share_of_tol": max(c["share_of_tol"] for c in shapes),
            "hidden_f32": out["hidden_f32"],
            "prefill_logits": out["prefill_logits"],
            "tokens": out["tokens"],
        }
        print(f"== fault {name}: {len(failed)} checks failed")
        for msg in failed:
            print(f"   failed: {msg}")
    _build.CSRC = csrc

    bad = [n for n, s in summary.items() if (n == "none") == bool(s["failed_checks"])]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "torch_flash_faults.json").write_text(json.dumps(summary, indent=1))
    for n, s in summary.items():
        lg = s["prefill_logits"]
        print(f"fault {n}: {len(s['failed_checks'])} checks failed; kernel vs plain on the "
              f"path, share of the tolerance {s['path_share_of_tol']:.4g} (of the JAX test's "
              f"{s['path_share_of_jax_test_tol']:.4g}), max_abs_err {s['path_max_abs_err']:.4g}; "
              f"JAX test shapes {s['jax_shapes_share_of_tol']:.4g}; f32 hidden states "
              f"{s['hidden_f32']['share_of_tol']:.4g}; f32 logits "
              f"{lg['f32 kernel vs plain']['max']:.4g} (limit 2e-3); bf16 logits "
              f"{lg['bf16 kernel vs plain']['max']:.4g} (limit "
              f"{2 * lg['bf16 plain vs f32 plain']['max']:.4g}); tokens off the plain argmax "
              f"{s['tokens']['not_plain_argmax']} of {s['tokens']['of']}")
    if bad:
        print(f"torch_flash_faults: wrong verdict for {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
