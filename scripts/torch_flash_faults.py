#!/usr/bin/env python3
"""Plant known faults in a copy of the flash-attention kernel and report
which of `chip_smoke.py`'s LM checks catch each one.

    python3 scripts/torch_flash_faults.py [--arch gemma-7b] [--layers N] [--batch 8]
        [--prompt-len 1024] [--gen-len 32] [--faults none,zeros,...]

Each fault is one textual edit of ``src/repro_torch/csrc/flash_attn.cu``.
The edited source goes to ``build/flash_faults/<fault>/`` with the shared
headers, the kernel library is rebuilt from there, and `chip_smoke.lm_phase`
runs untimed on the model at full width (``--layers`` keeps the first N
layers, as `chip_smoke.LM_RUNS` cuts qwen2-72b) with every check's verdict
recorded instead of raised.  ``none`` is the unedited source, the control.  Prints
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

# name -> (what it breaks, the source text, its replacement); each fault
# edits the f16 / bf16 (wgmma) body, the serving path's
FAULTS = {
    "zeros": (
        "in f16 / bf16, every output written as 0",
        "P::pack(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);\n"
        "      if (qi1 < S)\n"
        "        *reinterpret_cast<uint32_t*>(og + size_t(qi1) * rs + ch) =\n"
        "            P::pack(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);",
        "P::pack(0.f, 0.f);\n"
        "      if (qi1 < S)\n"
        "        *reinterpret_cast<uint32_t*>(og + size_t(qi1) * rs + ch) = P::pack(0.f, 0.f);",
    ),
    "diag_bf16": (
        "in f16 / bf16, query rows from 512 on mask their own key (one key of a late tile)",
        "      const bool out0 = masked && (ki >= Tk || (causal && ki > qi0));\n"
        "      const bool out1 = masked && (ki >= Tk || (causal && ki > qi1));",
        "      const bool out0 = masked && (ki >= Tk || (causal && (ki > qi0 || (ki == qi0 && "
        "qi0 >= 512))));\n"
        "      const bool out1 = masked && (ki >= Tk || (causal && (ki > qi1 || (ki == qi1 && "
        "qi1 >= 512))));",
    ),
    "last_key_bf16": (
        "in f16 / bf16, the last key of each 64-key tile enters p.v with the probability of "
        "the key before it",
        "const float a = pf[4 * j + 2 * h], c = pf[4 * j + 2 * h + 1];",
        "const float a = pf[4 * j + 2 * h], c = (j == 7 && (lane & 3) == 3) ? a : "
        "pf[4 * j + 2 * h + 1];",
    ),
    "den_1pct_bf16": (
        "in f16 / bf16, every row's softmax sum is taken 1% too large",
        "    const float inv0 = __fdividef(1.f, fmaxf(l0, 1e-30f));\n"
        "    const float inv1 = __fdividef(1.f, fmaxf(l1, 1e-30f));",
        "    const float inv0 = __fdividef(1.f, fmaxf(l0, 1e-30f) * 1.01f);\n"
        "    const float inv1 = __fdividef(1.f, fmaxf(l1, 1e-30f) * 1.01f);",
    ),
    "kv_head_0": (
        "in f16 / bf16, every query head reads KV head 0 (the group map dropped)",
        "      const int kv_head = h / group;  // the KV head of this query head's group",
        "      const int kv_head = 0;",
    ),
    "p_lo_dropped": (
        "in f16 / bf16, p.v takes p_hi alone: one 16-bit pass of p, no p_lo",
        "    wgmma_pv<T, N>(acc, lo_d + 32 * kk / 16, vd + kk * 16 * 128 / 16);\n",
        "",
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
    ap.add_argument("--layers", type=int, default=None)
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
    cfg = get_config(args.arch, n_layers=args.layers)
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
            "path_off_plain": max(c["off_plain"] for c in path if "off_plain" in c),
            "jax_shapes_off_plain": max(c["off_plain"] for c in shapes if "off_plain" in c),
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
              f"JAX test shapes {s['jax_shapes_share_of_tol']:.4g}; share of outputs off the "
              f"plain version's {s['path_off_plain']:.4g} on the path, "
              f"{s['jax_shapes_off_plain']:.4g} on the JAX test shapes (limit "
              f"{kattn.OFF_PLAIN_SHARE:.4g}); f32 hidden states "
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
