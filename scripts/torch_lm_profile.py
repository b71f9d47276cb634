"""Where the time of LM serving goes on the card (PyTorch port).

    python3 scripts/torch_lm_profile.py [--arch gemma-7b] [--layers N] [--reduced]
        [--requests 8] [--prompt-len 1024] [--decode-steps 8]

Builds ``--arch`` (any of `configs.ARCHS`) at full width (``--layers`` keeps
its first N layers, as qwen2-72b, arctic-480b and deepseek-v3-671b need on one
80 GB card: 8, 2 and 4 in chip_smoke.py; or ``--reduced``) on the card from a seeded
generator, warms up with one `generate`, then traces with `torch.profiler`
one prefill of ``--requests`` x ``--prompt-len`` tokens and, separately,
``--decode-steps`` decode steps against the prefill's cache, and prints for
each:

  * the host wall time (work ending in a synchronise) and the summed
    kernel time, whose ratio is the device busy share;
  * the device time by kernel name, `flash_attention`'s kernel first;
  * the host and device time of named spans (`SPANS`): each block kind's
    apply and, inside them, the Mamba2 in_proj GEMM, causal conv and SSD
    scan, the mLSTM chunkwise cell and step, the sLSTM scan (a Python loop
    of small launches), the cross-attention (its q projection, the kernel
    call, w_o and the gate) and the attention call.  Spans nest: a block's span
    holds its parts', and what a block's span holds beyond its parts is
    the rest of the block (out_proj, the norms, the gates).

zamba2-2.7b, xlstm-125m, llama-3.2-vision-11b and seamless-m4t-large-v2 run
at full depth (``--layers`` not needed); the last two get their context
input (`launch.serve.make_extras`, from the model's generator after the
init) and, cross-attention being the point, their gates set to 0.5 (JAX's
init: 0).
Needs a CUDA device; writes the same report to
``chiprun_out/torch_lm_profile_<arch>.json``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OWN_KERNELS = ("flash_attn_wgmma_kernel", "flash_attn_simt_kernel")
# (module, function) wrapped in a `record_function` span of that name while
# tracing; each is looked up as a module global by its callers
SPANS = (
    ("blocks", "apply_block"),
    ("blocks", "apply_block_decode"),
    ("ssm", "_split_in_proj"),
    ("ssm", "_causal_conv"),
    ("ssm", "conv_step"),
    ("ssm", "ssd_scan"),
    ("xlstm", "mlstm_chunkwise"),
    ("xlstm", "mlstm_step"),
    ("xlstm", "slstm_scan"),
    ("attention", "cross_attn"),
    ("attention", "attention"),
)


def _spans(torch, modules: dict) -> None:
    """Wrap each `SPANS` function in a span; a block's span is named by its
    kind (``apply_block mamba``)."""
    from torch.profiler import record_function

    for mod_name, fn_name in SPANS:
        mod = modules[mod_name]
        fn = getattr(mod, fn_name)

        def wrapped(*a, _fn=fn, _name=f"{mod_name}.{fn_name}", **k):
            name = f"{_name} {a[0]}" if _name.startswith("blocks.") else _name
            with record_function(name):
                return _fn(*a, **k)

        setattr(mod, fn_name, wrapped)


def _by_span(prof, torch) -> dict:
    """Each span's host time (its host-side ranges, summed), the device time
    of the kernels inside its device-side ranges (first kernel's start to
    last kernel's end), summed, so idle gaps are left out, and those
    ranges' length."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == cuda and not _is_span(e.name))
    starts = [k[0] for k in kernels]
    out = {}
    for e in events:
        if not _is_span(e.name):
            continue
        row = out.setdefault(e.name, {"host_us": 0.0, "kernel_us": 0.0, "device_span_us": 0.0,
                                      "calls": 0})
        a, b = e.time_range.start, e.time_range.end
        if e.device_type != cuda:
            row["host_us"] += b - a
            row["calls"] += 1
            continue
        row["device_span_us"] += b - a
        i = bisect.bisect_left(starts, a)
        while i < len(kernels) and kernels[i][0] < b:
            row["kernel_us"] += min(kernels[i][1], b) - kernels[i][0]
            i += 1
    return out


def _is_span(key: str) -> bool:
    return key.split(" ")[0] in {f"{m}.{f}" for m, f in SPANS}


def _by_kernel(prof, torch) -> dict:
    """Device time and calls by kernel name (the spans' device-side
    annotations left out)."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or _is_span(e.key):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total, calls = out.get(e.key, (0.0, 0))
        out[e.key] = (total + t, calls + e.count)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import attention, blocks, lm, ssm, xlstm
    from repro_torch.serve import cv_engine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    if args.reduced:
        cfg = reduced_config(args.arch)
    else:
        cfg = get_config(args.arch, n_layers=args.layers)
    gen = torch.Generator(dev).manual_seed(0)
    model = lm.LM(cfg, device=dev, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("gate_attn", "gate_mlp")):
                p.fill_(0.5)
    extras = make_extras(cfg, args.requests, args.prompt_len, generator=gen, device=dev)
    ctx_len = lm.context_len(cfg, extras, args.requests)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    ).to(dev)
    steps = args.decode_steps
    tokens = cv_engine.generate(model, prompts, steps=steps + 1, extras=extras)  # warm-up
    torch.cuda.synchronize()

    report = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers, "reduced": args.reduced,
              "requests": args.requests, "prompt_len": args.prompt_len,
              "decode_steps": steps, "phases": {}}
    print(f"card: {card}")
    _spans(torch, {"blocks": blocks, "ssm": ssm, "xlstm": xlstm, "attention": attention})
    with torch.inference_mode():
        for phase in ("prefill", "decode"):
            if phase == "decode":
                cache = lm.init_cache(cfg, args.requests, args.prompt_len + steps,
                                      ctx_len=ctx_len, device=dev)
                cache = cv_engine._adopt_prefill(cache, pcache, cfg)
                del pcache
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    _, pcache = lm.prefill(model, prompts, extras=extras)
                else:
                    for t in range(steps):
                        _, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            by_kernel = _by_kernel(prof, torch)
            busy_us = sum(t for t, _ in by_kernel.values())
            own = [kv for kv in by_kernel.items() if any(k in kv[0] for k in OWN_KERNELS)]
            rows = own + sorted(
                (kv for kv in by_kernel.items() if kv not in own), key=lambda kv: -kv[1][0]
            )
            what = (
                f"prefill of {args.requests} x {args.prompt_len}"
                if phase == "prefill"
                else f"{steps} decode steps of {args.requests}"
            )
            print(
                f"traced {what} ({cfg.name}, {cfg.n_layers} layers"
                f"{' reduced' if args.reduced else ''}): wall "
                f"{wall_us / 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} ms, device busy "
                f"{busy_us / wall_us:.4f}, kernel launches {sum(n for _, n in by_kernel.values())}"
            )
            print(f"{'device us':>12} {'calls':>7}  kernel")
            for name, (t, n) in rows[:15]:
                print(f"{t:12.1f} {n:7d}  {name[:110]}")
            spans = _by_span(prof, torch)
            print(f"{'host us':>12} {'kernel us':>12} {'span us':>12} {'calls':>7}  span "
                  "(spans nest; kernel us: the kernels inside its device-side range, summed; "
                  "span us: that range, first kernel's start to last kernel's end)")
            for name, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_us"]):
                print(f"{v['host_us']:12.1f} {v['kernel_us']:12.1f} {v['device_span_us']:12.1f} "
                      f"{v['calls']:7d}  {name}")
            report["phases"][phase] = {
                "spans": spans,
                "wall_us": wall_us,
                "kernel_us": busy_us,
                "device_busy_share": busy_us / wall_us,
                "kernels": {k: {"device_us": t, "calls": n} for k, (t, n) in rows},
            }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"torch_lm_profile_{cfg.name}.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
