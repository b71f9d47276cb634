"""Where the time of BoW predict requests, or of a training, goes on the card
(PyTorch port).

    python3 scripts/torch_predict_profile.py [--head svm|gbdt] [--batch 256] [--requests 3]
    python3 scripts/torch_predict_profile.py --path train [--head svm|gbdt]

Trains a model on the card (N_TRAIN = 1000 ImageStream images, 250 words,
the §4.5 config, k-means seeded at 0), warms the card up, then traces with
`torch.profiler` either `--requests` predict requests of `--batch` 32x32x3
images (``--path predict``) or one more training of the same model
(``--path train``), and prints:

  * the host-clock stage times of `pipeline.predict` (per request) or of
    `pipeline.train`;
  * the device time by kernel name, the port's own kernels first;
  * the device busy share: summed kernel time over the traced wall time.

Needs a CUDA device; writes the same report to
``chiprun_out/torch_<path>_profile_<head>.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN = 1000  # the §4.5 training size, as in chip_smoke.py
OWN_KERNELS = (
    "stencil_chain_kernel",
    "stencil_stream_kernel",
    "quantize_hist_kernel",
    "linear_score_kernel",
    "bow_assign_kernel",
    "gbdt_score_kernel",
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("predict", "train"), default="predict")
    ap.add_argument("--head", choices=("svm", "gbdt"), default="svm")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_predict_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.cv import pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.data.synthetic import ImageStream

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    cfg = PipelineConfig(preprocess=True, n_octaves=1, max_kp=32, head=args.head)
    stream = ImageStream(res=32)
    imgs, labels = stream.batch(N_TRAIN, split="train")

    def train(timing=None):
        gen = torch.Generator().manual_seed(0)
        return pipeline.train(
            imgs, labels, cfg, dict_size=250, generator=gen, device="cuda", timing=timing
        )

    model = train()  # also the warm-up of the training path
    test, _ = stream.batch(args.batch * (args.requests + 2), split="test")
    batches = [b.to("cuda") for b in test.split(args.batch)]
    for xb in batches[:2]:
        pipeline.predict(model, xb, cfg)
    torch.cuda.synchronize()

    stages = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.path == "train":
            timing = {}
            train(timing)
            stages.append(timing)
        else:
            for xb in batches[2:]:
                timing = {}
                pipeline.predict(model, xb, cfg, timing=timing)
                stages.append(timing)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total, calls = by_kernel.get(e.key, (0.0, 0))
        by_kernel[e.key] = (total + t, calls + e.count)
    busy_us = sum(t for t, _ in by_kernel.values())
    own = [kv for kv in by_kernel.items() if any(k in kv[0] for k in OWN_KERNELS)]
    rows = own + sorted((kv for kv in by_kernel.items() if kv not in own), key=lambda kv: -kv[1][0])

    what = (
        f"1 training of {N_TRAIN} images"
        if args.path == "train"
        else f"{args.requests} requests of {args.batch}"
    )
    print(f"card: {card}")
    for i, s in enumerate(stages):
        print(f"{args.path} {i}: " + " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in s.items()))
    print(
        f"traced {what}, head {args.head}: wall {wall_us / 1e3:.3f} ms, "
        f"kernels {busy_us / 1e3:.3f} ms, device busy {busy_us / wall_us:.4f}"
    )
    print(f"{'device us':>12} {'calls':>7}  kernel")
    for name, (t, n) in rows[:25]:
        print(f"{t:12.1f} {n:7d}  {name[:110]}")
    out = {
        "card": card,
        "path": args.path,
        "head": args.head,
        "train_images": N_TRAIN,
        "batch": args.batch,
        "requests": args.requests,
        "stages_s": stages,
        "wall_us": wall_us,
        "kernel_us": busy_us,
        "device_busy_share": busy_us / wall_us,
        "kernels": {k: {"device_us": t, "calls": n} for k, (t, n) in rows},
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = f"torch_{args.path}_profile_{args.head}.json"
    (out_dir / name).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
