#!/usr/bin/env python3
"""Time the two stencil kernels of the port on the image path's shapes, under
several launch configurations, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/torch_stencil_sweep.py [--quick]

For each shape (the paper's filter2D and erode benches, the acceptance and
BoW preprocess chains, one octave ladder) it times `stencil_stream` in the
mode `mode=None` resolves to under each configuration (the thread ceiling
`exec_streaming.MAX_THREADS`, row segments, column tile), and `stencil_chain` (mode "window") once,
with CUDA events (the faster of two runs of 20 calls), after holding every
configuration's output equal to the window kernel's bit for bit.  Prints a
table and writes ``chiprun_out/stencil_sweep.json``.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def cases(dev, stencil, ref, features, ImageStream):
    import torch

    s = ImageStream()
    hd, k4 = s.image((1080, 1920), seed=0).to(dev), s.image((2160, 3840), seed=0).to(dev)
    e8 = s.image((4320, 7680), seed=1).to(dev)

    def g2d(k):
        k1 = ref.gaussian_kernel1d(k)
        return (stencil.filter_stage(torch.outer(k1, k1)),)

    batch = torch.stack([s.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    bow = torch.stack([s.image((32, 32), channels=3, seed=b) for b in range(256)]).to(dev)
    return [
        ("gaussian_filter2d k=3 1080p u8", hd, g2d(3)),
        ("gaussian_filter2d k=13 1080p u8", hd, g2d(13)),
        ("gaussian_filter2d k=5 4K u8", k4, g2d(5)),
        ("gaussian_filter2d k=13 4K u8", k4, g2d(13)),
        ("erode r=1 4K u8", k4, (stencil.erode_stage(1),)),
        ("erode r=3 8K u8", e8, (stencil.erode_stage(3),)),
        ("acceptance (8,512,512,3) u8", batch,
         (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.threshold_stage(100.0))),
        ("preprocess (8,512,512,3) f32", batch.float(),
         (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())),
        ("octave (512,512) f32", s.image((512, 512), seed=2).to(dev).float(),
         features.octave_chain(4, with_next_base=False)),
        ("preprocess (256,32,32,3) f32", bow.float(),
         (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())),
    ]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="the first three shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stencil_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.device import LaunchConfig
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import ref, stencil
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    todo = cases(dev, stencil, ref, features, ImageStream)
    for name, img, chain in todo[:3] if args.quick else todo:
        planes = ref.to_planes(img)
        mode = stencil.resolve_mode(chain, planes.shape, planes.dtype)
        tiled = mode == "tiled2d"
        base = LaunchConfig()
        prog, _ = exec_streaming.program(chain, base.stream_rows, planes.dtype, dev)
        g0 = exec_streaming.stream_geometry(prog, tuple(planes.shape), base, tiled=tiled, sms=sms)
        want = exec_window.stencil_chain(planes, chain)
        configs = {"default": (base, exec_streaming.MAX_THREADS)}
        for t in (128, 256, 512):
            configs[f"threads<={t}"] = (base, t)
        for f in (0.5, 2, 4):
            lc = dataclasses.replace(base, row_segments=max(1, int(f * g0.n_seg)))
            configs[f"segments x{f}"] = (lc, exec_streaming.MAX_THREADS)
        if tiled:
            for tw in (g0.tile_w // 2, g0.tile_w // 4):
                if tw >= 32:
                    lc = dataclasses.replace(base, tile2d_cols=tw)
                    configs[f"tile={tw}"] = (lc, exec_streaming.MAX_THREADS)
        t_win = min(time_ms(lambda: exec_window.stencil_chain(planes, chain)) for _ in range(2))
        print(f"{name}: mode={mode} default geometry {g0}; window_ms={t_win:.5f}")
        for label, (lc, threads) in configs.items():
            # the block's thread ceiling is a module constant of the kernel's wrapper
            exec_streaming.MAX_THREADS = threads
            got = exec_streaming.stencil_stream(planes, chain, lc, tiled=tiled)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{name} {label}: differs from the window kernel")
            g = exec_streaming.stream_geometry(prog, tuple(planes.shape), lc, tiled=tiled, sms=sms)
            t = min(time_ms(lambda: exec_streaming.stencil_stream(planes, chain, lc, tiled=tiled))
                    for _ in range(2))
            blocks = planes.shape[0] * g.n_tiles * g.n_seg
            print(f"  {label:20s} ms={t:.5f} tile={g.tile_w} tiles={g.n_tiles} "
                  f"segments={g.n_seg}x{g.seg_rows} blocks={blocks} threads={g.threads} "
                  f"smem={g.smem_bytes}")
            rows.append({"shape": name, "mode": mode, "config": label, "ms": t,
                         "window_ms": t_win, "tile_w": g.tile_w, "n_tiles": g.n_tiles,
                         "n_seg": g.n_seg, "seg_rows": g.seg_rows, "blocks": blocks,
                         "smem_bytes": g.smem_bytes, "threads": g.threads})
        exec_streaming.MAX_THREADS = configs["default"][1]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "stencil_sweep.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
