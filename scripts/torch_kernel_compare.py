#!/usr/bin/env python3
"""Time the window kernel (`stencil_chain`) and the BoW nearest-word search
(`bow_assign`, `bow_quantize_hist`) of the checkout in the working
directory, on one NVIDIA GPU, so that two checkouts can be compared in one
run on one card.

    python3 scripts/torch_kernel_compare.py build TAG   # nvcc the two sources only
    python3 scripts/torch_kernel_compare.py time TAG    # -> chiprun_out/torch_kernel_compare_TAG.json

Run from a checkout's root (it imports that checkout's ``src/repro_torch``
and builds its ``csrc/stencil_chain.cu`` and ``csrc/bow.cu``); to compare
an older commit, unpack it with ``git archive`` into a directory that
.gitignore lists and run this file from there, in turns (older, newer,
newer, older).  Shapes: the 24 image-path shapes of chip_smoke.py phase 5
in window mode (filter2D k = 3..13 at 1080p / 4K u8, erode r = 1..3 at
1080p-8K u8, the acceptance and preprocess chains on (8, 512, 512, 3), one
512x512 octave), the octave of a BoW request (256 planes of 32x32 f32),
pyrUp at 1080p / 4K u8, the 4-octave pyramid's links at 512x512, 1080p and
4K and the warp -> ladder chain on 512x512 f32, all in window mode; then
`bow_assign` at 32,000 x 128 x 250 and `bow_quantize_hist` at a request
of 256 x 32 x 128.  Each is timed as the faster of two CUDA-event means of
20 calls (``ms``, host issue included) and of two replays of a CUDA graph
of 20 calls (``graph_ms``, device time).  Prints the card's name and power
limit first.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CWD = Path(os.getcwd())
SOURCES = ("stencil_chain", "bow")


def build(B) -> float:
    """nvcc the two sources with the checkout's own flags, in parallel."""
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        out = B.lib_path(name)
        if out.exists():  # built already (by chip_smoke.py, say)
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(out),
               str(B.CSRC / f"{name}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        B.lib_path(name).with_suffix(".log").write_text(log)
    return time.perf_counter() - t0


def event_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (5 * reps)


def cases(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import ref, stencil

    st = ImageStream()
    out = {}
    res = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}
    for r in ("1080p", "4K"):
        img = st.image(res[r], seed=0).to(dev)[None]
        for k in (3, 5, 7, 9, 11, 13):
            k1 = ref.gaussian_kernel1d(k)
            chain = (stencil.filter_stage(torch.outer(k1, k1)),)
            out[f"gaussian_filter2d k={k} {r} u8"] = (img, chain)
    for r in ("1080p", "4K", "8K"):
        img = st.image(res[r], seed=1).to(dev)[None]
        for rad in (1, 2, 3):
            out[f"erode r={rad} {r} u8"] = (img, (stencil.erode_stage(rad),))
    batch = torch.stack([st.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    planes = ref.to_planes(batch)
    blur_erode = (stencil.gaussian_stage(5), stencil.erode_stage(1))
    out["acceptance (8,512,512,3) u8"] = (planes, blur_erode + (stencil.threshold_stage(100.0),))
    out["preprocess (8,512,512,3) f32"] = (planes.float(), blur_erode + (stencil.grad_stage(),))
    p512 = st.image((512, 512), seed=2).to(dev).float()[None]
    out["octave (512,512) f32"] = (p512, features.octave_chain(4, with_next_base=False))
    gen = torch.Generator(device=dev).manual_seed(0)
    out["octave of a request (256,32,32) f32"] = (
        torch.rand((256, 32, 32), generator=gen, device=dev) * 255.0,
        features.octave_chain(4, with_next_base=False))
    for r in ("1080p", "4K"):
        out[f"pyr_up {r} u8"] = (st.image(res[r], seed=8).to(dev)[None], (stencil.pyr_up_stage(),))
    for r, hw in (("512", (512, 512)), ("1080p", res["1080p"]), ("4K", res["4K"])):
        g = st.image(hw, seed=3).to(dev).float()[None]
        chains = features.pyramid_chains(4)
        for k, chain in enumerate(chains):
            out[f"pyramid link {k} {r} f32"] = (g, chain)
            if k < len(chains) - 1:
                g = ref.chain_ref_planes(g, chain)[-1].contiguous()
    m = np.array([[np.cos(0.05), -np.sin(0.05), 4.0], [np.sin(0.05), np.cos(0.05), -3.0]])
    out["warp -> ladder (512,512) f32"] = (p512, features.aligned_octave_chain(m, (512, 512)))
    return out


def main() -> int:
    mode, tag = sys.argv[1], sys.argv[2]
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CWD / "src"))
    from repro_torch.kernels import _build as B

    if mode == "build":
        print(f"{tag}: built {SOURCES} in {build(B):.1f} s")
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for name in SOURCES:
        B._LIBS[name] = ctypes.CDLL(str(B.lib_path(name)))
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels.stencil import exec_window

    dev = torch.device("cuda")
    results = {"card": card, "tag": tag, "times": {}}
    for name, (x, chain) in cases(dev).items():
        fn = lambda x=x, chain=chain: exec_window.stencil_chain(x, chain)  # noqa: E731
        t = {"ms": min(event_ms(fn), event_ms(fn)), "graph_ms": min(graph_ms(fn), graph_ms(fn))}
        results["times"][name] = t
        print(f"{tag} {name}: ms={t['ms']:.5f} graph_ms={t['graph_ms']:.5f}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    desc = torch.rand((32000, 128), generator=gen, device=dev)
    cents = torch.rand((250, 128), generator=gen, device=dev)
    descs = torch.rand((256, 32, 128), generator=gen, device=dev)
    valids = torch.rand((256, 32), generator=gen, device=dev) < 0.9
    for name, fn in (("bow_assign 32000x128x250", lambda: kbow.bow_assign(desc, cents)),
                     ("bow_quantize_hist 256x32x128, K=250",
                      lambda: kbow.bow_quantize_hist(descs, valids, cents))):
        t = {"ms": min(event_ms(fn, 50), event_ms(fn, 50)),
             "graph_ms": min(graph_ms(fn), graph_ms(fn))}
        results["times"][name] = t
        print(f"{tag} {name}: ms={t['ms']:.5f} graph_ms={t['graph_ms']:.5f}", flush=True)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_kernel_compare_{tag}.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
