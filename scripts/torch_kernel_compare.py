#!/usr/bin/env python3
"""Time the window kernel (`stencil_chain`), the BoW nearest-word search
(`bow_assign`, `bow_quantize_hist`), the GBDT head (`gbdt_score`) and the
seed kernels (`seed_gaussian_blur`, `seed_erode`, `seed_threshold`) of the
checkout in the working directory, on one NVIDIA GPU, so that two checkouts
can be compared in one run on one card.

    python3 scripts/torch_kernel_compare.py build TAG [GROUP ...]  # nvcc the sources only
    python3 scripts/torch_kernel_compare.py time TAG [GROUP ...]   # -> chiprun_out/torch_kernel_compare_TAG.json

GROUPs: ``stencil``, ``bow``, ``gbdt``, ``seed`` (default: all four); only
their sources are built.  Run from a checkout's root (it imports that
checkout's ``src/repro_torch`` and builds its ``csrc/*.cu``); to compare
an older commit, unpack it with ``git archive`` into a directory that
.gitignore lists and run this file from there, in turns (older, newer,
newer, older).  Shapes: the 24 image-path shapes of chip_smoke.py phase 5
in window mode (filter2D k = 3..13 at 1080p / 4K u8, erode r = 1..3 at
1080p-8K u8, the acceptance and preprocess chains on (8, 512, 512, 3), one
512x512 octave), the octave of a BoW request (256 planes of 32x32 f32),
pyrUp at 1080p / 4K u8, the 4-octave pyramid's links at 512x512, 1080p and
4K and the warp -> ladder chain on 512x512 f32, all in window mode; then
`bow_assign` at 32,000 x 128 x 250 and `bow_quantize_hist` at a request
of 256 x 32 x 128 (K = 250, bool valids); `gbdt_score` at a request of 256
histograms of 250 words against 16 trees of depth 3 and 10 classes, beside
the launch floor; the
seed kernels on one 512x512 u8 plane (blur k = 5, erode r = 1, 2, 3, 7,
12, 32, threshold 100), the seed rung (`seed_pipeline` on (8, 512, 512, 3)
u8, 72 launches) and the launch floor (a one-element in-place add, the
shortest kernel PyTorch launches); and, for the bow group,
`bow_quantize_hist` with fractional weights run 20 times (distinct results,
difference from the plain version).  Each is timed as the faster of two
CUDA-event means of 20 calls (``ms``, host issue included) and of two
replays of a CUDA graph of 20 calls (``graph_ms``, device time); the gbdt
and seed groups also as two replays of a graph of 100 calls by
`scripts/torch_pipeline_bench.py`'s `graph_ms` (``graph100_ms``, as
chip_smoke.py times them).  Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
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
GROUPS = {"stencil": "stencil_chain", "bow": "bow", "gbdt": "gbdt", "seed": "unfused"}


def build(B, sources) -> float:
    """nvcc `sources` with the checkout's own flags, in parallel."""
    t0 = time.perf_counter()
    procs = []
    for name in sources:
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


def bow_cases(dev) -> dict:
    import torch

    from repro_torch.kernels import bow as kbow

    gen = torch.Generator(device=dev).manual_seed(1)
    desc = torch.rand((32000, 128), generator=gen, device=dev)
    cents = torch.rand((250, 128), generator=gen, device=dev)
    descs = torch.rand((256, 32, 128), generator=gen, device=dev)
    valids = torch.rand((256, 32), generator=gen, device=dev) < 0.9
    return {
        "bow_assign 32000x128x250": lambda: kbow.bow_assign(desc, cents),
        "bow_quantize_hist 256x32x128, K=250": lambda: kbow.bow_quantize_hist(descs, valids, cents),
    }


def hist_determinism(dev, runs: int = 20) -> dict:
    """`bow_quantize_hist` (unnormalised) with fractional weights at the
    request's shape, `runs` times: how many distinct results, and the
    largest difference from the plain version (which adds in ascending n)."""
    import torch

    from repro_torch.kernels import bow as kbow

    gen = torch.Generator(device=dev).manual_seed(4)
    descs = torch.rand((256, 32, 128), generator=gen, device=dev)
    cents = torch.rand((250, 128), generator=gen, device=dev)
    w = torch.rand((256, 32), generator=gen, device=dev)
    outs = [kbow.bow_quantize_hist(descs, w, cents, normalize=False) for _ in range(runs)]
    want = kbow.quantize_hist_plain(descs, w, cents)
    distinct = [o for i, o in enumerate(outs) if not any(torch.equal(o, p) for p in outs[:i])]
    res = {"runs": runs, "distinct_results": len(distinct),
           "max_abs_diff_from_plain": max(float((o - want).abs().max()) for o in outs),
           "images_differing_from_plain": max(int((o != want).any(1).sum()) for o in outs)}
    print(f"bow_quantize_hist, fractional weights, {runs} runs: {res}", flush=True)
    return res


def gbdt_cases(dev) -> dict:
    import torch

    from repro_torch.kernels import gbdt as kgbdt

    gen = torch.Generator(device=dev).manual_seed(2)
    T, depth, C, F = 16, 3, 10, 250
    x = torch.rand((256, F), generator=gen, device=dev)
    x = x / x.sum(1, keepdim=True)
    feat = torch.randint(0, F, (T, depth), generator=gen, device=dev, dtype=torch.int32)
    thr = torch.rand((T, depth), generator=gen, device=dev) * 0.008
    leaf = torch.randn((T, 2**depth, C), generator=gen, device=dev)
    base = torch.randn((C,), generator=gen, device=dev)
    one = torch.zeros(1, device=dev)
    return {"launch floor one.add_(1)": lambda: one.add_(1),
            "gbdt_score 256x250, 16 trees of depth 3, C=10":
            lambda: kgbdt.gbdt_score(x, feat, thr, leaf, base)}


def seed_cases(dev) -> dict:
    import torch

    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import unfused

    st = ImageStream()
    plane = st.image((512, 512), seed=4).to(dev).contiguous()
    batch = torch.stack([st.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    one = torch.zeros(1, device=dev)
    return {
        # the launch floor: the shortest kernel PyTorch launches, no kernel of the port
        "launch floor one.add_(1)": lambda: one.add_(1),
        "seed_gaussian_blur 512x512 u8 k=5": lambda: unfused.seed_gaussian_blur_2d(plane, 5),
        **{f"seed_erode 512x512 u8 r={r}": lambda r=r: unfused.seed_erode_2d(plane, r)
           for r in (1, 2, 3, 7, 12, 32)},
        "seed_threshold 512x512 u8 t=100": lambda: unfused.seed_threshold_2d(plane, 100.0),
        "seed rung (8,512,512,3) u8, 72 launches": lambda: unfused.seed_pipeline(
            batch, blur_ksize=5, erode_r=1, thresh=100.0),
    }


def pipeline_graph_ms():
    """`scripts/torch_pipeline_bench.py`'s `graph_ms`, which chip_smoke.py
    times the seed kernels and the launch floor with (a graph of 100 calls)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_pipeline_bench", Path(__file__).resolve().parent / "torch_pipeline_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graph_ms


def main() -> int:
    mode, tag = sys.argv[1], sys.argv[2]
    groups = sys.argv[3:] or list(GROUPS)
    sources = [GROUPS[g] for g in groups]
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CWD / "src"))
    from repro_torch.kernels import _build as B

    if mode == "build":
        print(f"{tag}: built {sources} in {build(B, sources):.1f} s")
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for name in sources:
        B._LIBS[name] = ctypes.CDLL(str(B.lib_path(name)))
        log = B.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line or "spill" in line:
                print(f"{tag} ptxas[{name}]: {line.strip()}")
    from repro_torch.kernels.stencil import exec_window

    dev = torch.device("cuda")
    results = {"card": card, "tag": tag, "times": {}}
    if "stencil" in groups:
        for name, (x, chain) in cases(dev).items():
            fn = lambda x=x, chain=chain: exec_window.stencil_chain(x, chain)  # noqa: E731
            t = {"ms": min(event_ms(fn), event_ms(fn)),
                 "graph_ms": min(graph_ms(fn), graph_ms(fn))}
            results["times"][name] = t
            print(f"{tag} {name}: ms={t['ms']:.5f} graph_ms={t['graph_ms']:.5f}", flush=True)
    calls, seed_calls = {}, {}
    for group, make in (("bow", bow_cases), ("gbdt", gbdt_cases), ("seed", seed_cases)):
        if group in groups:
            made = make(dev)
            calls |= made
            if group in ("gbdt", "seed"):
                seed_calls |= made
    graph100 = pipeline_graph_ms() if seed_calls else None
    for name, fn in calls.items():
        t = {"ms": min(event_ms(fn, 50), event_ms(fn, 50)),
             "graph_ms": min(graph_ms(fn), graph_ms(fn))}
        extra = ""
        if name in seed_calls:
            # also as chip_smoke.py times them: one graph of 100 calls, twice
            t["graph100_ms"] = [graph100(fn, reps=100), graph100(fn, reps=100)]
            extra = f" graph100_ms={t['graph100_ms'][0]:.5f}/{t['graph100_ms'][1]:.5f}"
        results["times"][name] = t
        print(f"{tag} {name}: ms={t['ms']:.5f} graph_ms={t['graph_ms']:.5f}{extra}", flush=True)
    if "bow" in groups:
        results["hist_fractional_weights"] = hist_determinism(dev)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_kernel_compare_{tag}.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
