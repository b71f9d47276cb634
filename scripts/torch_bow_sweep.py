#!/usr/bin/env python3
"""Time `bow_quantize_hist`'s cluster kernel under other CTA geometries on one
NVIDIA GPU, each held bit-equal to the plain version first.

    python3 scripts/torch_bow_sweep.py            # -> chiprun_out/torch_bow_sweep.json

Each variant is ``src/repro_torch/csrc/bow.cu`` with some of its
``constexpr int kHist...`` constants replaced (rows and words of a CTA's
tile, threads, the micro-tile, values of q staged at a time, the CTAs an
SM its launch bounds ask for), built with the checkout's own nvcc flags
into ``build/bow_sweep/<variant>/`` (all variants in parallel) and called
through its C interface.  For each variant it prints ptxas's registers and
spills, the clusters the card holds at once
(`quantize_hist_max_clusters`), whether its histograms equal
`quantize_hist_plain`'s bit for bit, and its device time (the faster of two
replays of a CUDA graph of 20 calls) at requests of 128, 256 and 512 images
of 32 rows, D = 128, K = 250 (the predict request is 256).  Prints the
card's name and power limit first; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> constants that differ from csrc/bow.cu's own (the built CTA: 128
# words, 128 threads of 4 x 8, q chunks of 16, 4 CTAs an SM)
W64 = {"kHistWords": 64, "kHistMicroWords": 4, "kHistMinBlocks": 8}
VARIANTS = {
    "as built": {},
    "64 words, 4x4, 8 CTAs an SM": W64,
    "64 words, 4x4, 6 CTAs an SM": W64 | {"kHistMinBlocks": 6},
    "64 words, 4x4, q chunk 8": W64 | {"kHistChunk": 8},
    "64 words, 4x4, q chunk 32, 7 CTAs an SM": W64 | {"kHistChunk": 32, "kHistMinBlocks": 7},
    "64 words, 64 threads of 4x8": W64 | {"kHistThreads": 64, "kHistMicroWords": 8,
                                          "kHistMinBlocks": 12},
    "64 words, 64 threads of 8x4": W64 | {"kHistThreads": 64, "kHistMicroRows": 8,
                                          "kHistMinBlocks": 12},
    "64 words, 32 threads of 8x8": W64 | {"kHistThreads": 32, "kHistMicroRows": 8,
                                          "kHistMicroWords": 8, "kHistMinBlocks": 13},
    "3 CTAs an SM": {"kHistMinBlocks": 3},
    "6 CTAs an SM": {"kHistMinBlocks": 6},
    "q chunk 8": {"kHistChunk": 8},
    "q chunk 32": {"kHistChunk": 32},
    "128 words, 8x4": {"kHistMicroRows": 8, "kHistMicroWords": 4, "kHistMinBlocks": 6},
    "128 words, 8x8, 64 threads, 8 an SM": {"kHistMicroRows": 8, "kHistThreads": 64,
                                            "kHistMinBlocks": 8},
    "128 words, 8x8, 64 threads, 4 an SM": {"kHistMicroRows": 8, "kHistThreads": 64,
                                            "kHistMinBlocks": 4},
    "256 words, 8x8, 4 an SM": {"kHistWords": 256, "kHistMicroRows": 8, "kHistMinBlocks": 4},
    "256 words, 8x8, 2 an SM": {"kHistWords": 256, "kHistMicroRows": 8, "kHistMinBlocks": 2},
    "256 words, 4x8, 256 threads": {"kHistWords": 256, "kHistThreads": 256,
                                    "kHistMinBlocks": 2},
}
BATCHES = (128, 256, 512)


def variant_source(src: str, consts: dict) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"csrc/bow.cu has no single constant {name}")
    return src


def build(B, out_root: Path) -> dict:
    """nvcc every variant in parallel; -> name -> (library path, ptxas log)."""
    src = (B.CSRC / "bow.cu").read_text()
    procs = {}
    for i, (name, consts) in enumerate(VARIANTS.items()):
        d = out_root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "bow.cu").write_text(variant_source(src, consts))
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(d / "libbow.so"),
               str(d / "bow.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        built[name] = (d / "libbow.so", log)
    return built


def hist_report(log: str) -> str:
    """ptxas's registers and spills of quantize_hist_kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "quantize_hist_kernel" in line:
            report = []
            for x in lines[i + 1:]:
                if "spill" in x or "registers" in x:
                    report.append(x.replace("ptxas info    :", "").strip())
                if "registers" in x:
                    break
            return "; ".join(report)
    return "not found"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bow_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import bow as kbow
    from torch_kernel_compare import graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    t0 = time.perf_counter()
    built = build(B, ROOT / "build" / "bow_sweep")
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cents = torch.rand((250, 128), generator=gen, device=dev)
    inputs = {}
    for b in BATCHES:
        descs = torch.rand((b, 32, 128), generator=gen, device=dev)
        valids = torch.rand((b, 32), generator=gen, device=dev) < 0.9
        inputs[b] = (descs, valids, kbow.quantize_hist_plain(descs, valids, cents, normalize=True))
    K, D, N = cents.shape[0], cents.shape[1], 32
    results = {"card": card, "variants": {}}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.quantize_hist_launch
        fn.argtypes = kbow.LAUNCH_ARGTYPES["quantize_hist_launch"]
        fn.restype = ctypes.c_int
        clusters = lib.quantize_hist_max_clusters(K)
        ranks = lib.quantize_hist_ranks(K)
        row = {"ptxas": hist_report(log), "consts": VARIANTS[name], "ranks": ranks,
               "max_clusters": clusters, "graph_ms": {}, "bit_equal": True}
        for b, (descs, valids, want) in inputs.items():
            out = torch.empty((b, K), device=dev)

            def call(descs=descs, valids=valids, out=out, b=b):
                err = fn(descs.data_ptr(), valids.data_ptr(), 1, cents.data_ptr(), out.data_ptr(),
                         b, N, D, K, 1, B.cuda_stream(dev))
                B.check(err, f"variant {name}")

            call()
            torch.cuda.synchronize()
            row["bit_equal"] &= bool(torch.equal(out, want))
            row["graph_ms"][b] = min(graph_ms(call), graph_ms(call))
        results["variants"][name] = row
        times = " ".join(f"B={b}: {t:.5f}" for b, t in row["graph_ms"].items())
        print(f"{name}: {row['ptxas']}; {ranks} CTAs a cluster, {clusters} clusters at once; "
              f"bit-equal {row['bit_equal']}; device ms {times} card={card}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_bow_sweep.json").write_text(json.dumps(results, indent=1))
    return 0 if all(r["bit_equal"] for r in results["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
