#!/usr/bin/env python3
"""Time `gbdt_score` under other launch geometries and load depths on one
NVIDIA GPU, each held bit-equal to the plain version first.

    python3 scripts/torch_gbdt_sweep.py            # -> chiprun_out/torch_gbdt_sweep.json

Each variant is ``src/repro_torch/csrc/gbdt.cu`` with some of its
``constexpr int k...`` constants replaced (kWarps: rows a block, one warp
each; kLevels: levels whose gathers are issued before their compares;
kLeaves: leaf loads issued before their adds), built with the checkout's
own nvcc flags into ``build/gbdt_sweep/<variant>/`` (all variants in
parallel) and called through its C interface.  For each variant it prints
ptxas's registers and spills, the count of each of a few SASS opcodes in
the kernel (``cuobjdump -sass``: global loads and stores, shuffles,
branches, float adds), whether its scores and leaf indices equal
`gbdt_score_plain`'s bit for bit (the request's model, 40 trees, 33
classes, 64 trees of depth 8), and its device time: the faster of two
replays of a CUDA graph of 100 calls (`scripts/torch_pipeline_bench.py`'s
`graph_ms`, as chip_smoke.py times it) at B = 256 (the predict request) and
1024 rows of 250 words, 16 trees of depth 3, 10 classes, beside the launch
floor (a one-element in-place add) in the same process.  Prints the card's
name and power limit first; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (kWarps, kLevels, kLeaves) of each variant; the one csrc/gbdt.cu holds is
# marked "as built"
VARIANTS = [
    (4, 8, 32), (4, 8, 16), (4, 8, 8), (4, 8, 4),
    (1, 8, 16), (2, 8, 16), (8, 8, 16),
    (4, 4, 16), (2, 4, 16), (1, 4, 16), (2, 2, 16), (2, 3, 16), (2, 4, 8), (1, 4, 8),
]
NAMES = ("kWarps", "kLevels", "kLeaves")
BATCHES = (256, 1024)
OPCODES = ("LDG", "STG", "SHFL", "BRA", "FADD", "BSSY")


def variant_source(src: str, consts: dict) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"csrc/gbdt.cu has no single constant {name}")
    return src


def build(B, out_root: Path) -> dict:
    """nvcc every variant in parallel; -> name -> (library path, ptxas log)."""
    src = (B.CSRC / "gbdt.cu").read_text()
    built_consts = tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                         for n in NAMES)
    procs = {}
    for i, v in enumerate(VARIANTS):
        name = " ".join(f"{n} {x}" for n, x in zip(NAMES, v))
        name += " (as built)" if v == built_consts else ""
        d = out_root / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "gbdt.cu").write_text(variant_source(src, dict(zip(NAMES, v))))
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-o", str(d / "libgbdt.so"),
               str(d / "gbdt.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        built[name] = (d / "libgbdt.so", log)
    return built


def ptxas_report(log: str) -> str:
    return "; ".join(x.replace("ptxas info    :", "").strip() for x in log.splitlines()
                     if "spill" in x or "registers" in x)


def sass_opcodes(path: Path, nvcc: str) -> dict | str:
    """The count of each of OPCODES in the library's SASS."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    if not Path(tool).exists():
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    ops = collections.Counter(m.group(1).split(".")[0]
                              for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)",
                                                   sass))
    return {op: ops.get(op, 0) for op in OPCODES}


def load_graph_ms():
    spec = importlib.util.spec_from_file_location(
        "torch_pipeline_bench", ROOT / "scripts" / "torch_pipeline_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graph_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gbdt_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import gbdt as kgbdt

    graph_ms = load_graph_ms()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    t0 = time.perf_counter()
    built = build(B, ROOT / "build" / "gbdt_sweep")
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    F = 250

    def model(T, depth, C):
        return (torch.randint(0, F, (T, depth), generator=gen, device=dev, dtype=torch.int32),
                torch.rand((T, depth), generator=gen, device=dev) * 0.008,
                torch.randn((T, 2**depth, C), generator=gen, device=dev),
                torch.randn((C,), generator=gen, device=dev))

    x = torch.rand((max(BATCHES), F), generator=gen, device=dev)
    x = x / x.sum(1, keepdim=True)
    request = model(16, 3, 10)
    checks = {"request": request, "T=40": model(40, 3, 10), "C=33": model(16, 3, 33),
              "64 trees depth 8": model(64, 8, 10)}
    one = torch.zeros(1, device=dev)
    floor = min(graph_ms(lambda: one.add_(1), reps=100) for _ in range(2))
    print(f"launch floor (one.add_(1), graph of 100): {floor:.5f} ms card={card}")
    results = {"card": card, "launch_floor_ms": floor, "variants": {}}
    for name, (path, log) in built.items():
        fn = ctypes.CDLL(str(path)).gbdt_score_launch
        fn.argtypes = kgbdt.LAUNCH_ARGTYPES["gbdt_score_launch"]
        fn.restype = ctypes.c_int

        def call(xb, m, out):
            feat, thr, leaf, base = m
            err = fn(xb.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
                     base.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), xb.shape[0], F,
                     feat.shape[0], feat.shape[1], leaf.shape[2], B.cuda_stream(dev))
            B.check(err, f"variant {name}")

        def outputs(b, m):
            return (torch.empty((b, m[2].shape[2]), device=dev),
                    torch.empty((b, m[0].shape[0]), dtype=torch.int32, device=dev))

        row = {"ptxas": ptxas_report(log),
               "sass": sass_opcodes(path, B._nvcc()), "bit_equal": True, "graph_ms": {}}
        for m in checks.values():
            xb = x[:256]
            out = outputs(256, m)
            call(xb, m, out)
            want = kgbdt.gbdt_score_plain(xb, *m)
            torch.cuda.synchronize()
            row["bit_equal"] &= bool(torch.equal(out[0], want[0]) and torch.equal(out[1], want[1]))
        for b in BATCHES:
            xb, out = x[:b].contiguous(), outputs(b, request)
            row["graph_ms"][b] = min(graph_ms(lambda: call(xb, request, out), reps=100)
                                     for _ in range(2))
        results["variants"][name] = row
        times = " ".join(f"B={b}: {t:.5f}" for b, t in row["graph_ms"].items())
        print(f"{name}: {row['ptxas']}; sass {row['sass']}; bit-equal {row['bit_equal']}; "
              f"device ms {times} card={card}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_gbdt_sweep.json").write_text(json.dumps(results, indent=1))
    return 0 if all(r["bit_equal"] for r in results["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
