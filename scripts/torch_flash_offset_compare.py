"""`flash_attention` with its query offset and its log-sum-exp output
against an older checkout's kernel (before either existed), on one card.

    python3 scripts/torch_flash_offset_compare.py OLDER_CHECKOUT

builds ``src/repro_torch/csrc/flash_attn.cu`` of this checkout and of
OLDER_CHECKOUT (one nvcc each, side by side, `_build.NVCC_FLAGS`), then at
gemma-7b's prefill layer (8, 1024, 16, 256) and at a GQA shape (8, 1024, 32
over 8 KV heads, hd 120) in bf16, and at (2, 1024, 16, 256) in f32:

  * this kernel at offset 0 against the older one: bit for bit, with and
    without the log-sum-exp asked (`lse=True`);
  * a slice of the queries at an offset (the last 512 rows, a rank's slice
    under the sequence-parallel layout) against the whole launch's rows:
    bit for bit;
  * each kernel's time, the mean of 20 calls by CUDA events, in the order
    older, this, this, older; the slice's time beside the whole's.

Prints the card's name and power limit and writes
``chiprun_out/torch_flash_offset_compare.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("gemma-7b layer", 8, 1024, 16, 16, 256, "bfloat16"),
          ("GQA hd 120", 8, 1024, 32, 8, 120, "bfloat16"),
          ("gemma-7b heads f32", 2, 1024, 16, 16, 256, "float32"))
SLICE = 512
ITERS = 20


def build(nvcc: str, csrc: Path, out: Path, flags) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([nvcc, *flags, "-I", str(csrc), "-o", str(out),
                             str(csrc / "flash_attn.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as kattn

    older = Path(sys.argv[1]).resolve()
    out_dir = ROOT / "build" / "flash_offset_compare"
    libs = {"this": out_dir / "this" / "libflash_attn.so",
            "older": out_dir / "older" / "libflash_attn.so"}
    nvcc = _build._nvcc()
    procs = {who: build(nvcc, src / "src" / "repro_torch" / "csrc", libs[who], _build.NVCC_FLAGS)
             for who, src in (("this", ROOT), ("older", older))}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed on the {name} checkout's flash_attn.cu:\n{log}", file=sys.stderr)
            return 1
    _build._LIBS["flash_attn"] = ctypes.CDLL(str(libs["this"]))
    kattn._launcher.cache_clear()
    old = ctypes.CDLL(str(libs["older"])).flash_attn_launch
    # the older signature, read from its source: this one's without lse (and
    # without q_off before the offset existed)
    src = (older / "src" / "repro_torch" / "csrc" / "flash_attn.cu").read_text()
    params = [p.strip() for p in re.search(r'extern "C" int flash_attn_launch\(([^)]*)\)',
                                           src).group(1).split(",")]
    names = [p.split()[-1].lstrip("*") for p in params]
    old.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    old.restype = ctypes.c_int

    def launch_old(q, k, v):
        o = torch.empty_like(q)
        args = {"q": q.data_ptr(), "k": k.data_ptr(), "v": v.data_ptr(), "o": o.data_ptr(),
                "lse": None, "B": q.shape[0], "S": q.shape[1], "Tk": k.shape[1],
                "H": q.shape[2], "Hkv": k.shape[2], "hd": q.shape[3],
                "dtype": kattn.DTYPES[q.dtype], "causal": 1, "q_off": 0,
                "smem_max": kattn.DEFAULT.smem_budget, "stream": _build.cuda_stream(q.device)}
        _build.check(old(*[args[n] for n in names]), "the older flash_attention")
        return o

    def ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    results = {"card": card, "older": str(older), "shapes": {}}
    for name, B, T, H, G, hd, dt in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, T, n, hd), generator=g, device=dev).to(dtype)
                   for n in (H, G, G))
        new, prev = kattn.flash_attention(q, k, v), launch_old(q, k, v)
        with_lse, _ = kattn.flash_attention(q, k, v, lse=True)
        qs = q[:, T - SLICE:].contiguous()
        part = kattn.flash_attention(qs, k, v, q_off=T - SLICE)
        torch.cuda.synchronize()
        same = torch.equal(new, prev) and torch.equal(with_lse, prev)
        rows = torch.equal(part, new[:, T - SLICE:])
        order = ["older", "this", "this", "older"]
        runs = {"older": lambda: launch_old(q, k, v),
                "this": lambda: kattn.flash_attention(q, k, v)}
        times: dict = {"older": [], "this": []}
        for who in order:
            times[who].append(ms(runs[who]))
        slice_ms = ms(lambda: kattn.flash_attention(qs, k, v, q_off=T - SLICE))
        rec = {"shape": [B, T, H, G, hd], "dtype": dt, "offset_0_equals_older": same,
               "slice_equals_rows": rows, "older_ms": times["older"], "this_ms": times["this"],
               "slice_ms": slice_ms, "slice": [B, SLICE, H, hd], "q_off": T - SLICE}
        results["shapes"][name] = rec
        print(f"{name} {(B, T, H, hd)} over {G} KV heads {dt}: offset 0, with and without the "
              f"log-sum-exp, bit-equal to the older kernel: {same}; the last {SLICE} rows at q_off={T - SLICE} bit-equal to the whole "
              f"launch's: {rows}; ms older {times['older']} this {times['this']}; the slice "
              f"{slice_ms:.5f} card={card}", flush=True)
    path = ROOT / "chiprun_out" / "torch_flash_offset_compare.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    print(card)
    ok = all(r["offset_0_equals_older"] and r["slice_equals_rows"]
             for r in results["shapes"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
