#!/usr/bin/env python3
"""Fused vs staged vs seed on one NVIDIA GPU: the port's counterpart of
`benchmarks/pipeline_bench.py` `run` and `run_octave`.

    PYTHONPATH=src python3 scripts/torch_pipeline_bench.py [--quick]

`run`: the chain gaussian(5) -> erode(1) -> threshold(100) on a (8, 512,
512, 3) u8 batch of `ImageStream().image(..., seed=b)` images in three
forms: fused (one `fused_chain` launch, in every mode), staged (`ops` per
op, per channel, per image: 72 stencil launches) and seed (the hand-written
per-op kernels of `kernels.unfused`: 72 launches).  Checks: every fused
mode bit-identical to the plain version, the fused interior (the chain's
accumulated-halo ring cut off) equal to the staged interior, the seed equal
to its plain version and to the staged path on the whole batch, and the
launch counts of each form (no plain call on the card).

`run_octave`: the SIFT octave ladder with its next base (one launch) on a
512x512 f32 plane, in every mode that fits (full-width streaming is over
the shared-memory budget and must raise), against the staged octave (7
`gaussian_blur` calls and one `pyr_down`: 8 launches).  Checks: every mode
bit-identical to the plain version on every band, and the launch counts.

Times are host wall around a synchronised call, best and median of `RUNS`
after one warm-up: every form is launch-bound, so the host's wall is what it
costs.  Beside it, each form's device time with the host's issue cost taken
out (`*_graph_ms`: ten calls captured in one CUDA graph, the replay timed
with CUDA events).  `autotune.measure_chain` is not ported yet, so the best
mode is taken here, as the fastest kernel mode timed; the plain version's
wall is reported beside it (`fused_ref_s`) and never chosen.  Rows carry
the JAX benchmark's keys (`pallas_calls_*` count the kernel launches) plus
the card; they go to ``chiprun_out/torch_pipeline_bench.json``, never to
``BENCH_results.json``.  A fused speedup under 1.3x is printed as a
warning, as the JAX benchmark does.  Exits non-zero without a CUDA device.

`run` and `run_octave` also return what `chip_smoke.py` reads of them: each
path's launch counts and each kernel's largest error against its plain
version.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLUR_K, ERODE_R, THRESH = 5, 1, 100.0
N_SCALES = 4
RUNS = 5  # timed runs of each form, after one warm-up
KERNEL_MODES = ("window", "streaming", "tiled2d")
CHECK_MODES = (None, *KERNEL_MODES)
SEED_KERNELS = ("seed_gaussian_blur", "seed_erode", "seed_threshold")


class BenchFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise BenchFailure(msg)


def chain(stencil) -> tuple:
    return (
        stencil.gaussian_stage(BLUR_K),
        stencil.erode_stage(ERODE_R),
        stencil.threshold_stage(THRESH),
    )


def staged_baseline(batch, ops):
    """Per op, per channel, per image: 3 launches x C channels x B images."""
    import torch

    out = []
    for b in range(batch.shape[0]):
        chans = []
        for c in range(batch.shape[-1]):
            p = batch[b, :, :, c]
            p = ops.gaussian_blur(p, BLUR_K)
            p = ops.erode(p, ERODE_R)
            p = ops.threshold(p, THRESH)
            chans.append(p)
        out.append(torch.stack(chans, dim=-1))
    return torch.stack(out)


def seed(batch, unfused, mode=None):
    return unfused.seed_pipeline(batch, blur_ksize=BLUR_K, erode_r=ERODE_R, thresh=THRESH,
                                 mode=mode)


def staged_octave(g, ops):
    """Per-scale from-base blurs + pyrDown: n_scales+3+1 launches."""
    import torch

    sigmas = [1.6 * 2 ** (i / N_SCALES) for i in range(N_SCALES + 3)]
    pyr = [ops.gaussian_blur(g, int(min(2 * round(3 * s) + 1, 15)), s) for s in sigmas]
    return torch.stack(pyr), ops.pyr_down(pyr[N_SCALES])


def kernel_of(mode: str) -> str:
    """The kernel a resolved stencil mode launches."""
    return "stencil_chain" if mode == "window" else "stencil_stream"


def wall_stats(fn, runs: int = RUNS) -> dict:
    """Host wall of `fn()` between two synchronisations: best, median and
    every run, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return {"best_s": min(ts), "median_s": statistics.median(ts), "runs_s": ts}


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one `fn()` with the host's issue cost taken out:
    `reps` calls captured in one CUDA graph, the replay timed with CUDA
    events, divided by `reps`."""
    import torch

    fn()  # warm: build the kernels, cache the programs and device tables
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Record:
    """Each counted path's launches and plain calls, and each kernel's
    largest error against its plain version."""

    def __init__(self, counters):
        self.counters = counters
        self.paths: dict[str, dict] = {}
        self.max_err: dict[str, float] = {}

    def counted(self, what: str, fn, launches=None):
        """Run `fn` with the counters set to 0 just before; check that it
        launched exactly `launches` (by default whatever stencil launches
        it made) and called no plain version, and keep the counts."""
        self.counters.reset()
        out = fn()
        snap = self.counters.snapshot()
        if launches is None:
            launches = {k: snap["launches"][k] for k in ("stencil_chain", "stencil_stream")}
        want = {k: launches.get(k, 0) for k in snap["launches"]}
        check(snap["launches"] == want and not any(snap["plain_calls"].values()),
              f"{what}: launches {snap['launches']} plain {snap['plain_calls']}, "
              f"want {want} and no plain call")
        self.paths[what] = snap
        return out

    def exact(self, kernel: str, what: str, got, want) -> None:
        """`got` equals the plain version's `want` bit for bit."""
        import torch

        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{what}: {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        check(err == 0.0, f"{what}: max_abs_err {err} against the plain version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)


def time_modes(make_fn, modes=KERNEL_MODES) -> dict:
    """Time each kernel mode of `modes` and the plain version; the fastest
    kernel mode is the best mode (autotune is not ported).  -> the row's
    fused fields."""
    times = {m: wall_stats(make_fn(m)) for m in modes}
    best = min(times, key=lambda m: times[m]["best_s"])
    fields = {"fused_best_s": times[best]["best_s"], "fused_median_s": times[best]["median_s"],
              "fused_mode": best, "modes_timed": "both"}
    for m, t in times.items():
        fields[f"fused_{m}_s"] = t["best_s"]
    fields["fused_ref_s"] = wall_stats(make_fn("ref"))["best_s"]
    return fields


def run(dev, *, quick: bool = False) -> tuple[dict, Record]:
    import torch
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, stencil, unfused

    shape = (4, 256, 256, 3) if quick else (8, 512, 512, 3)
    B, H, W, C = shape
    stream = ImageStream()
    batch = torch.stack([stream.image((H, W), channels=C, seed=b) for b in range(B)]).to(dev)
    stages = chain(stencil)
    rec = Record(counters)
    resolved = stencil.resolve_mode(stages, (B * C, H, W), batch.dtype)
    want = stencil.fused_chain(batch, stages, mode="ref")
    fused = {}
    for m in CHECK_MODES:
        what, kernel = f"pipeline fused mode={m}", kernel_of(m or resolved)
        fused[m] = rec.counted(what, lambda m=m: stencil.fused_chain(batch, stages, mode=m),
                               {kernel: 1})
        rec.exact(kernel, what, fused[m], want)
    staged = rec.counted("pipeline staged", lambda: staged_baseline(batch, ops))
    n_staged = sum(rec.paths["pipeline staged"]["launches"].values())
    check(n_staged == B * C * 3, f"staged: {n_staged} stencil launches, want {B * C * 3}")
    seeded = rec.counted("pipeline seed", lambda: seed(batch, unfused),
                         dict.fromkeys(SEED_KERNELS, B * C))
    seed_plain = seed(batch, unfused, mode="ref")
    for k in SEED_KERNELS:
        rec.exact(k, "pipeline seed", seeded, seed_plain)
    ph, pw = stencil.chain_halo(stages)
    interior = bool(torch.equal(fused["window"][:, ph:-ph, pw:-pw], staged[:, ph:-ph, pw:-pw]))
    check(interior, "fused chain diverges from the staged interior")
    seed_diff = int((seeded != staged).sum())
    check(seed_diff == 0, f"seed differs from staged at {seed_diff} pixels")

    fields = time_modes(lambda m: (lambda: stencil.fused_chain(batch, stages, mode=m)))
    t_staged = wall_stats(lambda: staged_baseline(batch, ops))
    t_seed = wall_stats(lambda: seed(batch, unfused))
    best = fields["fused_mode"]
    row = {
        "batch": "x".join(map(str, shape)), "dtype": "u8",
        "chain": f"gauss{BLUR_K} -> erode{ERODE_R} -> thresh",
        "pallas_calls_fused": 1, "pallas_calls_staged": n_staged,
        **fields,
        "staged_best_s": t_staged["best_s"], "staged_median_s": t_staged["median_s"],
        "seed_staged_best_s": t_seed["best_s"], "seed_staged_median_s": t_seed["median_s"],
        "seed_launches": B * C * 3,
        "fused_speedup": t_staged["best_s"] / fields["fused_best_s"],
        "fused_speedup_vs_seed": t_seed["best_s"] / fields["fused_best_s"],
        "interior_bitexact": interior, "seed_pixels_differing_from_staged": seed_diff,
        "fused_graph_ms": graph_ms(lambda: stencil.fused_chain(batch, stages, mode=best)),
        "staged_graph_ms": graph_ms(lambda: staged_baseline(batch, ops)),
        "seed_graph_ms": graph_ms(lambda: seed(batch, unfused)),
    }
    return row, rec


def run_octave(dev, *, quick: bool = False) -> tuple[dict, Record]:
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, stencil

    H, W = (256, 256) if quick else (512, 512)
    g = ImageStream().image((H, W), channels=1, seed=0).to(dev).float()
    rec = Record(counters)

    def octave(m):
        return features.gaussian_octave(g, n_scales=N_SCALES, mode=m)

    want = octave("ref")
    resolved = stencil.resolve_mode(features.octave_chain(N_SCALES), (1, H, W), g.dtype)
    modes = []
    for m in CHECK_MODES:
        what = f"octave+next base mode={m}"
        if m == "streaming" and resolved == "tiled2d":
            counters.reset()
            try:
                octave(m)
            except ValueError as e:
                check(not any(counters.snapshot()["launches"].values()), f"{what}: launched")
                print(f"{what}: ValueError as required ({e})")
                continue
            raise BenchFailure(f"{what}: over-budget full-width streaming did not raise")
        kernel = kernel_of(m or resolved)
        got = rec.counted(what, lambda m=m: octave(m), {kernel: 1})
        for band, a, b in zip(("scales", "next base"), got, want, strict=True):
            rec.exact(kernel, f"{what} {band}", a, b)
        if m:
            modes.append(m)
    rec.counted("octave staged", lambda: staged_octave(g, ops))
    n_staged = sum(rec.paths["octave staged"]["launches"].values())
    check(n_staged == N_SCALES + 4, f"staged octave: {n_staged} launches, want {N_SCALES + 4}")

    fields = time_modes(lambda m: (lambda: octave(m)), modes)
    best = fields["fused_mode"]
    t_staged = wall_stats(lambda: staged_octave(g, ops))
    return {
        "image": f"{H}x{W}", "dtype": "f32", "n_scales": N_SCALES, "bands": N_SCALES + 3,
        "next_base": f"{(H + 1) // 2}x{(W + 1) // 2}",
        "pallas_calls_fused": 1, "pallas_calls_staged": n_staged,
        **fields,
        "staged_best_s": t_staged["best_s"], "staged_median_s": t_staged["median_s"],
        "fused_speedup": t_staged["best_s"] / fields["fused_best_s"],
        "fused_graph_ms": graph_ms(lambda: octave(best)),
        "staged_graph_ms": graph_ms(lambda: staged_octave(g, ops)),
    }, rec


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="(4, 256, 256, 3) and a 256x256 octave")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_pipeline_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    card = card_line()
    rows = {"pipeline": run(dev, quick=args.quick)[0],
            "octave": run_octave(dev, quick=args.quick)[0]}
    for name, row in rows.items():
        print(f"{name}: " + " ".join(f"{k}={v}" for k, v in row.items()))
    speedup = rows["pipeline"]["fused_speedup"]
    if speedup < 1.3:
        print(f"WARNING: fused speedup {speedup:.2f}x below the 1.3x target")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_pipeline_bench.json").write_text(
        json.dumps({"card": card, "runs": RUNS, **rows}, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
