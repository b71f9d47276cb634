#!/usr/bin/env python3
"""Fused vs staged vs seed on one NVIDIA GPU: the port's counterpart of
`benchmarks/pipeline_bench.py` `run`, `run_octave`, `run_warp`,
`run_pyramid` and `run_small_kernel_routing`.

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

`run_warp`: the geometric transform fused into the octave, the chain of
`features.align_and_detect` (an affine warp as a gather stage whose bound
is extended by the ladder's halo, then the 7-scale incremental Gaussian
ladder as tap stages: 8 bands, the warped plane first) on a 512x512 f32
plane with the JAX benchmark's M (a 0.05 rad rotation about the origin and
a (4, -3) translation), in every mode that fits (full-width streaming is
over the shared-memory budget and must raise), against the staged path
(`imgproc.warp_affine`, then one `gaussian_blur` a scale: 8 launches).
Checks: every mode one launch and bit-identical to the plain version on
every band, the fused interior (the chain's accumulated halo cut off)
equal to the staged interior, and the launch counts; the device time of
each fused mode as well as the best one's.

`run_pyramid`: the multi-octave SIFT pyramid, 4 octaves of 4 scales on a
(1, 512, 512) f32 batch: first `autotune.measure_pyramid` caches each
link's measured winner (every link measured: the port launches links no
larger than their halo too); then fused (`stencil.chained_launches` over
`features.pyramid_chains`, one launch per octave, 4 in all, each octave's
chain taking the previous one's next-base band) in every mode that fits
(full-width streaming of octave 0 is over the shared-memory budget and
must raise) and under mode None (each link launching its measured
winner's kernel),
against the staged pyramid (per octave one `gaussian_blur` a scale from
the octave's base, and a `pyr_down` to the next base: 4*7 + 3 = 31
launches).  Checks: `stencil.pyramid_plan` launches every link (the port
has no plain-version tail on the card); `features.sift_pyramid` in each
mode makes exactly 4 launches and no plain call, with keypoints equal to
its plain version's; every band of every link bit-identical to the plain
version; the launch counts.  The fastest kernel mode timed is the best
mode.

`run_small_kernel_routing`: `autotune.measure_chain` on the (8, 512, 512,
3) u8 batch for a 3x3 filter2D and erode r = 3 (the JAX benchmark's two
chains); the cache must hold the winner under the key ``mode=None`` looks
up, and ``fused_chain(mode=None)`` must launch the winner's kernel once
and no plain version, bit-equal to the winner's explicit mode.  Under
``--quick`` an entry the cache already holds is not measured again.

Times are host wall around a synchronised call, best and median of `RUNS`
after one warm-up: every form is launch-bound, so the host's wall is what it
costs.  Beside it, each form's device time with the host's issue cost taken
out (`*_graph_ms`: ten calls captured in one CUDA graph, the replay timed
with CUDA events).  `run`, `run_octave`, `run_warp` and `run_pyramid` take
the best mode as the fastest kernel mode they time; the plain version's
wall is reported beside it (`fused_ref_s`) and never chosen.  The
benchmark's measurements stay in the process (``persist=False``): it
writes no plan table.  Rows carry
the JAX benchmark's keys (`pallas_calls_*` count the kernel launches) plus
the card; they go to ``chiprun_out/torch_pipeline_bench.json``, never to
``BENCH_results.json``.  A fused speedup under 1.3x is printed as a
warning, as the JAX benchmark does.  Exits non-zero without a CUDA device.

`run`, `run_octave`, `run_warp`, `run_pyramid` and
`run_small_kernel_routing` also return what `chip_smoke.py` reads of them:
each path's launch counts and each kernel's largest error against its
plain version.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLUR_K, ERODE_R, THRESH = 5, 1, 100.0
N_SCALES = 4
N_OCTAVES = 4
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


def staged_pyramid(g, ops):
    """Per octave one from-base `gaussian_blur` a scale (ksize capped at 15,
    as `staged_octave`) and a `pyr_down` of scale `N_SCALES` to the next
    octave's base: N_OCTAVES*(N_SCALES+3) + (N_OCTAVES-1) launches, every
    intermediate through device memory."""
    import torch

    sigmas = [1.6 * 2 ** (i / N_SCALES) for i in range(N_SCALES + 3)]
    pyrs, base = [], g
    for octv in range(N_OCTAVES):
        pyr = [ops.gaussian_blur(base, int(min(2 * round(3 * s) + 1, 15)), s) for s in sigmas]
        pyrs.append(torch.stack(pyr))
        if octv < N_OCTAVES - 1:
            base = ops.pyr_down(pyr[N_SCALES])
    return pyrs


def warp_matrix(theta: float = 0.05) -> list:
    """The JAX benchmark's inverse map: a rotation by `theta` about the
    origin and a (4, -3) translation."""
    c, s = math.cos(theta), math.sin(theta)
    return [[c, -s, 4.0], [s, c, -3.0]]


def staged_warp(g, M, imgproc, ops, features):
    """A warp launch and the same incremental full-width ladder as the
    fused chain, one `gaussian_blur` launch a scale: 1 + n_scales+3
    launches."""
    import torch

    prev = imgproc.warp_affine(g, M)
    pyr = []
    for k, s in features.ladder_taps(N_SCALES, 1.6):
        prev = ops.gaussian_blur(prev, k, s)
        pyr.append(prev)
    return torch.stack(pyr)


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
    kernel mode is the best mode.  -> the row's fused fields."""
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


def run_warp(dev, *, quick: bool = False) -> tuple[dict, Record]:
    import torch
    from repro_torch.cv import features, imgproc
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, stencil

    H, W = (256, 256) if quick else (512, 512)
    g = ImageStream().image((H, W), channels=1, seed=0).to(dev).float()
    M = warp_matrix()
    stages = features.aligned_octave_chain(M, (H, W), n_scales=N_SCALES)
    rec = Record(counters)

    def fused(m):
        return stencil.fused_chain(g, stages, mode=m)

    want = fused("ref")
    resolved = stencil.resolve_mode(stages, (1, H, W), g.dtype)
    modes = []
    for m in CHECK_MODES:
        what = f"warp chain mode={m}"
        if m == "streaming" and resolved == "tiled2d":
            counters.reset()
            try:
                fused(m)
            except ValueError as e:
                check(not any(counters.snapshot()["launches"].values()), f"{what}: launched")
                print(f"{what}: ValueError as required ({e})")
                continue
            raise BenchFailure(f"{what}: over-budget full-width streaming did not raise")
        kernel = kernel_of(m or resolved)
        got = rec.counted(what, lambda m=m: fused(m), {kernel: 1})
        check(len(got) == len(want) == N_SCALES + 4, f"{what}: {len(got)} bands")
        for b, (a, w) in enumerate(zip(got, want)):
            rec.exact(kernel, f"{what} band {b}", a, w)
        if m:
            modes.append(m)
    staged = rec.counted("warp staged", lambda: staged_warp(g, M, imgproc, ops, features))
    n_staged = sum(rec.paths["warp staged"]["launches"].values())
    check(n_staged == N_SCALES + 4, f"staged warp: {n_staged} launches, want {N_SCALES + 4}")
    ph, pw = stencil.chain_halo(stages)
    pyr = torch.stack(want[1:])
    interior = bool(torch.equal(pyr[:, ph:-ph, pw:-pw], staged[:, ph:-ph, pw:-pw]))
    check(interior, "fused warp chain diverges from the staged interior")

    fields = time_modes(lambda m: (lambda: torch.stack(fused(m)[1:])), modes)
    best = fields["fused_mode"]
    t_staged = wall_stats(lambda: staged_warp(g, M, imgproc, ops, features))
    return {
        "image": f"{H}x{W}", "dtype": "f32", "n_scales": N_SCALES, "bands": N_SCALES + 4,
        "chain": "warp_affine -> gauss ladder", "halo": f"{ph}x{pw}",
        "pallas_calls_fused": 1, "pallas_calls_staged": n_staged,
        **fields,
        "staged_best_s": t_staged["best_s"], "staged_median_s": t_staged["median_s"],
        "fused_speedup": t_staged["best_s"] / fields["fused_best_s"],
        "interior_bitexact": interior,
        "fused_graph_ms": graph_ms(lambda: torch.stack(fused(best)[1:])),
        **{f"fused_{m}_graph_ms": graph_ms(lambda m=m: torch.stack(fused(m)[1:])) for m in modes},
        "staged_graph_ms": graph_ms(lambda: staged_warp(g, M, imgproc, ops, features)),
    }, rec


def run_pyramid(dev, *, quick: bool = False) -> tuple[dict, Record]:
    from repro_torch.core import autotune
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, stencil

    # 512x512 under --quick too: the 64x64 tail octave stays above the
    # ladder's halo, as in the JAX benchmark
    H, W = 512, 512
    g = ImageStream().image((H, W), channels=1, seed=0).to(dev).float()
    chains = features.pyramid_chains(N_OCTAVES, N_SCALES, 1.6, 15)
    plan = stencil.pyramid_plan(chains, (H, W))
    check(len(plan) == N_OCTAVES and all(p["mode"] in KERNEL_MODES for p in plan),
          f"pyramid plan: {plan}")
    rec = Record(counters)
    # the batch sift_pyramid makes of g[None], so that its links find the
    # entries measured here: each link's own (shrinking) shape
    gb = g[None, ..., None]
    measured = [e["mode"] for e in autotune.measure_pyramid(gb, chains, n=1 if quick else 3,
                                                            persist=False)]

    def bands(m):
        return stencil.chained_launches(gb, chains, mode=m)[0]

    want = bands("ref")
    want_kp = features.sift_pyramid(g[None], n_octaves=N_OCTAVES, n_scales=N_SCALES, mode="ref")
    modes = []
    for m in CHECK_MODES:
        what = f"pyramid mode={m}"
        if m == "streaming" and plan[0]["mode"] == "tiled2d":
            counters.reset()
            try:
                bands(m)
            except ValueError as e:
                check(not any(counters.snapshot()["launches"].values()), f"{what}: launched")
                print(f"{what}: ValueError as required ({e})")
                continue
            raise BenchFailure(f"{what}: over-budget full-width streaming did not raise")
        kernels = [kernel_of(m or e) for e in measured]
        launches = {k: kernels.count(k) for k in set(kernels)}
        kp = rec.counted(f"sift_pyramid mode={m}", lambda m=m: features.sift_pyramid(
            g[None], n_octaves=N_OCTAVES, n_scales=N_SCALES, mode=m), launches)
        for k in ("xy", "octave", "scale", "resp", "valid"):
            check(bool((kp[k] == want_kp[k]).all()), f"sift_pyramid mode={m}: {k} differs")
        got = rec.counted(what, lambda m=m: bands(m), launches)
        for o, (a, b) in enumerate(zip(got, want, strict=True)):
            for j, (x, y) in enumerate(zip(a, b, strict=True)):
                rec.exact(kernels[o], f"{what} octave {o} band {j}", x, y)
        if m:
            modes.append(m)
    rec.counted("pyramid staged", lambda: staged_pyramid(g, ops))
    n_staged = sum(rec.paths["pyramid staged"]["launches"].values())
    launches_staged = N_OCTAVES * (N_SCALES + 3) + (N_OCTAVES - 1)
    check(n_staged == launches_staged, f"staged pyramid: {n_staged} launches, want "
          f"{launches_staged}")

    fields = time_modes(lambda m: (lambda: bands(m)), modes)
    fields["fused_auto_s"] = wall_stats(lambda: bands(None))["best_s"]
    best = fields["fused_mode"]
    t_staged = wall_stats(lambda: staged_pyramid(g, ops))
    return {
        "image": f"{H}x{W}", "dtype": "f32", "n_scales": N_SCALES, "n_octaves": N_OCTAVES,
        "bands_per_octave": N_SCALES + 3, "link_modes": [p["mode"] for p in plan],
        "measured_link_modes": measured,
        "pallas_calls_fused": N_OCTAVES, "pallas_calls_staged": n_staged,
        **fields,
        "staged_best_s": t_staged["best_s"], "staged_median_s": t_staged["median_s"],
        "fused_speedup": t_staged["best_s"] / fields["fused_best_s"],
        "fused_graph_ms": graph_ms(lambda: bands(best)),
        "fused_auto_graph_ms": graph_ms(lambda: bands(None)),
        "staged_graph_ms": graph_ms(lambda: staged_pyramid(g, ops)),
    }, rec


def run_small_kernel_routing(dev, *, quick: bool = False) -> tuple[list, Record]:
    """The counterpart of the JAX benchmark's `run_small_kernel_routing`:
    the measured choice must route each chain to its winner's kernel."""
    import torch
    from repro_torch.core import autotune
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ref, stencil

    shape = (4, 256, 256, 3) if quick else (8, 512, 512, 3)
    B, H, W, C = shape
    stream = ImageStream()
    batch = torch.stack([stream.image((H, W), channels=C, seed=b) for b in range(B)]).to(dev)
    k1 = ref.gaussian_kernel1d(3)
    cases = [("filter2d_3x3", (stencil.filter_stage(torch.outer(k1, k1)),)),
             ("erode_r3", (stencil.erode_stage(3),))]
    rec = Record(counters)
    rows = []
    for name, ch in cases:
        # under --quick an entry the cache already holds is the routing input
        res = autotune.cached_chain_entry(ch, batch.shape, batch.dtype, device=dev) if quick else None
        remeasured = res is None
        if res is None:
            res = autotune.measure_chain(batch, ch, n=1 if quick else 3, persist=False)
        routed = autotune.cached_chain_mode(ch, batch.shape, batch.dtype, device=dev)
        check(routed == res["mode"], f"{name}: the cache holds {routed!r}, measure_chain won "
              f"{res['mode']!r}: mode None would not route there")
        kernel = kernel_of(res["mode"])
        auto = rec.counted(f"routing {name} mode=None", lambda ch=ch: stencil.fused_chain(batch, ch),
                           {kernel: 1})
        rec.exact(kernel, f"routing {name}", auto, stencil.fused_chain(batch, ch, mode=res["mode"]))
        t_auto = wall_stats(lambda ch=ch: stencil.fused_chain(batch, ch))["best_s"]
        t_best = min(res["times"].values())
        if t_auto > 1.5 * t_best:  # informational: timing, not a gate
            print(f"WARNING: {name} mode None {t_auto:.6f}s vs measured winner {res['mode']} "
                  f"{t_best:.6f}s")
        rows.append({"case": name, "batch": "x".join(map(str, shape)), "routed_mode": res["mode"],
                     "remeasured": remeasured,
                     **{f"{m}_s": t for m, t in res["times"].items()}, "auto_s": t_auto})
    return rows, rec


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="(4, 256, 256, 3), a 256x256 octave and warp chain (the pyramid "
                    "stays 512x512)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_pipeline_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    card = card_line()
    rows = {"pipeline": run(dev, quick=args.quick)[0],
            "octave": run_octave(dev, quick=args.quick)[0],
            "warp": run_warp(dev, quick=args.quick)[0],
            "pyramid": run_pyramid(dev, quick=args.quick)[0],
            "small_kernel_routing": run_small_kernel_routing(dev, quick=args.quick)[0]}
    for name, row in rows.items():
        for r in row if isinstance(row, list) else [row]:
            print(f"{name}: " + " ".join(f"{k}={v}" for k, v in r.items()))
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
