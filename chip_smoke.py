#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure is caught and carried past):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` with nvcc, one process per source, and print
     the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     shapes beyond the BoW path's (phase 10 repeats it on the path's tensors;
     `bow_quantize_hist` bit for bit, unnormalised and normalised, with the
     valids and with fractional weights, two runs bit-identical, at N = 32,
     45, 100 and K = 5 to 1300, one to eight CTAs a cluster);
     each chain runs under the kernel `mode=None` resolves to and under the
     window kernel; then the chains fixed-size tables once refused
     (`table_phase`): even taps (2x2, 4x4, 6/6 separable, odd x even) and
     four 13x13 filters (676 weights), 33 stages, 9 resolution levels, 17
     output bands and 5 remaps, on a 600x700 u8 image and its f32 copy, in
     every mode, one launch each, bit-equal to the plain version; nine
     pyrDowns on the same image run plain and are refused by both kernels
     with the limit that binds (the stride product 512, shared memory);
  3. the training path on the card, once per head (SVM, GBDT): 1000
     ImageStream images at 32x32, a 250-word dictionary, the §4.5 config,
     k-means seeded from a CPU generator at seed 0.  Each training launches
     `stencil_stream` once (the preprocess chain), `stencil_chain` once (the
     octave, on planes no larger than its halo) and `bow_assign` 21 times
     (20 k-means iterations + the histograms), and calls no plain version.
     Both heads are also trained on the CPU from the same seed, for the
     accuracy check of 4;
  4. the predict path on the card, once per head: 4 requests of 256 test
     images through `pipeline.predict`, each launching its head's kernels
     (SVM: stencil_stream, stencil_chain, bow_quantize_hist, linear_score;
     GBDT: the same with gbdt_score) and no plain version; accuracy above
     0.15 and within 0.05 of the CPU-trained model's, labels identical
     across two runs and within 1% of a CPU plain `predict` of the same model;
  5. the paper's filter2D / erode image path through `kernels.ops`,
     `cv.imgproc` and `fused_chain`: gaussian_filter2d at 1080p and 4K u8,
     k = 3..13; erode at 1080p, 4K and 8K u8, r = 1..3; the acceptance
     chain gaussian(5) -> erode(1) -> threshold(100) on (8, 512, 512, 3) u8;
     the BoW preprocess chain on the same batch in f32; one octave ladder
     (without its next base) on a 512x512 f32 plane.  Each shape runs in every mode (None, window,
     streaming, tiled2d), one launch of the named kernel each and no plain
     call, max_abs_err 0 against the plain version, and the three kernel
     modes bit-identical; a full-width streaming plan over the
     shared-memory budget must raise `ValueError`.  Then `stencil_stream`
     and `stencil_chain` are timed on each shape (all 24 in window mode), the
     plain version on the 4K shapes, and `conv2d` as the library call for
     gaussian_filter2d k = 5 and 13;
  6. the fused-vs-staged-vs-seed pipeline benchmark (`pipeline_phase`):
     the seed kernels against their plain versions (512x512, 1081x1919,
     37x53 and 511x513 u8, blur k = 1..31 on the odd sizes, r = 1, 2, 3,
     the thresholds of the seed's table), max_abs_err 0; then `scripts/torch_pipeline_bench.py` `run`:
     the chain gaussian(5) -> erode(1) -> threshold(100) on (8, 512, 512,
     3) u8 fused in every mode (one launch each, bit-identical to the plain
     version), staged (72 stencil launches) and seed (24 launches of each
     seed kernel, no plain call), the seed equal to its plain version and
     to the staged path, the fused interior equal to the staged one, and
     the host wall of each form (best and median of 5); and its
     `run_octave`: the octave with its next base on a 512x512 f32 plane in
     every mode (one launch, every band bit-identical to the plain
     version; full-width streaming must raise) and staged (8 launches);
     `ops.pyr_down` at 1080p and 4K u8 in every mode; the strided geometry
     at odd sizes with several tiles and segments; each octave kernel's
     device time with and without the next base; and each seed kernel's
     device time (a CUDA graph of 100 calls replayed), plain time, bound
     and library call (`conv2d` for the blur, `torch.where` for the
     threshold);
  7. the geometric path (`geometric_phase`): `imgproc.warp_affine` (a
     1-degree rotation about the centre and a (4, -3) translation),
     `imgproc.remap` (an identity map plus a smooth field), `resize_half`,
     `ops.sobel`, sobel -> grad_mag and gaussian(3) -> resize2(tap=0) at
     1080p and 4K u8, and again at 1081x1919 u8 and 37x53 f32 with several
     window tiles, column tiles and row segments, each in every mode (one
     launch, every band equal to the plain version in dtype, shape and
     bits, the three kernel modes bit-identical; over-budget full-width
     streaming must raise); `run_warp` of the benchmark (the warp -> ladder
     chain of `align_and_detect` on a 512x512 f32 plane, one launch in each
     mode that fits against 8 staged launches, its interior equal to the
     staged one, host walls and graph-replay device times);
     `features.align_and_detect` on the same plane against a `mode="ref"`
     run on the card (keypoints equal but at counted near-ties); then each
     1080p / 4K shape's and the warp chain's kernel times (both kernels),
     plain time, bound and library call (`grid_sample` for the gathers,
     `avg_pool2d` for resize_half, `conv2d` for sobel);
  8. the multi-octave pyramid path (`pyramid_phase`): `ops.pyr_up` at
     1080p and 4K u8 (outputs 2160x3840 and 4320x7680) and the chains
     pyrDown -> pyrUp, gaussian(5) -> pyrDown -> erode(1), resize2 ->
     gaussian(3) and pyrUp -> gaussian(3) at 1080p u8 and at 1081x1919 u8
     and 37x53 f32 with several window tiles, column tiles and row
     segments, each in every mode (one launch, every band equal to the
     plain version in dtype, shape and bits; over-budget full-width
     streaming must raise); `features.sift_pyramid` with 4 octaves on
     512x512, 1080p and 4K gray f32 (exactly 4 launches and no plain call,
     every band bit-equal to the plain version, keypoints equal to a
     `mode="ref"` run on the card but at counted near-ties); BoW `train` and
     `predict` with both heads at `PipelineConfig(preprocess=True,
     n_octaves=3, max_kp=32)` on phase 3's images (`stencil_stream` once,
     `stencil_chain` three times, then `bow_assign` x21 or
     `bow_quantize_hist` and the head's kernel; labels identical across two
     runs and within 1% of a plain CPU predict); `run_pyramid` of the
     benchmark (4 launches in each mode that fits against 31 staged, host
     walls and graph-replay device times); then pyr_up's times (both
     kernels, plain, `conv_transpose2d`, bound) and each pyramid link's
     mode, time, plain time and bound;
  9. the LM serving path (`lm_phase`): gemma-7b at full width (28 layers,
     d 3072, 16 heads of 256, bf16, ~8.5 B parameters) built on the card
     from a seeded generator; `flash_attention` held against its plain
     version within `kernels.attention.AGREE` (one rounding to the output
     dtype apart: rtol 2^-7 + atol 1e-4 in bf16, 2e-4 in f32) on every
     layer's q, k, v of the prefill (8 x 1024 x 16 x 256, bf16), on an f32
     copy of layer 0's and on the JAX kernel test's shapes; greedy
     `generate` of 8 requests x 1024 prompt tokens + 32 new tokens,
     launching `flash_attention` exactly 28 times (the prefill; decode runs
     `dense_attention`) and no plain version; tokens identical across two
     runs, and each the argmax of a `mode="ref"` (plain) teacher-forced
     prefill + decode but at counted near-ties (at random init the argmax
     is the token fed in, so these two cannot see a kernel fault); then the
     kernel, its plain version and SDPA (`is_causal=True`, the yardstick),
     the prefill and a decode step are timed, with the kernel's bound
     (q.k and two 16-bit p.v passes at the tensor cores' rate) and the
     earlier price of the same work (p.v at the f32 rate); last, the same weights
     widened to f32: the kernel and plain paths' final hidden states at
     every prompt position within 2e-4 and last-token logits within 2e-3,
     and the bf16 paths' logits within twice the bf16 model's own error;
  10. on the paths' own tensors (the first request, the training
     descriptors and final centroids), hold each kernel against its plain
     version again, count the device activities of one `bow_quantize_hist`
     call with torch.profiler (exactly its kernel: no memset, cast or
     normalising launch), then time each kernel, its plain version and (for
     `linear_score`) one PyTorch call computing the same function;
 11. print the window arithmetic of the request's octave with its frames
     cut and full (`window_floor_ms`) beside `stencil_chain`'s time, then
     the ``kernels`` JSON line (all ten kernels; `stencil_stream` at
     the 4K u8 gaussian_filter2d k = 13 under mode=None, `flash_attention`
     at the prefill's layer 0, the seed kernels on one 512x512 u8 plane),
     then the card line and the device line.

Each path is driven with the launch counters set to 0 just before it and
read just after; a kernel's ``launches`` in the JSON line sums the paths'.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, fp32
# FLOP/s on the CUDA cores, and bf16 / f16 FLOP/s on the tensor cores (with
# f32 accumulation), the rate of a product whose operands are bf16 or f16
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

PREDICT_BATCH = 256
N_REQUESTS = 4
N_TRAIN = 1000
DICT_SIZE = 250
HEADS = ("svm", "gbdt")
HEAD_KERNEL = {"svm": "linear_score", "gbdt": "gbdt_score"}
# the image-path shape whose stencil_stream numbers go on the kernels line
STREAM_ENTRY = "gaussian_filter2d k=13 4K u8"
# the LM serving path: gemma-7b at full width, 8 requests of 1024 + 32 tokens
LM_ARCH = "gemma-7b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_tie_mask(descs, cents, ulps: int = 4):
    """(M,) descriptors whose best and second-best s = -2 d.c + |c|^2 lie
    within `ulps` f32 ulps (s recomputed in f64)."""
    import torch

    d = descs.reshape(-1, descs.shape[-1]).double()
    c = cents.double()
    s = -2.0 * d @ c.T + (c * c).sum(1)[None]
    two = torch.topk(s, 2, dim=1, largest=False).values
    best = two[:, 0].float().abs()
    ulp = torch.nextafter(best, torch.full_like(best, math.inf)) - best
    return (two[:, 1] - two[:, 0]) <= ulps * ulp.double()


def chain_flops(stages) -> float:
    """FLOP per input pixel of a chain (the image domain, halo excluded):
    each stage's count per pixel of its own input, times that input's area
    against the chain's (a quarter past a stride, four times past a pyrUp)."""
    from repro_torch.kernels.stencil import chain_levels, resolve_chain

    lv = chain_levels(stages)
    total = 0
    for k, (s, (_op, mode, *_rest)) in enumerate(zip(stages, resolve_chain(stages))):
        area = 1.0
        for _o, (sy, sx), (uy, ux) in lv.steps[lv.lv_in[k]]:
            area *= uy * ux / (sy * sx)
        total += area * stage_flops(s, mode)
    return total


def stage_flops(s, mode: str) -> float:
    """FLOP per input pixel of one stage."""
    if s.op == "filter2d":
        return 2 * s.weights[0].numel()  # a product and a sum per tap
    elif s.op == "sep_filter":
        return 2 * (s.weights[0].numel() + s.weights[1].numel())
    elif s.op in ("erode", "dilate"):
        return 2 * (2 * s.static[0])  # separable min / max: row + column compares
    elif s.op == "box":
        return 2 * (2 * s.static[0]) + 1  # row + column sums, one scaling
    elif s.op == "threshold":
        return 1
    elif s.op == "affine":
        return 2
    elif s.op == "grad_mag" and mode == "reduce":
        return 3  # 2 squares, 1 add (+ sqrt)
    elif s.op == "grad_mag":
        return 7  # 2 sub, 2 scale, 2 square, 1 add (+ sqrt)
    elif s.op == "pyr_down":
        # 5 row taps at the even columns of every row, 5 column taps at
        # the even (row, column) pairs: 2 * (5/2 + 5/4) per input pixel
        return 7.5
    elif s.op == "resize2":
        return 1  # 3 adds and a scaling per 2x2 block
    elif s.op == "sobel":
        return 13  # 3 column differences, 2 column sums (2 adds, 1 doubling), dx 3, dy 1
    elif s.op == "warp_affine":
        return 19  # coordinates 4 mul + 4 add, 2 fracs, 3 lerps of 3
    elif s.op == "remap":
        return 11  # 2 fracs, 3 lerps of 3
    elif s.op == "pyr_up":
        # per output pixel 4.5 (a row phase per output row and source
        # column: even 4, odd 2, so 3 per pair of rows, 1.5 an output;
        # then its column phase, 3 on average): 4 outputs an input
        return 18
    raise ValueError(f"chain_flops: no count for stage op {s.op!r}")


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


RES = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}


def image_path_cases(dev, ops, imgproc, features, stencil, ref, ImageStream) -> list:
    """The third slice's shapes: the paper's filter2D (Tables 1-3) and erode
    (Tables 4-6) benches at their sizes, the acceptance chain of
    benchmarks/pipeline_bench.py, the BoW preprocess chain and one octave
    ladder.  Images come from `ImageStream().image`, seeded per image; the
    plain version is timed on the 4K shapes, `conv2d` for the Gaussian
    filter2D at k = 5 and 13."""
    import torch

    stream = ImageStream()
    cases = []

    def add(name, img, chain, call, lib=None):
        cases.append({"name": name, "img": img, "chain": chain, "call": call, "lib": lib,
                      "plain": " 4K " in name})

    for res in ("1080p", "4K"):
        img = stream.image(RES[res], seed=0).to(dev)
        for k in (3, 5, 7, 9, 11, 13):
            k1 = ref.gaussian_kernel1d(k)
            chain = (stencil.filter_stage(torch.outer(k1, k1)),)
            add(f"gaussian_filter2d k={k} {res} u8", img, chain,
                lambda mode, img=img, k=k: ops.gaussian_filter2d(img, k, mode=mode),
                "conv2d" if k in (5, 13) else None)
    for res in ("1080p", "4K", "8K"):
        img = stream.image(RES[res], seed=1).to(dev)
        for r in (1, 2, 3):
            add(f"erode r={r} {res} u8", img, (stencil.erode_stage(r),),
                lambda mode, img=img, r=r: ops.erode(img, r, mode=mode))
    batch = torch.stack([stream.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    acc = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.threshold_stage(100.0))
    add("acceptance (8,512,512,3) u8", batch, acc,
        lambda mode: stencil.fused_chain(batch, acc, mode=mode))
    pre = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    fbatch = batch.float()
    add("preprocess (8,512,512,3) f32", fbatch, pre,
        lambda mode: imgproc.preprocess_bow(fbatch, mode=mode))
    plane = stream.image((512, 512), seed=2).to(dev).float()
    add("octave (512,512) f32", plane, features.octave_chain(4, with_next_base=False),
        lambda mode: tuple(features.gaussian_octave(
            plane[None], with_next_base=False, mode=mode)[0][0].unbind(0)))
    return cases


def table_chains(stencil, hw, dev) -> dict:
    """Chains the TPU kernels take that fixed-size step tables on the card
    once refused (ROADMAP Queue 2), for an (H, W) image on `dev`:
    even taps (2x2, 4x4 filters, 6/6 separable, odd x even mixes, taps
    beside a map) and chains past the old tables: four 13x13 filters (676
    weights), 33 stages, 9 resolution levels (pyrDown / pyrUp x 4, then a
    pyrDown), 17 output bands, 5 remaps.  Taps are seeded, positive and
    sum to 1, so a u8 chain stays in range (tests/test_torch_stencil.py
    `table_chain` builds the same chains)."""
    import numpy as np
    import torch

    def taps(seed, *shape):
        w = np.random.default_rng(seed).random(shape, dtype=np.float32) + np.float32(0.25)
        return torch.from_numpy((w / w.sum()).astype(np.float32))

    def sep(nx, ny, seed, **kw):
        return stencil.sep_filter_stage(taps(seed, nx), taps(seed + 1, ny), **kw)

    h, w = hw
    remaps = []
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    # displacements under a pixel; each remap budgets the halo the later
    # ones read (out-of-image lookups clamp to the map's edge)
    for i, e in enumerate((15, 7, 3, 1, 0)):
        mx = (xx + (0.3 + 0.05 * i) * torch.cos(yy / 5.0)).contiguous()
        my = (yy + (0.45 - 0.05 * i) * torch.sin(xx / 7.0)).contiguous()
        remaps.append(stencil.remap_stage(mx, my, extend=(e, e)))
    ops3 = (lambda: stencil.gaussian_stage(3), lambda: stencil.affine_stage(0.9375, 3.0),
            lambda: stencil.erode_stage(1))
    return {
        "even 2x2": (stencil.filter_stage(taps(1, 2, 2)),),
        "even 4x4": (stencil.filter_stage(taps(2, 4, 4)),),
        "even sep 6/6": (sep(6, 6, 3),),
        "odd x even": (stencil.filter_stage(taps(4, 3, 4)), sep(5, 2, 5),
                       stencil.filter_stage(taps(6, 4, 5))),
        "even taps beside a map": (stencil.gaussian_stage(3), sep(4, 6, 7, tap=0),
                                   stencil.erode_stage(1), stencil.filter_stage(taps(8, 2, 6)),
                                   sep(2, 2, 9, tap=-2)),
        "676 weights": tuple(stencil.filter_stage(taps(10 + i, 13, 13)) for i in range(4)),
        "33 stages": tuple(ops3[i % 3]() for i in range(33)),
        "9 levels": tuple(stencil.pyr_down_stage() if i % 2 == 0 else stencil.pyr_up_stage()
                          for i in range(8)) + (stencil.pyr_down_stage(),),
        "17 bands": tuple(stencil.gaussian_stage(3 + 2 * (i % 3), tap=0) for i in range(16)),
        "5 remaps": tuple(remaps),
    }


TABLE_HW = (600, 700)


def table_cases(dev, stencil, ImageStream) -> list:
    """`table_chains` on a 600x700 u8 image and its f32 copy, in the
    image-path case format: the 9-level chain with 32-row steps (its stride
    product is 32), the 17-band chain with 4-row steps (17 rings)."""
    from repro_torch.core.device import LaunchConfig

    img = ImageStream().image(TABLE_HW, seed=21).to(dev)
    cases = []
    for dt, x in (("u8", img), ("f32", img.float())):
        for name, chain in table_chains(stencil, TABLE_HW, dev).items():
            lc = LaunchConfig(stream_rows={"9 levels": 32, "17 bands": 4}.get(name, 8))
            cases.append({"name": f"{name} 600x700 {dt}", "img": x, "chain": chain, "lc": lc,
                          "plain": False, "lib": None,
                          "call": lambda mode, x=x, chain=chain, lc=lc:
                          stencil.fused_chain(x, chain, mode=mode, lc=lc)})
    return cases


def check_modes(case, counters, stencil, ref, path_counts: dict, max_err: dict) -> tuple:
    """One image-path shape in every mode (None, window, streaming,
    tiled2d): one launch of the kernel the mode names and no plain call,
    every band equal to the plain version's in dtype, shape and bits, and
    the three kernel modes bit-identical; an explicit full-width streaming
    plan over the shared-memory budget must raise.  -> (the plain version's
    bands, the planes, the mode None resolves to)."""
    import torch

    name, img, chain, call = case["name"], case["img"], case["chain"], case["call"]
    want = as_tuple(stencil.fused_chain(img, chain, mode="ref"))
    planes = ref.to_planes(img)
    if "lc" in case:
        resolved = stencil.resolve_mode(chain, planes.shape, img.dtype, case["lc"])
    else:
        resolved = stencil.resolve_mode(chain, planes.shape, img.dtype)
    outs = {}
    for mode in (None, "window", "streaming", "tiled2d"):
        kernel = "stencil_chain" if (mode or resolved) == "window" else "stencil_stream"
        what = f"{name} mode={mode}"
        if mode == "streaming" and resolved == "tiled2d":
            # full-width rings over the budget: the explicit plan must refuse
            counters.reset()
            try:
                call("streaming")
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised is not None, f"{what}: over-budget streaming did not raise")
            expect_counts(what, counters.snapshot(), {})
            print(f"check {what}: ValueError as required ({raised})")
            continue
        got, snap = counted(counters, lambda: as_tuple(call(mode)))
        torch.cuda.synchronize()
        expect_counts(what, snap, {kernel: 1})
        path_counts[what] = snap
        check(len(got) == len(want), f"{what}: {len(got)} bands, want {len(want)}")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: shape or dtype")
            err = max(err, float((g.float() - w.float()).abs().max()))
        check(err == 0.0, f"{what}: max_abs_err {err} against the plain version")
        max_err[kernel] = max(max_err[kernel], err)
        outs[mode] = got
        print(f"check {what} ({kernel}, {mode or resolved}): launches={snap['launches'][kernel]} "
              f"max_abs_err={err} bands={[(tuple(g.shape), str(g.dtype)) for g in got]}")
    for mode in ("streaming", "tiled2d"):
        if mode in outs:
            same = all(torch.equal(a, b) for a, b in zip(outs[mode], outs["window"]))
            check(same, f"{name}: {mode} differs from window")
    print(f"check {name}: window, streaming and tiled2d bit-identical "
          f"({'streaming over budget' if 'streaming' not in outs else 'all three ran'})")
    return want, planes, resolved


def table_phase(dev, counters, stencil, ref, ImageStream, max_err: dict, results: dict) -> None:
    """Phase 2's chains that fixed-size tables once refused (`table_cases`):
    each in every mode, one launch and bit-equal to the plain version
    (`check_modes`); then nine pyrDowns on a 600x700 u8 plane, which the
    plain version runs and both kernels refuse by `ValueError` naming the
    limit that binds: a tile and a step must be multiples of the stride
    product 512, and a 512-row tile's window is far over a block's shared
    memory."""
    import torch

    from repro_torch.core.device import LaunchConfig

    counts = {}
    for case in table_cases(dev, stencil, ImageStream):
        check_modes(case, counters, stencil, ref, counts, max_err)
        results["checks"][f"table chain {case['name']}"] = {"max_abs_err": 0.0}
    img = ImageStream().image(TABLE_HW, seed=22).to(dev)
    nine = tuple(stencil.pyr_down_stage() for _ in range(9))
    want = stencil.fused_chain(img, nine, mode="ref")
    check(tuple(want.shape) == (2, 2), f"nine pyrDowns: plain shape {tuple(want.shape)}")
    for mode, lc, limit in (("window", LaunchConfig(), "stride product"),
                            ("window", LaunchConfig(tile_rows=512, tile_cols=512), "shared memory"),
                            ("streaming", LaunchConfig(stream_rows=64), "stride product"),
                            ("tiled2d", LaunchConfig(stream_rows=64), "stride product")):
        counters.reset()
        try:
            stencil.fused_chain(img, nine, mode=mode, lc=lc)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and limit in raised,
              f"nine pyrDowns {mode}: want a ValueError naming the {limit}, got {raised}")
        check(sum(counters.LAUNCHES.values()) == 0, f"nine pyrDowns {mode}: launched")
        print(f"check nine pyrDowns 600x700 u8 {mode}: ValueError as required "
              f"({(raised or '')[:120]})")
    torch.cuda.synchronize()
    results["checks"]["nine pyrDowns 600x700 u8"] = "refused by the stride product and shared memory"


def window_floor_ms(stages, shape, dtype) -> dict:
    """The arithmetic `stencil_chain`'s windows do for (N, H, W) planes
    (`exec_window.window_flops` at the launch's tile), with the frames cut
    and with every frame full, and each at the f32 rate."""
    import dataclasses

    from repro_torch.core.device import DEFAULT
    from repro_torch.kernels.stencil import exec_window

    prog = exec_window.compile_chain(stages, dtype)
    th, tw, _ = exec_window.pick_tile(prog, DEFAULT, shape)
    full = dataclasses.replace(prog, frames=tuple(
        f | {"ly": exec_window.UNCUT, "lx": exec_window.UNCUT} for f in prog.frames), _memo={})
    out = {}
    for tag, p in (("cut", prog), ("full", full)):
        flops = shape[0] * exec_window.window_flops(p, th, tw, tuple(shape[1:]))
        out[tag] = {"flops": flops, "ms": flops / PEAK_FP32_FLOPS * 1e3}
    return out


def time_image_case(case, planes, resolved, want) -> dict:
    """Times of one image-path shape on its planes: `stencil_stream` (tiled
    as `mode=None` resolves it; a halo-free chain, which resolves to the
    window kernel, streams full width or, over the budget, tiled) and
    `stencil_chain`, each the faster of two CUDA-event means of 20 calls,
    `ms` the kernel `mode=None` takes; the plain version where the case
    asks for it (``case["plain"]``); the library call ``case["lib"]``
    names (`library_call`).  Bound: the input read once, every band (and
    a remap's map planes) moved once, or the chain's FLOP at the f32 rate."""
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    chain = case["chain"]
    tiled = resolved == "tiled2d"
    if resolved == "window":
        try:
            exec_streaming.stencil_stream(planes, chain)
        except ValueError:
            tiled = True
    run = lambda: exec_streaming.stencil_stream(planes, chain, tiled=tiled)  # noqa: E731
    win = lambda: exec_window.stencil_chain(planes, chain)  # noqa: E731
    plain = lambda: exec_streaming.stencil_stream_plain(planes, chain)  # noqa: E731
    p1 = time_ms(plain, iters=3, warmup=1) if case.get("plain") else None
    s1, w1 = time_ms(run, iters=20), time_ms(win, iters=20)
    s2, w2 = time_ms(run, iters=20), time_ms(win, iters=20)
    p2 = time_ms(plain, iters=3, warmup=1) if case.get("plain") else None
    lib = None
    if case.get("lib"):
        lib = time_ms(library_call(case["lib"], chain, planes, want), iters=20)
    n_bytes = planes.numel() * planes.element_size() + sum(
        w.numel() * w.element_size() for w in want)
    n_bytes += sum(4 * w.numel() for s in chain if s.op == "remap" for w in s.weights)
    n_flops = planes.numel() * chain_flops(chain)
    bms, by = bound_ms(n_bytes, n_flops)
    k1, k2 = (w1, w2) if resolved == "window" else (s1, s2)
    return {
        "resolved": resolved,
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        "stream_ms": min(s1, s2),
        "stream_runs": [s1, s2],
        "stream_tiled": tiled,
        "window_ms": min(w1, w2),
        "window_runs": [w1, w2],
        "plain_ms": None if p1 is None else min(p1, p2),
        "plain_runs": None if p1 is None else [p1, p2],
        "library": case.get("lib"),
        "library_ms": lib,
        "bound_ms": bms,
        "bound_by": by,
        "stream_share": bms / min(s1, s2),
        "window_share": bms / min(w1, w2),
        "bytes": n_bytes,
        "flops": n_flops,
    }


def load_bench():
    """`scripts/torch_pipeline_bench.py`, the pipeline benchmark whose
    `run` and `run_octave` the pipeline phase drives."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_pipeline_bench", ROOT / "scripts" / "torch_pipeline_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (thresh, thresh cast to u8): the seed threshold's table
SEED_THRESHOLDS = (0, 100.5, 254.5, 255.9, 255.99999999, 256, -0.5, -1, -5, 300, 511.7, -256)


def pipeline_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict) -> dict:
    """The fused-vs-staged-vs-seed pipeline benchmark (the fifth slice):
    the seed kernels against their plain versions at odd sizes; the
    pipeline path (fused in every mode, staged, seed) and the octave with
    its next base through `scripts/torch_pipeline_bench.py` `run` and
    `run_octave`, which check them, count each path and take the host
    walls; `ops.pyr_down` and the strided geometry at odd sizes; each
    octave kernel's device time with and without the next base; then each
    seed kernel's device time, plain time, bound and library call.
    Returns the seed kernels' timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.device import LaunchConfig
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil, unfused
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    bench = load_bench()
    gen = torch.Generator(device=dev).manual_seed(16)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def exact(kernel, what, got, want):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        check(err == 0.0, f"{what}: max_abs_err {err} against the plain version")
        max_err[kernel] = max(max_err[kernel], err)
        return err

    # -- the seed kernels against their plain versions -------------------------
    for name, x in (("512x512", u8(512, 512)), ("1081x1919", u8(1081, 1919)),
                    ("37x53", u8(37, 53)), ("511x513", u8(511, 513))):
        small = name in ("37x53", "511x513")
        for k in range(1, 32, 2) if small else (5,):
            exact("seed_gaussian_blur", f"seed blur k={k} {name}",
                  unfused.seed_gaussian_blur_2d(x, k), unfused.seed_gaussian_blur_2d(x, k, mode="ref"))
        for r in (1, 2, 3) if small else (1,):
            exact("seed_erode", f"seed erode r={r} {name}",
                  unfused.seed_erode_2d(x, r), unfused.seed_erode_2d(x, r, mode="ref"))
        for t in SEED_THRESHOLDS if small else (100.0,):
            exact("seed_threshold", f"seed threshold {t} {name}",
                  unfused.seed_threshold_2d(x, t), unfused.seed_threshold_2d(x, t, mode="ref"))
        print(f"check seed kernels {name} u8: max_abs_err 0 (blur k={'1..31' if small else 5}, "
              f"erode r={(1, 2, 3) if small else 1}, thresholds "
              f"{SEED_THRESHOLDS if small else (100.0,)})")

    # -- the pipeline path and the octave with its next base, by the bench -------
    row, rec = bench.run(dev)
    o_row, o_rec = bench.run_octave(dev)
    for r in (rec, o_rec):
        path_counts.update(r.paths)
        for k, e in r.max_err.items():
            max_err[k] = max(max_err[k], e)
    print(f"check pipeline ({row['batch']}) u8: fused one launch in each mode, bit-identical "
          f"to the plain version; staged {row['pallas_calls_staged']} stencil launches "
          f"{snap_nonzero(rec.paths['pipeline staged'])}; seed "
          f"{snap_nonzero(rec.paths['pipeline seed'])}, no plain call, equal to its plain "
          f"version; seed vs staged: "
          f"{row['seed_pixels_differing_from_staged']} pixels differ (predicted 0); fused interior "
          f"equals staged: {row['interior_bitexact']}")
    print(f"check octave+next base {o_row['image']} f32: one launch in each mode that fits, every "
          f"band bit-identical to the plain version (next base {o_row['next_base']}); staged "
          f"{o_row['pallas_calls_staged']} launches {snap_nonzero(o_rec.paths['octave staged'])}")
    for name, r in (("pipeline", row), ("octave", o_row)):
        walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in r.items()
                          if k.endswith("_s") and not k.endswith("median_s"))
        graphs = "; ".join(f"{k} {v:.5f}" for k, v in r.items() if k.endswith("_graph_ms"))
        ratios = " ".join(f"{k}={v:.3f}" for k, v in r.items() if k.startswith("fused_speedup"))
        print(f"time {name} (host wall, best of {bench.RUNS}): {walls}; best mode "
              f"{r['fused_mode']}; {ratios}; device (graph replay): {graphs} card={card}")

    # -- ops.pyr_down at 1080p and 4K, and the strided geometry at odd sizes ----
    stream = ImageStream()
    g = stream.image((512, 512), channels=1, seed=0).to(dev).float()
    oct_nb = features.octave_chain(bench.N_SCALES)
    for res in ("1080p", "4K"):
        x = stream.image(RES[res], seed=3).to(dev)
        p_res = stencil.resolve_mode((stencil.pyr_down_stage(),), (1, *RES[res]), x.dtype)
        p_want = ops.pyr_down(x, mode="ref")
        for mode in (None, "window", "streaming", "tiled2d"):
            what = f"pyr_down {res} u8 mode={mode}"
            if mode == "streaming" and p_res == "tiled2d":
                counters.reset()
                try:
                    ops.pyr_down(x, mode=mode)
                    raised = False
                except ValueError:
                    raised = True
                check(raised, f"{what}: over-budget streaming did not raise")
                continue
            kernel = "stencil_chain" if (mode or p_res) == "window" else "stencil_stream"
            got, snap = counted(counters, lambda: ops.pyr_down(x, mode=mode))
            expect_counts(what, snap, {kernel: 1})
            path_counts[what] = snap
            exact(kernel, what, got, p_want)
        print(f"check pyr_down {res} u8 -> {tuple(p_want.shape)}: every mode one launch, "
              f"bit-identical to the plain version (mode None -> {p_res})")
    geoms = [
        ("octave+next base (301, 97) f32 streaming", g[:301, :97], oct_nb, "streaming",
         LaunchConfig(row_segments=3)),
        ("octave+next base (301, 203) f32 tiled2d", g[:301, :203], oct_nb, "tiled2d",
         LaunchConfig(tile2d_cols=64, row_segments=3)),
        ("octave+next base (301, 203) f32 window", g[:301, :203], oct_nb, "window",
         LaunchConfig(tile_rows=16, tile_cols=16)),
        ("pyr_down (1081, 1919) u8 tiled2d", stream.image((1081, 1919), seed=4).to(dev),
         (stencil.pyr_down_stage(),), "tiled2d", LaunchConfig(tile2d_cols=64, row_segments=5)),
    ]
    for what, x, chain, mode, lc in geoms:
        x = x.contiguous()
        planes = ref.to_planes(x)
        if mode != "window":
            prog, _ = exec_streaming.program(chain, lc.stream_rows, x.dtype, dev)
            geo = exec_streaming.stream_geometry(prog, tuple(planes.shape), lc,
                                                 tiled=mode == "tiled2d")
            check(geo.n_seg >= 2 and (mode == "streaming" or geo.n_tiles >= 2),
                  f"{what}: {geo.n_tiles} tiles, {geo.n_seg} segments")
        kernel = "stencil_chain" if mode == "window" else "stencil_stream"
        got = as_tuple(stencil.fused_chain(x, chain, mode=mode, lc=lc))
        for a, b in zip(got, as_tuple(stencil.fused_chain(x, chain, mode="ref")), strict=True):
            exact(kernel, what, a, b)
        print(f"check {what}: bit-identical to the plain version, bands "
              f"{[tuple(a.shape) for a in got]}")

    # -- times ------------------------------------------------------------------
    o_ms = {}
    planes = ref.to_planes(g)
    for name, chain in (("next base", oct_nb),
                        ("no next base", features.octave_chain(4, with_next_base=False))):
        o_ms[f"stencil_chain {name}"] = time_ms(
            lambda chain=chain: exec_window.stencil_chain(planes, chain), iters=20)
        o_ms[f"stencil_stream tiled2d {name}"] = time_ms(
            lambda chain=chain: exec_streaming.stencil_stream(planes, chain, tiled=True), iters=20)
    print("time octave 512x512 f32 (device): " + "; ".join(
        f"{k} {v:.5f} ms" for k, v in o_ms.items()) + f" card={card}")

    batch = torch.stack([stream.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    plane = batch[0, :, :, 0].contiguous()
    n_px = plane.numel()
    k1 = ref.gaussian_kernel1d(bench.BLUR_K).to(dev)
    hk = bench.BLUR_K // 2
    xpad = ref.pad_replicate(plane.float(), hk, hk)[None, None].contiguous()
    wt = torch.outer(k1, k1)[None, None].contiguous()
    conv = torch.clamp(torch.round(F.conv2d(xpad, wt)[0, 0]), 0, 255)
    lib_diff = float((conv - unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K).float()).abs().max())
    check(lib_diff <= 1.0, f"conv2d differs from the seed blur by {lib_diff}")
    t8 = unfused.to_u8(bench.THRESH)
    hi, lo = (torch.tensor(v, dtype=torch.uint8, device=dev) for v in (255, 0))
    check(torch.equal(torch.where(plane > t8, hi, lo), unfused.seed_threshold_2d(plane, bench.THRESH)),
          "torch.where differs from the seed threshold")
    seeds = {
        "seed_gaussian_blur": (lambda: unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K),
                               lambda: unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K, mode="ref"),
                               lambda: F.conv2d(xpad, wt), 2 * 2 * bench.BLUR_K),
        "seed_erode": (lambda: unfused.seed_erode_2d(plane, bench.ERODE_R),
                       lambda: unfused.seed_erode_2d(plane, bench.ERODE_R, mode="ref"),
                       None, 2 * 2 * bench.ERODE_R),
        "seed_threshold": (lambda: unfused.seed_threshold_2d(plane, bench.THRESH),
                           lambda: unfused.seed_threshold_2d(plane, bench.THRESH, mode="ref"),
                           lambda: torch.where(plane > t8, hi, lo), 1),
    }
    # Each call is a few microseconds of device work behind tens of host
    # work, so the kernel, its plain version and the library call are each
    # timed as the replay of a CUDA graph of 100 calls (plain, kernel,
    # kernel, plain); `issued_ms` is the kernel issued from Python.
    timings = {}
    for name, (run, plain, lib, flops_px) in seeds.items():
        p1 = bench.graph_ms(plain, reps=100)
        k_1 = bench.graph_ms(run, reps=100)
        k_2 = bench.graph_ms(run, reps=100)
        p2 = bench.graph_ms(plain, reps=100)
        lib_ms = bench.graph_ms(lib, reps=100) if lib else None
        issued = time_ms(run, iters=100)
        n_bytes = 2 * n_px  # the u8 plane read once and written once
        bms, by = bound_ms(n_bytes, n_px * flops_px)
        timings[name] = {"ms_runs": [k_1, k_2], "plain_runs": [p1, p2], "library_ms": lib_ms,
                         "issued_ms": issued, "bound_ms": bms, "bound_by": by,
                         "bytes": n_bytes, "flops": n_px * flops_px}
        print(f"time {name} (one 512x512 u8 plane, graph replay): ms={k_1:.5f}/{k_2:.5f} "
              f"plain_ms={p1:.4f}/{p2:.4f} library_ms={lib_ms} issued_ms={issued:.5f} "
              f"bound_ms={bms:.6f} ({by}; {n_bytes} B, {n_px * flops_px} FLOP) card={card}")
    results["pipeline"] = {"bench": row, "octave": o_row, "octave_ms": o_ms, "seed_times": timings}
    return timings


def rot_about_centre(hw, deg: float = 1.0, shift=(4.0, -3.0)) -> list:
    """Inverse map of a `deg` rotation about the image centre plus an (x, y)
    translation: src = R (dst - c) + c + shift."""
    h, w = hw
    cy, cx = (h - 1) / 2, (w - 1) / 2
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return [[c, -s, cx - c * cx + s * cy + shift[0]], [s, c, cy - s * cx - c * cy + shift[1]]]


def smooth_maps(hw, dev) -> tuple:
    """An identity map plus a smooth field (tests/test_stencil.py:516), f32
    (H, W) on the card: (map_x, map_y)."""
    import torch

    yy, xx = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32, device=dev),
                            torch.arange(hw[1], dtype=torch.float32, device=dev), indexing="ij")
    return xx + 1.2 * torch.cos(yy / 5.0), yy + 1.5 * torch.sin(xx / 7.0)


def geometric_cases(dev, imgproc, ops, stencil, ImageStream) -> list:
    """The sixth slice's image-op shapes at 1080p and 4K u8: warp_affine (a
    1-degree rotation about the centre and a (4, -3) translation), remap
    (an identity map plus a smooth field), resize_half, sobel, sobel ->
    grad_mag and gaussian(3) -> resize2(tap=0); then the same bodies at
    odd sizes with several window tiles, column tiles and row segments,
    where a gather origin off by a row or a column shows."""
    from repro_torch.core.device import LaunchConfig

    stream = ImageStream()
    cases = []

    def add(name, img, chain, call, lib=None):
        cases.append({"name": name, "img": img, "chain": chain, "call": call, "lib": lib,
                      "plain": True})

    def shapes(tag, img, lc=None):
        hw = tuple(img.shape[-2:])
        kw = {} if lc is None else {"lc": lc}
        M = rot_about_centre(hw)
        warp = (stencil.warp_affine_stage(M, shape=hw),)
        mx, my = smooth_maps(hw, dev)
        remap = (stencil.remap_stage(mx, my),)
        sob, sob_grad = (stencil.sobel_stage(),), (stencil.sobel_stage(), stencil.grad_stage())
        res, g_res = (stencil.resize2_stage(),), (stencil.gaussian_stage(3),
                                                  stencil.resize2_stage(tap=0))
        add(f"warp_affine {tag}", img, warp,
            lambda mode: stencil.fused_chain(img, warp, mode=mode, **kw)
            if lc else imgproc.warp_affine(img, M, mode=mode), "grid_sample")
        add(f"remap {tag}", img, remap,
            lambda mode: stencil.fused_chain(img, remap, mode=mode, **kw)
            if lc else imgproc.remap(img, mx, my, mode=mode), "grid_sample")
        add(f"resize_half {tag}", img, res,
            lambda mode: imgproc.resize_half(img, mode=mode, **kw), "avg_pool2d")
        add(f"sobel {tag}", img, sob, lambda mode: ops.sobel(img, mode=mode, **kw),
            "conv2d")
        add(f"sobel->grad_mag {tag}", img, sob_grad,
            lambda mode: stencil.fused_chain(img, sob_grad, mode=mode, **kw))
        add(f"gaussian(3)->resize2(tap=0) {tag}", img, g_res,
            lambda mode: stencil.fused_chain(img, g_res, mode=mode, **kw))

    for res in ("1080p", "4K"):
        shapes(f"{res} u8", stream.image(RES[res], seed=5).to(dev))
    odd = LaunchConfig(tile_rows=16, tile_cols=16, tile2d_cols=224, row_segments=7)
    shapes("1081x1919 u8 (16x16 tiles, 224 columns, 7 segments)",
           stream.image((1081, 1919), seed=6).to(dev), odd)
    small = LaunchConfig(tile_rows=8, tile_cols=8, tile2d_cols=16, row_segments=3, stream_rows=4)
    shapes("37x53 f32 (8x8 tiles, 16 columns, 3 segments)",
           stream.image((37, 53), seed=7).to(dev).float(), small)
    return cases


def library_call(kind: str, chain, planes, want):
    """The PyTorch call that computes a case's function, as a time
    yardstick: `grid_sample` (bilinear, border, align_corners) on the
    gather's coordinates precomputed as a grid, `avg_pool2d` for
    resize_half, `conv2d` with the filter2D taps or the (2, 1, 3, 3) Sobel
    weight on the edge-padded plane, `conv_transpose2d` for pyrUp; inputs
    widened and padded to f32 outside the timed call (TF32 off).  Checked within 1 of the plain
    version's first band (its rounding is not the reference's).  -> the
    call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    x = planes.float()[:, None].contiguous()
    N, H, W = planes.shape
    if kind == "grid_sample":
        yy, xx = torch.meshgrid(torch.arange(H, device=planes.device),
                                torch.arange(W, device=planes.device), indexing="ij")
        s = chain[0]
        if s.op == "warp_affine":
            sy, sx = ref.affine_coords(s.static, yy, xx)
        else:
            sx, sy = s.weights
        grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], dim=-1)
        grid = grid[None].expand(N, H, W, 2).contiguous()

        def call():
            return F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)
        out = call()[:, 0]
    elif kind == "avg_pool2d":
        def call():
            return F.avg_pool2d(x, 2)
        out = call()[:, 0]
    elif kind == "conv_transpose2d":
        # pyrUp: the plane edge-padded by one, transposed-convolved at stride
        # 2 with 4 k (x) k (k the 5-tap [1,4,6,4,1]/16), rows and columns
        # [4, 4 + 2H) of the result
        k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=planes.device) / 16.0
        wt = (4.0 * torch.outer(k1, k1))[None, None].contiguous()
        xp = ref.pad_replicate(x, 1, 1).contiguous()

        def call():
            return F.conv_transpose2d(xp, wt, stride=2)
        out = call()[:, 0, 4:4 + 2 * H, 4:4 + 2 * W]
    else:  # conv2d: the filter2D taps, or the (2, 1, 3, 3) Sobel pair
        if chain[0].op == "filter2d":
            wt = chain[0].weights[0].to(planes.device)[None, None].contiguous()
        else:
            wt = torch.tensor([[[[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]],
                               [[[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]]]],
                              device=planes.device)
        h = wt.shape[-1] // 2
        xp = ref.pad_replicate(x, h, h).contiguous()

        def call():
            return F.conv2d(xp, wt)
        out = call()[:, 0]
    diff = float((out - want[0].float()).abs().max())
    check(diff <= 1.0, f"library call {kind} differs from the plain version by {diff}")
    return call


def geometric_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict) -> None:
    """The geometric path (the sixth slice): the image-op shapes of
    `geometric_cases` in every mode (`check_modes`); `run_warp` of
    `scripts/torch_pipeline_bench.py` (the warp -> ladder chain fused in
    every mode that fits against 8 staged launches, with its checks and
    walls); `features.align_and_detect` on the benchmark's plane against a
    `mode="ref"` run on the card, keypoints equal but at counted near-ties;
    then each shape's kernel times (the kernel `mode=None` takes and the
    other one, CUDA-event means), plain time, bound and library call."""
    import torch
    from repro_torch.cv import features, imgproc
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil

    cases = geometric_cases(dev, imgproc, ops, stencil, ImageStream)
    timed = []
    for case in cases:
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"geometric {case['name']}"] = {"resolved": resolved, "max_abs_err": 0.0}
        if " 4K " in case["name"] or " 1080p " in case["name"]:
            timed.append((case, want, planes, resolved))

    # -- run_warp, by the benchmark -------------------------------------------
    bench = load_bench()
    row, rec = bench.run_warp(dev)
    path_counts.update(rec.paths)
    for k, e in rec.max_err.items():
        max_err[k] = max(max_err[k], e)
    walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in row.items()
                      if k.endswith("_s") and not k.endswith("median_s"))
    print(f"check warp chain {row['image']} f32 (halo {row['halo']}): one launch in each mode that "
          f"fits, every band bit-identical to the plain version; staged "
          f"{row['pallas_calls_staged']} launches {snap_nonzero(rec.paths['warp staged'])}; fused "
          f"interior equals staged: {row['interior_bitexact']}")
    print(f"time warp chain (host wall, best of {bench.RUNS}): {walls}; best mode "
          f"{row['fused_mode']}; fused_speedup={row['fused_speedup']:.3f}; device (graph replay): "
          + " ".join(f"{k} {v:.5f}" for k, v in row.items() if k.endswith("_graph_ms"))
          + f" ms card={card}")

    # -- align_and_detect on the benchmark's plane ----------------------------
    plane = ImageStream().image((512, 512), channels=1, seed=0).to(dev).float()[None]
    M = bench.warp_matrix()
    chain = features.aligned_octave_chain(M, (512, 512), n_scales=bench.N_SCALES)
    a_res = stencil.resolve_mode(chain, (1, 512, 512), plane.dtype)
    a_kernel = "stencil_chain" if a_res == "window" else "stencil_stream"
    det, snap = counted(counters, lambda: features.align_and_detect(plane, M, max_kp=64))
    expect_counts("align_and_detect", snap, {a_kernel: 1})
    path_counts["align_and_detect"] = snap
    want = features.align_and_detect(plane, M, max_kp=64, mode="ref")
    torch.cuda.synchronize()
    check(torch.equal(det["gray"], want["gray"]), "align_and_detect: warped gray differs")
    off = ((det["xy"] != want["xy"]).any(-1) | (det["scale"] != want["scale"]))[0]
    resp = want["resp"][0]
    ulp = torch.nextafter(resp.abs(), torch.full_like(resp, math.inf)) - resp.abs()
    gap = torch.minimum(torch.cat([resp[:-1] - resp[1:], resp[-1:]]),
                       torch.cat([resp[:1], resp[:-1] - resp[1:]]))
    near = gap <= 4 * ulp
    n_off = int(off.sum())
    check(bool((near[off]).all()), "align_and_detect: a keypoint differs off a near-tie")
    print(f"check align_and_detect 512x512 f32 ({a_kernel}, {a_res}): one launch, "
          f"{int(det['valid'].sum())} valid keypoints; {n_off} of {off.numel()} differ from the "
          f"mode='ref' run, each at a near-tie (resp within 4 ulp of a neighbour; "
          f"{int(near.sum())} near-ties in all)")
    results["geometric"] = {"warp_bench": row, "align_and_detect": {
        "resolved": a_res, "keypoints_differing": n_off, "near_ties": int(near.sum())}}

    # -- times ----------------------------------------------------------------
    times = {}
    g = plane[0]
    timed.append(({"name": "warp chain 512x512 f32", "chain": chain, "plain": True},
                  as_tuple(stencil.fused_chain(g, chain, mode="ref")), ref.to_planes(g),
                  stencil.resolve_mode(chain, (1, 512, 512), g.dtype)))
    for case, want, planes, resolved in timed:
        name = case["name"]
        t = times[name] = time_image_case(case, planes, resolved, want)
        print(f"time {name}: ms={t['ms']:.5f} ({resolved}) stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}) window_ms={t['window_ms']:.5f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']} ({t['library']}) "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) "
              f"card={card}")
    results["geometric"]["times"] = times


def level_cases(dev, ops, stencil, ImageStream) -> list:
    """The seventh slice's shapes: `ops.pyr_up` at 1080p and 4K u8 (outputs
    2160x3840 and 4320x7680, `conv_transpose2d` as the library call), and
    the chains with a resolution change before their last stage, pyrDown ->
    pyrUp, gaussian(5) -> pyrDown -> erode(1), resize2 -> gaussian(3) and
    pyrUp -> gaussian(3), at 1080p u8 and again at 1081x1919 u8 and 37x53
    f32 with several window tiles, column tiles and row segments, where a
    frame or phase off by one row or column shows."""
    from repro_torch.core.device import LaunchConfig

    stream = ImageStream()
    cases = []
    up = (stencil.pyr_up_stage(),)
    chains = {
        "pyr_down->pyr_up": (stencil.pyr_down_stage(), stencil.pyr_up_stage()),
        "gaussian(5)->pyr_down->erode(1)": (stencil.gaussian_stage(5), stencil.pyr_down_stage(),
                                            stencil.erode_stage(1)),
        "resize2->gaussian(3)": (stencil.resize2_stage(), stencil.gaussian_stage(3)),
        "pyr_up->gaussian(3)": (stencil.pyr_up_stage(), stencil.gaussian_stage(3)),
    }
    for res in ("1080p", "4K"):
        img = stream.image(RES[res], seed=8).to(dev)
        cases.append({"name": f"pyr_up {res} u8", "img": img, "chain": up, "plain": True,
                      "lib": "conv_transpose2d",
                      "call": lambda mode, img=img: ops.pyr_up(img, mode=mode)})
    shapes = [
        ("1080p u8", stream.image(RES["1080p"], seed=9).to(dev), None),
        ("1081x1919 u8 (16x16 tiles, 224 columns, 7 segments)",
         stream.image((1081, 1919), seed=10).to(dev),
         LaunchConfig(tile_rows=16, tile_cols=16, tile2d_cols=224, row_segments=7)),
        ("37x53 f32 (8x8 tiles, 16 columns, 3 segments)",
         stream.image((37, 53), seed=11).to(dev).float(),
         LaunchConfig(tile_rows=8, tile_cols=8, tile2d_cols=16, row_segments=3, stream_rows=4)),
    ]
    for tag, img, lc in shapes:
        kw = {} if lc is None else {"lc": lc}
        for name, chain in chains.items():
            cases.append({"name": f"{name} {tag}", "img": img, "chain": chain, "plain": False,
                          "lib": None, "call": lambda mode, img=img, chain=chain, kw=kw:
                          stencil.fused_chain(img, chain, mode=mode, **kw)})
    return cases


def blob_image(hw, dev, seed: int, cell: int = 64):
    """An (H, W) f32 image of Gaussian blobs on a dim ramp, one blob in each
    `cell` x `cell` square (sigma 1.5 to 16 pixels, centre and amplitude
    jittered, from a CPU generator at `seed`), each summed over its own and
    the neighbouring squares: structure at every octave's scale, apart
    enough that each octave of a 4-octave pyramid holds keypoints."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    ny, nx = -(-h // cell), -(-w // cell)
    p = torch.rand((ny, nx, 4), generator=gen).to(dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    iy0, ix0 = (yy // cell).long(), (xx // cell).long()
    img = 20.0 + 10.0 * xx / w
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            iy, ix = iy0 + dy, ix0 + dx
            inside = ((iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)).float()
            iy, ix = iy.clamp(0, ny - 1), ix.clamp(0, nx - 1)
            q = p[iy, ix]
            s = 1.5 + 14.5 * q[..., 0]
            cy = (iy.float() + 0.25 + 0.5 * q[..., 1]) * cell
            cx = (ix.float() + 0.25 + 0.5 * q[..., 2]) * cell
            img = img + inside * (40.0 + 80.0 * q[..., 3]) * torch.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img / img.max() * 255.0


def keypoints_equal_but_near_ties(what: str, got: dict, want: dict, keys) -> tuple:
    """Per image, the keypoints of `got` equal `want`'s on `keys` except
    where `want`'s response lies within 4 ulps of a neighbour's; -> (the
    keypoints differing, the near-ties)."""
    import torch

    n_off = n_near = 0
    for i in range(want["resp"].shape[0]):
        off = torch.zeros_like(want["valid"][i])
        for k in keys:
            d = got[k][i] != want[k][i]
            off |= d.any(-1) if d.ndim > 1 else d
        resp = want["resp"][i]
        ulp = torch.nextafter(resp.abs(), torch.full_like(resp, math.inf)) - resp.abs()
        gap = torch.minimum(torch.cat([resp[:-1] - resp[1:], resp[-1:]]),
                           torch.cat([resp[:1], resp[:-1] - resp[1:]]))
        near = gap <= 4 * ulp
        check(bool(near[off].all()), f"{what}: a keypoint differs off a near-tie")
        n_off, n_near = n_off + int(off.sum()), n_near + int(near.sum())
    return n_off, n_near


def pyramid_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict,
                  train_set: tuple, test_imgs) -> None:
    """The multi-octave pyramid path (the seventh slice): `level_cases` in
    every mode (`check_modes`); `features.sift_pyramid` with 4 octaves (16
    keypoints an octave, 64 in all) on 512x512, 1080p and 4K gray f32
    images of Gaussian blobs at every octave's scale (`blob_image`; 4
    launches, no plain call, every band
    bit-equal to the plain version, keypoints equal to a `mode="ref"` run
    on the card but at counted near-ties); BoW `train` and `predict` with
    both heads at `PipelineConfig(preprocess=True, n_octaves=3, max_kp=32)`
    on the fourth slice's images (1 `stencil_stream` for the preprocess
    chain and 3 `stencil_chain`, one an octave: the 32, 16 and 8 pixel
    planes are no larger than the 36-pixel halo), labels identical across
    two runs and within 1% of a plain predict on the CPU; `run_pyramid` of
    the benchmark; then the times of pyr_up (both kernels, plain,
    `conv_transpose2d`, bound) and of each 1080p pyramid link."""
    import torch
    from repro_torch.cv import classify, features, pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil

    timed = []
    for case in level_cases(dev, ops, stencil, ImageStream):
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"pyramid path {case['name']}"] = {"resolved": resolved,
                                                             "max_abs_err": 0.0}
        if case["name"].startswith("pyr_up "):
            timed.append((case, want, planes, resolved))

    # -- sift_pyramid, 4 octaves, at three sizes --------------------------------
    chains = features.pyramid_chains(4)
    pyr = {}
    for name, hw in (("512x512", (512, 512)), ("1080p", RES["1080p"]), ("4K", RES["4K"])):
        g = blob_image(hw, dev, seed=12)[None]
        plan = stencil.pyramid_plan(chains, hw)
        kernels = ["stencil_chain" if p["mode"] == "window" else "stencil_stream" for p in plan]
        launches = {k: kernels.count(k) for k in set(kernels)}
        # 16 a octave: the merge then keeps each octave's best, not only octave 0's
        det, snap = counted(counters, lambda: features.sift_pyramid(g, n_octaves=4, max_kp=64,
                                                                    kp_per_octave=16))
        expect_counts(f"sift_pyramid {name}", snap, launches)
        path_counts[f"sift_pyramid {name}"] = snap
        want = features.sift_pyramid(g, n_octaves=4, max_kp=64, kp_per_octave=16, mode="ref")
        gn = features._normalize_gray(g)[..., None]
        (outs, _), snap_b = counted(counters, lambda: stencil.chained_launches(gn, chains))
        expect_counts(f"chained_launches {name}", snap_b, launches)
        path_counts[f"chained_launches {name}"] = snap_b
        ref_outs, _ = stencil.chained_launches(gn, chains, mode="ref")
        torch.cuda.synchronize()
        for o, (a, b) in enumerate(zip(outs, ref_outs, strict=True)):
            for x, y in zip(a, b, strict=True):
                check(x.shape == y.shape and torch.equal(x, y),
                      f"sift_pyramid {name}: octave {o} band differs from the plain version")
        n_off, n_near = keypoints_equal_but_near_ties(f"sift_pyramid {name}", det, want,
                                                      ("xy", "octave", "scale", "valid"))
        per_octave = [int(((det["octave"][0] == o) & det["valid"][0]).sum()) for o in range(4)]
        print(f"check sift_pyramid {name} f32: {snap_nonzero(snap)} (links "
              f"{[p['mode'] for p in plan]}), every band bit-equal to the plain version; "
              f"{int(det['valid'].sum())} valid keypoints {per_octave} by octave; {n_off} differ "
              f"from mode='ref', each at a near-tie ({n_near} near-ties)")
        pyr[name] = {"links": plan, "launches": snap_nonzero(snap), "keypoints_differing": n_off,
                     "near_ties": n_near, "per_octave": per_octave, "g": gn, "outs": outs}

    # -- BoW train + predict at n_octaves=3, both heads --------------------------
    imgs, labels = train_set
    batches = test_imgs.split(PREDICT_BATCH)
    bow = {}
    for head in HEADS:
        cfg = PipelineConfig(preprocess=True, n_octaves=3, max_kp=32, head=head)
        model, snap = counted(counters, lambda cfg=cfg: pipeline.train(
            imgs, labels, cfg, dict_size=DICT_SIZE, generator=torch.Generator().manual_seed(0),
            device=dev))
        expect_counts(f"train {head} n_octaves=3", snap,
                      {"stencil_stream": 1, "stencil_chain": 3, "bow_assign": 21})
        path_counts[f"train {head} n_octaves=3"] = snap
        preds = []
        path = {"launches": dict.fromkeys(counters.KERNELS, 0), "plain_calls": {}}
        for i, xb in enumerate(batches):
            pb, snap = counted(counters, lambda xb=xb, cfg=cfg: pipeline.predict(
                model, xb, cfg, device=dev))
            expect_counts(f"predict {head} n_octaves=3 request {i}", snap,
                          {"stencil_stream": 1, "stencil_chain": 3, "bow_quantize_hist": 1,
                           HEAD_KERNEL[head]: 1})
            for k, v in snap["launches"].items():
                path["launches"][k] += v
            preds.append(pb)
        path_counts[f"predict {head} n_octaves=3"] = path
        pred = torch.cat(preds).cpu()
        again = torch.cat([pipeline.predict(model, xb, cfg, device=dev) for xb in batches]).cpu()
        check(torch.equal(pred, again), f"{head} n_octaves=3: labels differ between two runs")
        plan_cpu = classify.build_plan(copy.deepcopy(model).cpu(), cfg, device="cpu")
        feats = pipeline.extract_features(test_imgs, cfg, device="cpu")
        scores = plan_cpu.scores(plan_cpu.histograms(feats["desc"], feats["valid"]))
        mism = int((scores.argmax(1).to(torch.int32) != pred).sum())
        print(f"check BoW {head} n_octaves=3: train {snap_nonzero(path_counts[f'train {head} n_octaves=3'])}, "
              f"predict {len(batches)} requests {snap_nonzero(path)}; labels identical across two "
              f"runs; {mism} of {len(pred)} differ from a plain CPU predict (limit 1%)")
        check(mism <= 0.01 * len(pred), f"{head} n_octaves=3: card and CPU predictions disagree")
        bow[head] = {"mismatches_vs_cpu": mism}

    # -- run_pyramid, by the benchmark -------------------------------------------
    bench = load_bench()
    row, rec = bench.run_pyramid(dev)
    path_counts.update(rec.paths)
    for k, e in rec.max_err.items():
        max_err[k] = max(max_err[k], e)
    walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in row.items()
                      if k.endswith("_s") and not k.endswith("median_s"))
    print(f"check pyramid {row['image']} f32, {row['n_octaves']} octaves (links "
          f"{row['link_modes']}): {row['pallas_calls_fused']} launches in each mode that fits, "
          f"every band bit-identical to the plain version; staged {row['pallas_calls_staged']} "
          f"launches {snap_nonzero(rec.paths['pyramid staged'])}")
    print(f"time pyramid (host wall, best of {bench.RUNS}): {walls}; best mode "
          f"{row['fused_mode']}; fused_speedup={row['fused_speedup']:.3f}; device (graph replay): "
          + " ".join(f"{k} {v:.5f}" for k, v in row.items() if k.endswith("_graph_ms"))
          + f" ms card={card}")

    # -- times ----------------------------------------------------------------
    times = {}
    for case, want, planes, resolved in timed:
        name = case["name"]
        t = times[name] = time_image_case(case, planes, resolved, want)
        print(f"time {name}: ms={t['ms']:.5f} ({resolved}) stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}) window_ms={t['window_ms']:.5f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']} ({t['library']}) "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) "
              f"card={card}")
    links = {}
    for name, p in pyr.items():
        base = p.pop("g")  # (1, H, W, 1): the normalised gray; then each next base
        del p["outs"]
        total = {"ms": 0.0, "bytes": 0, "flops": 0.0}
        for k, (chain, link) in enumerate(zip(chains, p["links"])):
            want = as_tuple(stencil.fused_chain(base, chain, mode="ref"))
            mode = link["mode"]
            run = lambda base=base, chain=chain, mode=mode: stencil.fused_chain(  # noqa: E731
                base, chain, mode=mode)
            plain = lambda base=base, chain=chain: stencil.fused_chain(  # noqa: E731
                base, chain, mode="ref")
            ms = min(time_ms(run, iters=10), time_ms(run, iters=10))
            pms = time_ms(plain, iters=2, warmup=1)
            n_bytes = 4 * (base.numel() + sum(w.numel() for w in want))
            n_flops = base.numel() * chain_flops(chain)
            bms, by = bound_ms(n_bytes, n_flops)
            links[f"{name} link {k}"] = {"shape": link["shape"], "mode": mode, "ms": ms,
                                         "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                                         "bytes": n_bytes, "flops": n_flops}
            print(f"time sift_pyramid {name} link {k} {link['shape']} ({mode}): ms={ms:.5f} "
                  f"plain_ms={pms:.4f} bound_ms={bms:.5f} ({by}; {n_bytes} B, {n_flops} FLOP) "
                  f"card={card}")
            total["ms"] += ms
            total["bytes"] += n_bytes
            total["flops"] += n_flops
            base = want[-1]
        bms, by = bound_ms(total["bytes"], total["flops"])
        links[f"{name} all links"] = {"ms": total["ms"], "bound_ms": bms, "bound_by": by,
                                      "bytes": total["bytes"], "flops": total["flops"]}
        print(f"time sift_pyramid {name} 4 links: ms={total['ms']:.5f} bound_ms={bms:.6f} ({by}; "
              f"{total['bytes']} B) card={card}")
    results["pyramid"] = {"times": times, "links": links, "sift_pyramid": pyr, "bow": bow,
                          "bench": row}


def snap_nonzero(snap: dict) -> dict:
    return {k: v for k, v in snap["launches"].items() if v}


def flash_bound(q, k, causal: bool = True) -> dict:
    """The least time one flash-attention call could take on the card: q, k,
    v read once and o written once, over the memory rate; or its operations
    over the rate of the units that do them, counting 2 FLOP per (query, key,
    channel) of a product over the (query, key) pairs the mask keeps.  In f16
    / bf16 q.k and two 16-bit p.v passes (p_hi.v + p_lo.v) run on the tensor
    cores; in f32 both products run as f32 FMAs.  `bound_ms_f32_pv` is the
    earlier price of the same call, kept for comparison: q.k at the
    tensor-core rate, one p.v at the f32 rate."""
    import torch

    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    half = 2 * B * H * hd * pairs
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    if q.dtype == torch.float32:
        flops, rate, qk_rate = 2 * half, PEAK_FP32_FLOPS, PEAK_FP32_FLOPS
    else:
        flops, rate, qk_rate = 3 * half, PEAK_BF16_FLOPS, PEAK_BF16_FLOPS
    t_ops = flops / rate * 1e3
    t_f32_pv = (half / qk_rate + half / PEAK_FP32_FLOPS) * 1e3
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_pv": max(t_bytes, t_f32_pv),
            "bound_ms_all_f32": max(t_bytes, 2 * half / PEAK_FP32_FLOPS * 1e3)}


def walk_prefill(model, tokens, *, mode=None, visit=None):
    """The prefill's layers over `tokens` (`lm.prefill`'s loop) -> the
    final-normed hidden states at every position, (B, S, D); `visit(i, x)`
    sees layer i's normed input first."""
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import apply_norm

    cfg = model.cfg
    norm = dict(kind=cfg.norm, eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    h = lm._embed(model, tokens)
    i = 0
    for kind, layers in model.groups():
        for p in layers:
            if visit is not None:
                visit(i, apply_norm(h, p["ln1"], **norm))
            h, _ = blocks.apply_block(kind, p, h, cfg, mode=mode)
            i += 1
    return apply_norm(h, model.final_norm, **norm)


def lm_phase(dev, cfg, *, batch: int, prompt_len: int, gen_len: int, max_err: dict,
             judge=check, timed: bool = True) -> dict:
    """The LM serving path: build `cfg`'s model on the card from a seeded
    generator; hold `flash_attention` against its plain version within
    `AGREE` (and, in bf16, `OFF_PLAIN_SHARE`) on the path's own tensors (every layer's q, k, v of the bf16
    prefill, an f32 copy of layer 0's) and on the JAX kernel test's shapes;
    greedy-generate `batch` x `prompt_len` + `gen_len` tokens (one launch
    per layer, no plain call); check the tokens (identical across two runs;
    teacher-forced through a `mode="ref"` prefill, each the plain path's
    argmax but at counted near-ties); time the kernel, its plain version,
    SDPA, the prefill and a decode step (when `timed`); last, widen the
    weights to f32 and hold the kernel path's hidden states at every prompt
    position, and its last-token logits, against the plain path's.
    `judge(ok, msg)` takes each check's verdict: `check` raises at the
    first failure, scripts/torch_flash_faults.py records them all."""
    import numpy as np
    import torch
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import counters
    from repro_torch.models import lm
    from repro_torch.models.attention import gqa_project_qkv
    from repro_torch.serve import cv_engine

    out: dict = {"config": cfg.name, "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["weights_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"lm {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"params={out['params']} weights={out['weights_bytes']} B init_s={out['init_s']:.2f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)

    # -- the kernel against its plain version --------------------------------
    # held to kattn.AGREE (one rounding to the output dtype apart); the JAX
    # kernel test's looser rtol = atol (tests/test_kernels_attention.py:20,
    # :29) is reported beside it
    jax_test_tol = {torch.float32: 2e-4, torch.float16: 3e-2, torch.bfloat16: 3e-2}
    checks = {}

    def check_flash(name, q, k, v, causal):
        got = kattn.flash_attention(q, k, v, causal=causal)
        want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
        torch.cuda.synchronize(dev)
        judge(got.shape == q.shape and got.dtype == q.dtype, f"flash {name}: shape or dtype")
        judge(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
        rtol, atol = kattn.AGREE[q.dtype]
        jt = jax_test_tol[q.dtype]
        w = want.float()
        diff = (got.float() - w).abs()
        err = float(diff.max())
        # the largest |got - want| / (atol + rtol |want|): over 1 fails
        excess = float((diff / (atol + rtol * w.abs())).max())
        excess_jax = float((diff / (jt + jt * w.abs())).max())
        print(f"check flash_attention {name} {tuple(q.shape)} T={k.shape[1]} {q.dtype} "
              f"causal={causal}: max_abs_err={err:.3g} share of the tolerance={excess:.3g} "
              f"(rtol {rtol:.3g}, atol {atol:.3g}); at the JAX test's {jt}: {excess_jax:.3g}")
        judge(excess <= 1.0, f"flash {name} {q.dtype}: {excess:.3g} times its tolerance")
        entry = {"max_abs_err": err, "share_of_tol": excess, "share_of_jax_test_tol": excess_jax}
        if q.dtype != torch.float32:
            # AGREE passes one 16-bit pass of p too: the p_hi + p_lo split
            # shows in the share of outputs off the plain version's
            off = float((got != want).float().mean())
            print(f"  outputs off the plain version's: {off:.5f} (limit {kattn.OFF_PLAIN_SHARE})")
            judge(off <= kattn.OFF_PLAIN_SHARE,
                  f"flash {name} {q.dtype}: {off:.3g} of its outputs off the plain version's")
            entry["off_plain"] = off
        checks[f"{name} {tuple(q.shape)} {q.dtype} causal={causal}"] = entry
        max_err["flash_attention"] = max(max_err["flash_attention"], err)

    with torch.inference_mode():
        pos = torch.arange(prompt_len, device=dev)[None, :]
        layer0 = {}

        def visit(i, x):
            q, k, v = gqa_project_qkv(model.blocks[i]["attn"], x, cfg, pos)
            check_flash(f"layer {i} of the prefill", q, k, v, True)
            if i == 0:
                layer0["qkv"] = (q, k, v)

        walk_prefill(model, prompts, visit=visit)
        q, k, v = layer0.pop("qkv")
        check_flash("layer 0 of the prefill, f32 copy", q.float(), k.float(), v.float(), True)
        g = torch.Generator(dev).manual_seed(1)
        for (b, s, t, h, hd) in [(1, 128, 128, 1, 64), (2, 200, 200, 4, 64), (1, 300, 300, 2, 128),
                                 (1, 257, 257, 2, 64), (2, 100, 160, 2, 16), (1, 150, 70, 2, 256)]:
            for dt in (torch.float32, torch.bfloat16):
                qq, kk, vv = (torch.randn((b, n, h, hd), generator=g, device=dev).to(dt)
                              for n in (s, t, t))
                for causal in (True, False):
                    check_flash("JAX test shape", qq, kk, vv, causal)
    out["checks"] = checks

    # -- generate: one flash launch per layer, no plain call -----------------
    def run_generate():
        return cv_engine.generate(model, prompts, steps=gen_len, device=dev)

    t0 = time.perf_counter()
    tokens, snap = counted(counters, run_generate)
    torch.cuda.synchronize(dev)
    wall1 = time.perf_counter() - t0
    expect_counts(f"generate {cfg.name}", snap, {"flash_attention": cfg.n_layers}, judge)
    judge(tokens.shape == (batch, gen_len), f"generate: shape {tuple(tokens.shape)}")
    t0 = time.perf_counter()
    again = run_generate()
    torch.cuda.synchronize(dev)
    wall2 = time.perf_counter() - t0
    judge(torch.equal(tokens, again), "generate: tokens differ between two runs on the card")
    out["generate"] = {"counters": snap, "wall_s": [wall1, wall2],
                       "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    print(f"generate {cfg.name}: {batch} x {prompt_len} + {gen_len} tokens, "
          f"launches={snap['launches']} plain_calls={snap['plain_calls']} "
          f"wall_s={wall1:.3f}/{wall2:.3f} (first / second) identical across runs; "
          f"max_memory_allocated={out['generate']['max_memory_allocated']}")
    print(f"generate {cfg.name}: first request's tokens {tokens[0].tolist()}")

    # -- teacher-forced through the kernel path and the plain path -----------
    # At random init these checks cannot see a kernel fault: the tied
    # embedding, scaled by sqrt(d), dominates the residual stream, so every
    # step's argmax is the token fed in, whatever attention returns.  The
    # checks that depend on attention are the per-layer one above and the
    # f32 hidden states at every position below.
    def forced(mode):
        with torch.inference_mode():
            lg, pc = lm.prefill(model, prompts, mode=mode)
            cache = lm.init_cache(cfg, batch, prompt_len + gen_len, device=dev)
            cache = cv_engine._adopt_prefill(cache, pc, cfg)
            del pc
            steps = [lg.float()]
            for t in range(gen_len - 1):
                lg, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
                steps.append(lg.float())
            return torch.stack(steps, dim=1)  # (B, gen_len, V)

    lk = forced(None)
    judge(torch.equal(lk.argmax(-1).to(tokens.dtype), tokens),
          "teacher-forced kernel path does not reproduce generate's tokens")
    lp = forced("ref")
    diff = float((lk - lp).abs().max())
    pre_k, pre_p = lk[:, 0].clone(), lp[:, 0].clone()  # prefill's last-token logits
    top2 = torch.topk(lp, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    off = lp.argmax(-1).to(tokens.dtype) != tokens
    n_off = int(off.sum())
    print(f"teacher-forced: {n_off} of {off.numel()} tokens are not the plain path's argmax; "
          f"each a near-tie (plain top-2 margin <= {diff:.4g}, the largest logit difference)")
    judge(bool((margin[off] <= diff).all()), "a token differs from the plain path off a near-tie")
    out["tokens"] = {"max_logit_diff": diff, "not_plain_argmax": n_off, "of": off.numel()}
    del lk, lp

    # -- times ---------------------------------------------------------------
    if timed:
        out["flash"] = time_flash(q, k, v)
        # the same call at head dims 64 and 128 (width 4096): a tile's tensor
        # work grows with hd and its softmax does not
        g = torch.Generator(dev).manual_seed(2)
        out["flash_head_dims"] = {
            hd: time_flash(*(torch.randn(q.shape[:2] + (4096 // hd, hd), generator=g,
                                         device=dev).to(q.dtype) for _ in range(3)))
            for hd in (64, 128)}
        lm_times(model, prompts, tokens, out)
    del q, k, v

    # -- the same weights in f32: every position, and the last-token logits --
    # The kernel changes an attention output by a bf16 rounding at most, and
    # 28 layers carry such changes to the logits, as they carry every other
    # bf16 rounding.  So the bf16 tolerance is the bf16 model's own error,
    # e = max |plain bf16 - plain f32| on the same weights, and the kernel
    # path must be as accurate: |kernel - f32| <~ e, so by the triangle
    # inequality |kernel - plain| <= 2e.  The f32 model takes the kernel
    # through every layer at f32 rounding: its kernel and plain paths agree
    # within 2e-3 on the logits (tests/test_decode_consistency.py), and
    # within the kernel's own f32 tolerance on the final-normed hidden
    # states at every prompt position.
    model.float()  # widens the bf16 weights exactly
    with torch.inference_mode():
        l32k, snap = counted(counters, lambda: lm.prefill(model, prompts)[0])
        expect_counts("f32 prefill", snap, {"flash_attention": cfg.n_layers}, judge)
        l32p = lm.prefill(model, prompts, mode="ref")[0]
        hk, hp = walk_prefill(model, prompts), walk_prefill(model, prompts, mode="ref")
    rtol, atol = kattn.AGREE[torch.float32]
    h_share = float(((hk - hp).abs() / (atol + rtol * hp.abs())).max())
    h_err = float((hk - hp).abs().max())
    print(f"f32 hidden states at all {batch} x {prompt_len} positions (max |h| "
          f"{float(hp.abs().max()):.4g}): kernel vs plain max={h_err:.4g} "
          f"share of the tolerance={h_share:.4g} (rtol = atol = {rtol})")
    judge(h_share <= 1.0, f"f32 hidden states: kernel vs plain {h_share:.3g} times the tolerance")
    out["hidden_f32"] = {"max": h_err, "share_of_tol": h_share}
    del hk, hp
    gaps = {"f32 kernel vs plain": (l32k, l32p), "bf16 kernel vs plain": (pre_k, pre_p),
            "bf16 plain vs f32 plain": (pre_p, l32p), "bf16 kernel vs f32 plain": (pre_k, l32p)}
    gaps = {name: {"max": float((a - b).abs().max()), "rms": float((a - b).square().mean().sqrt()),
                   "share_differing": float((a != b).float().mean())}
            for name, (a, b) in gaps.items()}
    print(f"prefill last-token logits (max |logit| {float(l32p.abs().max()):.4g}): "
          + "; ".join(f"{k} max={v['max']:.4g} rms={v['rms']:.4g} differing={v['share_differing']:.4f}"
                      for k, v in gaps.items()))
    err32, pre_err = gaps["f32 kernel vs plain"]["max"], gaps["bf16 kernel vs plain"]["max"]
    bf16_err = gaps["bf16 plain vs f32 plain"]["max"]
    judge(err32 <= 2e-3, f"f32 prefill logits: kernel and plain paths differ by {err32}")
    judge(pre_err <= 2 * bf16_err,
          f"bf16 prefill logits: kernel vs plain {pre_err} > twice the bf16 error {bf16_err}")
    out["prefill_logits"] = gaps
    del model, l32k, l32p
    torch.cuda.empty_cache()
    return out


def time_flash(q, k, v) -> dict:
    """The kernel, its plain version and SDPA (`is_causal=True`, the
    yardstick) on one causal call, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as kattn

    run = lambda: kattn.flash_attention(q, k, v)  # noqa: E731
    plain = lambda: kattn.flash_attention(q, k, v, mode="ref")  # noqa: E731
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    lib_err = float((sdpa().transpose(1, 2).float() - plain().float()).abs().max())
    check(lib_err <= 3e-2 * (1 + float(plain().float().abs().max())),
          f"SDPA disagrees with the plain version by {lib_err}")
    p1 = time_ms(plain, iters=3, warmup=1)
    k1 = time_ms(run, iters=10)
    k2 = time_ms(run, iters=10)
    p2 = time_ms(plain, iters=3, warmup=1)
    lib = time_ms(sdpa, iters=20)
    t = {"ms_runs": [k1, k2], "plain_runs": [p1, p2], "library_ms": lib,
         "sdpa_max_abs_diff": lib_err} | flash_bound(q, k)
    best = min(k1, k2)
    print(f"time flash_attention ({tuple(q.shape)} {q.dtype} causal): ms={k1:.5f}/{k2:.5f} "
          f"plain_ms={p1:.3f}/{p2:.3f} sdpa_ms={lib:.5f} bound_ms={t['bound_ms']:.5f} "
          f"({t['bound_by']}: q.k + p_hi.v + p_lo.v on the tensor cores; {t['bytes']} B, "
          f"{t['flops']} FLOP) share of the bound={t['bound_ms'] / best:.4f}; "
          f"p.v-at-f32 bound_ms={t['bound_ms_f32_pv']:.5f} (share {t['bound_ms_f32_pv'] / best:.4f}); "
          f"all-f32 bound_ms={t['bound_ms_all_f32']:.4f}; SDPA share of the bound="
          f"{t['bound_ms'] / lib:.4f}, kernel / SDPA={best / lib:.3f}; kernel "
          f"{t['flops'] / best / 1e9:.1f} TFLOP/s of q.k + 2 p.v, SDPA "
          f"{2 * t['flops'] / 3 / lib / 1e9:.1f} of q.k + p.v")
    return t


def lm_times(model, prompts, tokens, out: dict) -> None:
    """The prefill (three runs) and each decode step of `tokens`, into `out`."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine

    cfg, dev = model.cfg, prompts.device
    batch, prompt_len = prompts.shape
    gen_len = tokens.shape[1]
    with torch.inference_mode():
        t_pre = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, pc = lm.prefill(model, prompts)
            torch.cuda.synchronize(dev)
            t_pre.append(time.perf_counter() - t0)
        cache = cv_engine._adopt_prefill(
            lm.init_cache(cfg, batch, prompt_len + gen_len, device=dev), pc, cfg)
        del pc
        t_dec = []
        for t in range(gen_len - 1):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
            torch.cuda.synchronize(dev)
            t_dec.append(time.perf_counter() - t0)
        del cache
    pre_s, dec_s = min(t_pre), sorted(t_dec)[len(t_dec) // 2]
    out["prefill_s"], out["decode_step_s"] = t_pre, t_dec
    out["prefill_tok_s"] = batch * prompt_len / pre_s
    out["decode_tok_s"] = batch / dec_s
    print(f"time prefill {batch} x {prompt_len}: s={[round(x, 4) for x in t_pre]} "
          f"({out['prefill_tok_s']:.0f} tok/s at the fastest); decode step (median of "
          f"{len(t_dec)}): {dec_s * 1e3:.3f} ms ({out['decode_tok_s']:.1f} tok/s)")


def counted(counters, fn):
    """Run `fn` with the counters set to 0 just before; -> (its result, the
    launches and plain calls it made)."""
    counters.reset()
    out = fn()
    return out, counters.snapshot()


def expect_counts(what: str, snap: dict, launches: dict, judge=check) -> None:
    """Exactly `launches` (every other kernel 0) and no plain call."""
    want = {k: launches.get(k, 0) for k in snap["launches"]}
    judge(snap["launches"] == want, f"{what}: launches {snap['launches']} != {want}")
    judge(not any(snap["plain_calls"].values()), f"{what}: plain ran: {snap['plain_calls']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it in a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_config
    from repro_torch.cv import classify, features, imgproc, pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.cv.gbdt import GbdtModel
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import _build, counters, ref
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels import gbdt as kgbdt
    from repro_torch.kernels import ops, stencil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"card": None, "checks": {}, "timing": {}, "train": {}, "predict": {}}

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    results["card"] = card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t_build = _build.build_all()
    print(f"build: {t_build:.2f} s (nvcc, sm_90a, {len(sources)} sources: {sources})")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            entry = re.search(r"(flash_attn_(?:wgmma|simt)_kernel)I(\w+?)Li(\d+)E", line)
            if "Compiling entry" in line and entry:  # name each flash body's report
                print(f"ptxas[{name}]: {entry.group(1)}<{entry.group(2)}, {entry.group(3)}>")
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    results["build_s"] = t_build

    pre_chain = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    oct_chain = features.octave_chain(4, with_next_base=False)
    max_err = {k: 0.0 for k in counters.KERNELS}

    # -- 2. each kernel against its plain version on the card -----------------
    def check_chain(name, x, chain):
        """The chain under the kernel `mode=None` resolves to, and under the
        window kernel, each against the plain version."""
        want = stencil.fused_chain(x, chain, mode="ref")
        want = want if isinstance(want, tuple) else (want,)
        resolved = stencil.resolve_mode(chain, ref.to_planes(x).shape, x.dtype)
        for mode in dict.fromkeys((resolved, "window")):
            kernel = "stencil_chain" if mode == "window" else "stencil_stream"
            got = stencil.fused_chain(x, chain, mode=mode)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            check(len(got) == len(want), f"{name}: band count {len(got)} != {len(want)}")
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
                check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
                # the repo's f32 oracle tolerance (tests/test_pyramid.py)
                ok = torch.abs(g - w) <= 2e-3 + 2e-5 * torch.abs(w)
                check(bool(ok.all()), f"{name}: {int((~ok).sum())} pixels off tolerance")
                err = max(err, float((g - w).abs().max()))
            print(f"check {kernel} ({mode}) {name} {tuple(x.shape)}: bands={len(got)} "
                  f"max_err={err:.3g}")
            results["checks"][f"{kernel} {mode} {name}"] = err
            max_err[kernel] = max(max_err[kernel], err)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    check_chain("preprocess", uniform(64, 256, 256, 3), pre_chain)
    check_chain("octave", uniform(256, 256, 256, 1), oct_chain)
    check_chain("octave planes<=halo", uniform(1024, 32, 32, 1), oct_chain)
    table_phase(dev, counters, stencil, ref, ImageStream, max_err, results)

    def check_hist(name, descs, valids, cents):
        """The cluster kernel against its plain version bit for bit,
        unnormalised and normalised, with the valids as they are and as
        fractional weights (whose sums depend on their order); two runs
        bit-identical."""
        B, N, D = descs.shape
        g = torch.Generator(device=dev).manual_seed(B * N + cents.shape[0])
        frac = torch.rand((B, N), generator=g, device=dev) * valids
        err = 0.0
        for what, w in (("valids", valids), ("fractional weights", frac)):
            for normalize in (False, True):
                got = kbow.bow_quantize_hist(descs, w, cents, normalize=normalize)
                again = kbow.bow_quantize_hist(descs, w, cents, normalize=normalize)
                want = kbow.quantize_hist_plain(descs, w, cents, normalize=normalize)
                torch.cuda.synchronize()
                tag = f"bow_quantize_hist {name} {what} normalize={normalize}"
                check(torch.equal(got, again), f"{tag}: two runs differ")
                e = float((got - want).abs().max())
                check(e == 0.0, f"{tag}: max_abs_err {e} against the plain version")
                err = max(err, e)
        print(
            f"check bow_quantize_hist {name} ({B},{N},{D}) K={cents.shape[0]} "
            f"({kbow.hist_ranks(cents.shape[0])} CTAs a cluster): max_abs_err={err:.3g} "
            "(unnormalised and normalised, valids and fractional weights; two runs bit-identical)"
        )
        max_err["bow_quantize_hist"] = max(max_err["bow_quantize_hist"], err)
        results["checks"][f"bow_quantize_hist {name}"] = {"max_abs_err": err}

    def hist_device_activities(descs, valids, cents):
        """The device activities of one `bow_quantize_hist` call, by
        torch.profiler: the kernel alone, no memset, cast or normalising
        launches."""
        from torch.profiler import ProfilerActivity, profile

        kbow.bow_quantize_hist(descs, valids, cents)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kbow.bow_quantize_hist(descs, valids, cents)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        K = cents.shape[0]
        held = _build.library("bow").quantize_hist_max_clusters(K)
        print(f"check bow_quantize_hist device activities a call (torch.profiler): {names}; "
              f"{descs.shape[0]} clusters of {kbow.hist_ranks(K)} CTAs, the card holds {held} "
              "at once")
        check(len(names) == 1 and "quantize_hist_kernel" in names[0],
              f"bow_quantize_hist: a call ran {names} on the device, not one kernel")

    def check_score(name, h, w, b):
        got = kbow.linear_score(h, w, b)
        want = kbow.linear_score_plain(h, w, b)
        ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
        ok = (got - want).abs() <= 4 * ulp + 1e-30
        check(bool(ok.all()), f"linear_score {name}: off by > 4 ulp")
        err = float((got - want).abs().max())
        print(f"check linear_score {name} {tuple(h.shape)} C={w.shape[0]}: max_abs_err={err:.3g}")
        max_err["linear_score"] = max(max_err["linear_score"], err)
        results["checks"][f"linear_score {name}"] = err

    def check_assign(name, desc, cents):
        got_i, got_d2 = kbow.bow_assign(desc, cents)
        want_i, want_d2 = kbow.bow_assign_plain(desc, cents)
        torch.cuda.synchronize()
        err = max(
            float((got_i - want_i).abs().max()), float((got_d2 - want_d2).abs().max())
        )
        ties = int(near_tie_mask(desc, cents).sum())
        print(
            f"check bow_assign {name} {tuple(desc.shape)} K={cents.shape[0]}: "
            f"max_abs_err={err:.3g} (idx and d2) near_ties={ties}"
        )
        check(err == 0.0, f"bow_assign {name}: differs from its plain version")
        max_err["bow_assign"] = max(max_err["bow_assign"], err)
        results["checks"][f"bow_assign {name}"] = {"max_abs_err": err, "near_ties": ties}
        return got_i

    def check_gbdt(name, x, m):
        got_s, got_li = kgbdt.gbdt_score(x, m.feat, m.thr, m.leaf, m.base)
        want_s, want_li = kgbdt.gbdt_score_plain(x, m.feat, m.thr, m.leaf, m.base)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_s).all()), f"gbdt_score {name}: non-finite scores")
        err = max(
            float((got_s - want_s).abs().max()), float((got_li - want_li).abs().max())
        )
        print(
            f"check gbdt_score {name} {tuple(x.shape)} trees={tuple(m.feat.shape)} "
            f"C={m.leaf.shape[2]}: max_abs_err={err:.3g} (scores and leaf indices)"
        )
        check(err == 0.0, f"gbdt_score {name}: differs from its plain version")
        max_err["gbdt_score"] = max(max_err["gbdt_score"], err)
        results["checks"][f"gbdt_score {name}"] = err
        return got_li

    def unit_rows(*shape):
        t = torch.rand(shape, generator=gen, device=dev)
        return t / t.norm(dim=-1, keepdim=True)

    B, N, D, K, C = 1024, 32, 128, DICT_SIZE, 10
    descs = unit_rows(B, N, D)
    valids = torch.rand((B, N), generator=gen, device=dev) < 0.9
    cents = unit_rows(K, D)
    check_hist("random", descs, valids, cents)
    # rows over one tile of 32 (N = 45, 100), one to eight ranks (K = 5, 33,
    # 250, 700, 1300: at 1300 ranks 0-2 walk two word tiles), a single image
    for b_, n_, k_ in ((1, 32, 250), (3, 45, 5), (2, 100, 33), (2, 100, 700), (5, 45, 250),
                       (2, 40, 1300)):
        check_hist(f"B={b_} N={n_} K={k_}", unit_rows(b_, n_, D),
                   torch.rand((b_, n_), generator=gen, device=dev) < 0.9, unit_rows(k_, D))
    h = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    w = torch.randn((C, K), generator=gen, device=dev)
    b = torch.randn((C,), generator=gen, device=dev)
    check_score("random", h, w, b)

    # bow_assign at N = 32768, K = 250 (the last codebook tile has 26 words
    # and 6 pad rows): word 249 duplicates word 3 and 64 descriptors sit on
    # it, so their best two words tie exactly and the lower index must win
    desc = unit_rows(32 * 1024, D)
    cents_t = cents.clone()
    cents_t[K - 1] = cents_t[3]
    desc[:64] = cents_t[3] + 1e-4 * unit_rows(64, D)
    idx = check_assign("random+ties", desc, cents_t)
    check(bool((idx[:64] == 3).all()), "bow_assign: a tie did not go to the lower word")

    # gbdt_score at B = 1024, F = 250, 16 trees of depth 3, 10 classes; the
    # first 8 rows hold x == thr at every level of tree 0 (goes left: leaf 0)
    T, depth = 16, 3
    feat = torch.randint(0, K, (T, depth), generator=gen, device=dev, dtype=torch.int32)
    feat[0] = torch.arange(depth, dtype=torch.int32, device=dev)
    gm = GbdtModel(
        feat,
        torch.rand((T, depth), generator=gen, device=dev) * 0.02,
        torch.randn((T, 2**depth, C), generator=gen, device=dev),
        torch.randn((C,), generator=gen, device=dev),
        C,
    )
    xg = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    xg[:8, :depth] = gm.thr[0]
    li = check_gbdt("random+boundary", xg.contiguous(), gm)
    check(bool((li[:8, 0] == 0).all()), "gbdt_score: x == thr did not go left")

    # -- 3. the training path on the card, once per head -----------------------
    stream = ImageStream(res=32)
    # integer splits: `hash` of a string is salted per process, of an int not
    imgs, labels = stream.batch(N_TRAIN, split=0)
    test_imgs, test_labels = stream.batch(N_REQUESTS * PREDICT_BATCH, split=1)
    cfgs = {h: PipelineConfig(preprocess=True, n_octaves=1, max_kp=32, head=h) for h in HEADS}
    path_counts = {}
    models, models_cpu = {}, {}
    for head, cfg in cfgs.items():
        timing = {}
        t0 = time.perf_counter()
        model, snap = counted(
            counters,
            lambda: pipeline.train(
                imgs,
                labels,
                cfg,
                dict_size=DICT_SIZE,
                generator=torch.Generator().manual_seed(0),
                device=dev,
                timing=timing,
            ),
        )
        wall = time.perf_counter() - t0
        expect_counts(
            f"train {head}", snap, {"stencil_chain": 1, "stencil_stream": 1, "bow_assign": 21}
        )
        path_counts[f"train {head}"] = snap
        check(bool(torch.isfinite(model.centroids).all()), f"train {head}: non-finite centroids")
        stages = {k: round(v, 4) for k, v in timing.items()}
        print(
            f"train {head} (card): {N_TRAIN} images, K={DICT_SIZE}, wall_s={wall:.3f} "
            f"stages_s={stages} launches={snap['launches']}"
        )
        t0 = time.perf_counter()
        model_cpu = pipeline.train(
            imgs,
            labels,
            cfg,
            dict_size=DICT_SIZE,
            generator=torch.Generator().manual_seed(0),
            device="cpu",
        )
        t_cpu = time.perf_counter() - t0
        print(f"train {head} (CPU, same seed): {t_cpu:.1f} s")
        models[head], models_cpu[head] = model, model_cpu
        results["train"][head] = {"wall_s": wall, "stages_s": timing, "cpu_s": t_cpu}

    # -- 4. the predict path on the card, once per head -------------------------
    batches = test_imgs.split(PREDICT_BATCH)
    test_feats_cpu = pipeline.extract_features(test_imgs, cfgs["svm"], device="cpu")

    def cpu_scores(model, cfg):
        """What `pipeline.predict(model, test_imgs, device="cpu")` computes,
        from the CPU features taken once."""
        plan = classify.build_plan(copy.deepcopy(model).cpu(), cfg, device="cpu")
        return plan.scores(plan.histograms(test_feats_cpu["desc"], test_feats_cpu["valid"]))

    for head, cfg in cfgs.items():
        model = models[head]
        preds, per_batch, walls = [], [], []
        path = {"launches": dict.fromkeys(counters.KERNELS, 0), "plain_calls": {}}
        for i, xb in enumerate(batches):
            timing = {}
            t0 = time.perf_counter()
            pb, snap = counted(
                counters, lambda: pipeline.predict(model, xb, cfg, device=dev, timing=timing)
            )
            walls.append(time.perf_counter() - t0)
            expect_counts(
                f"predict {head} request {i}",
                snap,
                {
                    "stencil_chain": 1,
                    "stencil_stream": 1,
                    "bow_quantize_hist": 1,
                    HEAD_KERNEL[head]: 1,
                },
            )
            for k, v in snap["launches"].items():
                path["launches"][k] += v
            per_batch.append({"counters": snap, "timing": timing})
            preds.append(pb)
            stages_s = {k: round(v, 5) for k, v in timing.items()}
            print(
                f"predict {head} request {i}: launches={snap['launches']} "
                f"plain_calls={snap['plain_calls']} stages_s={stages_s} wall_s={walls[i]:.4f}"
            )
        path_counts[f"predict {head}"] = path
        pred = torch.cat(preds).cpu()
        check(pred.shape == (len(test_labels),), f"predict {head}: shape {tuple(pred.shape)}")
        acc = float((pred.long() == test_labels.long()).float().mean())
        acc_cpu = float(
            (cpu_scores(models_cpu[head], cfg).argmax(1) == test_labels.long()).float().mean()
        )
        print(
            f"accuracy {head}: card-trained {acc:.4f}, CPU-trained {acc_cpu:.4f} on "
            f"{len(pred)} test images (chance 0.1; required > 0.15 and within 0.05)"
        )
        check(acc > 0.15, f"accuracy {head} {acc} not above 0.15")
        check(abs(acc - acc_cpu) <= 0.05, f"accuracy {head}: card {acc} vs CPU-trained {acc_cpu}")

        again = torch.cat([pipeline.predict(model, xb, cfg, device=dev) for xb in batches]).cpu()
        check(torch.equal(pred, again), f"{head}: labels differ between two runs on the card")
        print(f"determinism {head}: labels identical across two runs on the card")

        scores = cpu_scores(model, cfg)
        cpu_pred = scores.argmax(1).to(torch.int32)
        mism = torch.nonzero(cpu_pred != pred).flatten().tolist()
        for i in mism:
            gap = float(scores[i, cpu_pred[i]] - scores[i, pred[i]])
            print(f"mismatch {head} image {i}: card={int(pred[i])} cpu={int(cpu_pred[i])} "
                  f"cpu_gap={gap:.3g}")
        # the card and the CPU run the same arithmetic except f32 atan2/sqrt in
        # the descriptors, whose last ulp can move an orientation bin: allow 1%
        print(f"card vs CPU plain predict {head}: {len(mism)} of {len(pred)} labels differ "
              "(limit 1%)")
        check(len(mism) <= 0.01 * len(pred), f"{head}: card and CPU predictions disagree")
        results["predict"][head] = {
            "accuracy": acc,
            "accuracy_cpu_trained": acc_cpu,
            "mismatches_vs_cpu": len(mism),
            "batches": per_batch,
            "wall_s": walls,
        }
    # -- 5. the paper's filter2D / erode image path, every mode --------------
    slice_cases = image_path_cases(dev, ops, imgproc, features, stencil, ref, ImageStream)
    slice_times = {}
    for case in slice_cases:
        name = case["name"]
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"image path {name}"] = {"resolved": resolved, "max_abs_err": 0.0}
        slice_times[name] = time_image_case(case, planes, resolved, want)
        t = slice_times[name]
        print(f"time {name}: mode None -> {resolved}, ms={t['ms']:.5f} "
              f"stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}, "
              f"{100 * t['stream_share']:.2f}% of bound) window_ms={t['window_ms']:.5f} "
              f"({100 * t['window_share']:.2f}% of bound) "
              f"plain_ms={t['plain_ms']} library_ms={t['library_ms']} bound_ms={t['bound_ms']:.5f} "
              f"({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) card={card}")
    wins = sum(t["stream_ms"] < t["window_ms"] for t in slice_times.values())
    print(f"image path: stencil_stream faster than stencil_chain on {wins} of {len(slice_times)} "
          f"shapes; mode None -> {sorted(collections.Counter(t['resolved'] for t in slice_times.values()).items())}")
    results["image_path"] = slice_times

    # -- 6. the fused-vs-staged-vs-seed pipeline benchmark ---------------------
    seed_times = pipeline_phase(dev, card, max_err, path_counts, results)

    # -- 7. the geometric path -------------------------------------------------
    geometric_phase(dev, card, max_err, path_counts, results)

    # -- 8. the multi-octave pyramid path ---------------------------------------
    pyramid_phase(dev, card, max_err, path_counts, results, (imgs, labels), test_imgs)

    # -- 9. the LM serving path ------------------------------------------------
    lm_out = lm_phase(dev, get_config(LM_ARCH), batch=LM_BATCH, prompt_len=LM_PROMPT,
                      gen_len=LM_GEN, max_err=max_err)
    path_counts[f"generate {LM_ARCH}"] = lm_out["generate"]["counters"]
    results["lm"] = lm_out

    main_launches = {
        k: sum(p["launches"][k] for p in path_counts.values()) for k in counters.KERNELS
    }
    results["path_counts"] = path_counts
    print(f"main-path launches (training x2 + predict x2 + image path + pipeline benchmark + "
          f"geometric path + pyramid path + generate): {main_launches}")
    check(all(v > 0 for v in main_launches.values()), f"a kernel never ran: {main_launches}")

    # -- 10. the kernels on the paths' own tensors, then timing -----------------
    xb = batches[0].to(dev).float()
    gray = features._normalize_gray(imgproc.preprocess_bow(xb))
    det = features.detect_keypoints(imgproc.preprocess_bow(xb), max_kp=cfgs["svm"].max_kp)
    d = features.describe_keypoints(det)
    qd, qv = d["desc"].contiguous(), d["valid"]
    m_svm, m_gbdt = models["svm"], models["gbdt"].gbdt
    cents_g = models["svm"].centroids.contiguous()
    hist = kbow.bow_quantize_hist(qd, qv, cents_g)
    hist_g = kbow.bow_quantize_hist(qd, qv, models["gbdt"].centroids.contiguous())
    wg, bg = m_svm.w.contiguous(), m_svm.b.contiguous()
    train_desc = pipeline.extract_features(imgs, cfgs["svm"], device=dev)["desc"]
    train_desc = train_desc.reshape(-1, train_desc.shape[-1]).contiguous()
    # each kernel against its plain version on the paths' own tensors
    check_chain("preprocess main path", xb, pre_chain)
    check_chain("octave main path", gray[..., None], oct_chain)
    check_hist("main path", qd, qv, cents_g)
    hist_device_activities(qd, qv, cents_g)
    check_score("main path", hist, wg, bg)
    check_assign("training descriptors", train_desc, cents_g)
    check_gbdt("main path", hist_g, m_gbdt)
    f32 = 4
    n_oct = ref.to_planes(gray[..., None]).numel()
    n_tr, k_w = train_desc.shape[0], cents_g.shape[0]
    g_out = hist_g.shape[0] * (m_gbdt.leaf.shape[2] + m_gbdt.feat.shape[0])
    kernels = [
        {
            "name": "stencil_chain",
            "source": "src/repro_torch/csrc/stencil_chain.cu",
            "replaces": "src/repro/kernels/stencil/exec_window.py:427",
            # what a request launches it for: the octave on 32x32 planes
            # (no larger than the ladder's 34-pixel halo)
            "run": lambda: stencil.fused_chain(gray[..., None], oct_chain),
            "plain": lambda: stencil.fused_chain(gray[..., None], oct_chain, mode="ref"),
            "library": None,
            # also as device time: a CUDA graph of 100 calls replayed (a
            # call's event time includes the host's planning)
            "graph": True,
            # the input read once, every band written once
            "bytes": f32 * n_oct * (1 + len(oct_chain)),
            "flops": n_oct * chain_flops(oct_chain),
            "shape": f"octave of a request of {PREDICT_BATCH} images",
        },
        {
            "name": "stencil_stream",
            "source": "src/repro_torch/csrc/stencil_stream.cu",
            "replaces": "src/repro/kernels/stencil/exec_streaming.py:89",
            "measured": slice_times[STREAM_ENTRY],
            "shape": f"{STREAM_ENTRY}, mode=None ({slice_times[STREAM_ENTRY]['resolved']})",
        },
        {
            "name": "bow_quantize_hist",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:135",
            "run": lambda: kbow.bow_quantize_hist(qd, qv, cents_g),
            "plain": lambda: kbow.quantize_hist_plain(qd, qv, cents_g, normalize=True),
            "library": None,
            "graph": True,
            # descriptors, valids (in their own dtype) and codebook read once,
            # the histograms written once
            "bytes": f32 * (qd.numel() + cents_g.numel() + hist.numel())
            + qv.numel() * qv.element_size(),
            "flops": 2 * qd.shape[0] * qd.shape[1] * cents_g.shape[0] * qd.shape[2],
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "linear_score",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:227",
            "run": lambda: kbow.linear_score(hist, wg, bg),
            "plain": lambda: kbow.linear_score_plain(hist, wg, bg),
            "library": lambda: torch.addmm(bg, hist, wg.T),
            # also as device time: a CUDA graph of 100 calls replayed, as
            # for the seed kernels (a call's event time is host-bound here)
            "graph": True,
            "bytes": f32 * (hist.numel() + wg.numel() + bg.numel() + hist.shape[0] * wg.shape[0]),
            "flops": 2 * hist.shape[0] * wg.shape[0] * wg.shape[1],
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "bow_assign",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:55",
            "run": lambda: kbow.bow_assign(train_desc, cents_g),
            "plain": lambda: kbow.bow_assign_plain(train_desc, cents_g),
            "library": None,
            "graph": True,
            # descriptors and codebook read once; word index (i32) and d2 written once
            "bytes": f32 * (train_desc.numel() + cents_g.numel() + 2 * n_tr),
            "flops": 2 * n_tr * k_w * train_desc.shape[1],
            "shape": f"one assignment of the {n_tr} training descriptors",
        },
        {
            "name": "gbdt_score",
            "source": "src/repro_torch/csrc/gbdt.cu",
            "replaces": "src/repro/kernels/gbdt.py:42",
            "run": lambda: kgbdt.gbdt_score(
                hist_g, m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base
            ),
            "plain": lambda: kgbdt.gbdt_score_plain(
                hist_g, m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base
            ),
            "library": None,
            # also as device time: a CUDA graph of 100 calls replayed (a
            # call's event time is host-bound)
            "graph": True,
            "bytes": f32
            * (
                hist_g.numel()
                + sum(t.numel() for t in (m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base))
                + g_out
            ),
            # one compare per (row, tree, level), one add per (row, tree, class) + the base
            "flops": hist_g.shape[0]
            * (m_gbdt.feat.numel() + m_gbdt.leaf.shape[0] * m_gbdt.leaf.shape[2] + m_gbdt.leaf.shape[2]),
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "flash_attention",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/attention.py:31",
            "measured": lm_out["flash"],
            "shape": f"layer 0 of the {LM_ARCH} prefill, ({LM_BATCH}, {LM_PROMPT}, 16, 256) bf16",
        },
        *(
            {
                "name": name,
                "source": "src/repro_torch/csrc/unfused.cu",
                "replaces": f"benchmarks/unfused_baseline.py:{line}",
                "measured": seed_times[name],
                "shape": "one 512x512 u8 plane of the pipeline batch",
            }
            for name, line in (("seed_gaussian_blur", 51), ("seed_erode", 65),
                               ("seed_threshold", 80))
        ),
    ]
    lib_check = torch.addmm(bg, hist, wg.T)
    ok = torch.allclose(lib_check, kbow.linear_score(hist, wg, bg), rtol=1e-5, atol=1e-5)
    check(bool(ok), "linear_score disagrees with torch.addmm")
    line = []
    for k in kernels:
        if "measured" in k:  # timed in phase 5, 6, 7 or 9 on its path's shape
            t = k["measured"]
            (k1, k2), (p1, p2), lib = t["ms_runs"], t["plain_runs"], t["library_ms"]
            bms, by = t["bound_ms"], t["bound_by"]
            k["bytes"], k["flops"] = t["bytes"], t["flops"]
        else:
            # plain, kernel, kernel, plain: the two versions alternate on one card
            p1 = time_ms(k["plain"], iters=5)
            k1 = time_ms(k["run"], iters=50)
            k2 = time_ms(k["run"], iters=50)
            p2 = time_ms(k["plain"], iters=5)
            lib = time_ms(k["library"], iters=50) if k["library"] else None
            bms, by = bound_ms(k["bytes"], k["flops"])
        entry = {
            "name": k["name"],
            "route": "cuda",
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": main_launches[k["name"]],
            "max_abs_err": max_err[k["name"]],
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib,
        }
        if k.get("graph"):
            graph_ms = load_bench().graph_ms
            k_g = [graph_ms(k["run"], reps=100) for _ in range(2)]
            entry |= {"graph_ms": min(k_g)}
            lib_txt = ""
            if k["library"]:
                lib_g = [graph_ms(k["library"], reps=100) for _ in range(2)]
                entry |= {"library_graph_ms": min(lib_g)}
                lib_txt = f" library_ms={lib_g[0]:.5f}/{lib_g[1]:.5f}"
            print(f"time {k['name']} graph replay of 100 calls: ms={k_g[0]:.5f}/{k_g[1]:.5f}"
                  f"{lib_txt} card={card}")
        if k["name"] == "stencil_chain":
            floor = window_floor_ms(oct_chain, tuple(ref.to_planes(gray[..., None]).shape),
                                    torch.float32)
            results["window_floor"] = floor
            print(f"window arithmetic of the octave of a request: cut frames "
                  f"{floor['cut']['flops']:.0f} FLOP ({floor['cut']['ms']:.5f} ms at 67 TFLOP/s), "
                  f"full windows {floor['full']['flops']:.0f} FLOP ({floor['full']['ms']:.5f} ms) "
                  f"card={card}")
        line.append(entry)
        print(
            f"time {k['name']} ({k['shape']}): ms={k1:.5f}/{k2:.5f} "
            f"plain_ms={p1:.4f}/{p2:.4f} "
            f"library_ms={lib} bound_ms={bms:.5f} ({by}; {k['bytes']} B, {k['flops']} FLOP) "
            f"card={card}"
        )
        results["timing"][k["name"]] = entry | {"ms_runs": [k1, k2], "plain_runs": [p1, p2]}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1, default=str))

    print(json.dumps({"kernels": line}))
    print(f"card: {card_line()}")
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
