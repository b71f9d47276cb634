#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure is caught and carried past):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` with nvcc, one process per source, and print
     the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     shapes beyond the BoW path's (phase 7 repeats it on the path's tensors);
     each chain runs under the kernel `mode=None` resolves to and under the
     window kernel;
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
     the BoW preprocess chain on the same batch in f32; one octave ladder on
     a 512x512 f32 plane.  Each shape runs in every mode (None, window,
     streaming, tiled2d), one launch of the named kernel each and no plain
     call, max_abs_err 0 against the plain version, and the three kernel
     modes bit-identical; a full-width streaming plan over the
     shared-memory budget must raise `ValueError`.  Then `stencil_stream`
     and `stencil_chain` are timed on each shape, the plain version on the
     4K shapes, and `conv2d` as the library call for gaussian_filter2d
     k = 5 and 13;
  6. the LM serving path (`lm_phase`): gemma-7b at full width (28 layers,
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
     the prefill and a decode step are timed; last, the same weights
     widened to f32: the kernel and plain paths' final hidden states at
     every prompt position within 2e-4 and last-token logits within 2e-3,
     and the bf16 paths' logits within twice the bf16 model's own error;
  7. on the paths' own tensors (the first request, the training
     descriptors and final centroids), hold each kernel against its plain
     version again, then time each kernel, its plain version and (for
     `linear_score`) one PyTorch call computing the same function;
  8. print the ``kernels`` JSON line (all seven kernels; `stencil_stream` at
     the 4K u8 gaussian_filter2d k = 13 under mode=None, `flash_attention`
     at the prefill's layer 0), then the card line and the device line.

Each path is driven with the launch counters set to 0 just before it and
read just after; a kernel's ``launches`` in the JSON line sums the paths'.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import math
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


def chain_flops(stages) -> int:
    """FLOP per output pixel of a chain (the image domain, halo excluded)."""
    total = 0
    for s in stages:
        if s.op == "filter2d":
            total += 2 * s.weights[0].numel()  # a product and a sum per tap
        elif s.op == "sep_filter":
            total += 2 * (s.weights[0].numel() + s.weights[1].numel())
        elif s.op in ("erode", "dilate"):
            total += 2 * (2 * s.static[0])  # separable min / max: row + column compares
        elif s.op == "box":
            total += 2 * (2 * s.static[0]) + 1  # row + column sums, one scaling
        elif s.op == "threshold":
            total += 1
        elif s.op == "affine":
            total += 2
        elif s.op == "grad_mag":
            total += 7  # 2 sub, 2 scale, 2 square, 1 add (+ sqrt)
        else:
            raise ValueError(f"chain_flops: no count for stage op {s.op!r}")
    return total


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


RES = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}


def image_path_cases(dev, ops, imgproc, features, stencil, ref, ImageStream) -> list:
    """The third slice's shapes: the paper's filter2D (Tables 1-3) and erode
    (Tables 4-6) benches at their sizes, the acceptance chain of
    benchmarks/pipeline_bench.py, the BoW preprocess chain and one octave
    ladder.  Images come from `ImageStream().image`, seeded per image."""
    import torch

    stream = ImageStream()
    cases = []

    def add(name, img, chain, call):
        cases.append({"name": name, "img": img, "chain": chain, "call": call})

    for res in ("1080p", "4K"):
        img = stream.image(RES[res], seed=0).to(dev)
        for k in (3, 5, 7, 9, 11, 13):
            k1 = ref.gaussian_kernel1d(k)
            chain = (stencil.filter_stage(torch.outer(k1, k1)),)
            add(f"gaussian_filter2d k={k} {res} u8", img, chain,
                lambda mode, img=img, k=k: ops.gaussian_filter2d(img, k, mode=mode))
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
    add("octave (512,512) f32", plane, features.octave_chain(4),
        lambda mode: tuple(features.gaussian_octave(plane[None], mode=mode)[0].unbind(0)))
    return cases


def time_image_case(case, planes, resolved, want, stencil, ref) -> dict:
    """Kernel times on the planes (the kernel the case resolves to, and the
    window kernel), the plain version's on the 4K shapes, and for the
    Gaussian filter2D at k = 5 and 13 one `conv2d` of the edge-padded f32
    image (TF32 off, padding outside the timed call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    chain, name = case["chain"], case["name"]
    tiled = resolved == "tiled2d"
    if resolved == "window":
        raise SmokeFailure(f"{name}: resolves to the window kernel, not stencil_stream")
    run = lambda: exec_streaming.stencil_stream(planes, chain, tiled=tiled)  # noqa: E731
    win = lambda: exec_window.stencil_chain(planes, chain)  # noqa: E731
    plain = lambda: exec_streaming.stencil_stream_plain(planes, chain)  # noqa: E731
    has_plain = " 4K " in name
    p1 = time_ms(plain, iters=3, warmup=1) if has_plain else None
    k1 = time_ms(run, iters=20)
    w1 = time_ms(win, iters=20)
    k2 = time_ms(run, iters=20)
    w2 = time_ms(win, iters=20)
    p2 = time_ms(plain, iters=3, warmup=1) if has_plain else None
    lib = None
    k = chain[0].weights[0].shape[0] if chain[0].op == "filter2d" else 0
    if k in (5, 13):
        h = k // 2
        x = ref.pad_replicate(planes.float(), h, h)[:, None].contiguous()
        wt = chain[0].weights[0].to(planes.device)[None, None].contiguous()
        conv = F.conv2d(x, wt)[:, 0]
        packed = torch.clamp(torch.round(conv), 0, 255)
        diff = float((packed - want[0].reshape(packed.shape).float()).abs().max())
        check(diff <= 1.0, f"{name}: conv2d differs from the plain version by {diff}")
        lib = time_ms(lambda: F.conv2d(x, wt), iters=20)
    item = planes.element_size()
    n_px = planes.numel()
    n_bytes = item * n_px * (1 + len(want))
    n_flops = n_px * chain_flops(chain)
    bms, by = bound_ms(n_bytes, n_flops)
    return {
        "resolved": resolved,
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        "window_ms": min(w1, w2),
        "window_runs": [w1, w2],
        "plain_ms": None if p1 is None else min(p1, p2),
        "plain_runs": None if p1 is None else [p1, p2],
        "library_ms": lib,
        "bound_ms": bms,
        "bound_by": by,
        "bytes": n_bytes,
        "flops": n_flops,
    }


def flash_bound(q, k, causal: bool = True) -> dict:
    """The least time one flash-attention call could take on the card: q, k,
    v read once and o written once, over the memory rate; or 2 FLOP per
    (query, key, channel) for q.k and as many for p.v, over the (query, key)
    pairs the mask keeps.  q.k multiplies operands of q's dtype: a bf16 or
    f16 product is exact in f32, so it runs at the tensor cores' rate; p.v
    takes f32 probabilities, so it runs at the f32 rate."""
    import torch

    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    half = 2 * B * H * hd * pairs
    qk_rate = PEAK_FP32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (half / qk_rate + half / PEAK_FP32_FLOPS) * 1e3
    return {"bytes": n_bytes, "flops": 2 * half, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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
    `AGREE` on the path's own tensors (every layer's q, k, v of the bf16
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
        checks[f"{name} {tuple(q.shape)} {q.dtype} causal={causal}"] = {
            "max_abs_err": err, "share_of_tol": excess, "share_of_jax_test_tol": excess_jax}
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
    print(f"time flash_attention ({tuple(q.shape)} {q.dtype} causal): ms={k1:.4f}/{k2:.4f} "
          f"plain_ms={p1:.3f}/{p2:.3f} sdpa_ms={lib:.4f} bound_ms={t['bound_ms']:.4f} "
          f"({t['bound_by']}: q.k on the tensor cores, p.v in f32; {t['bytes']} B, "
          f"{t['flops']} FLOP) share of the bound={t['bound_ms'] / min(k1, k2):.3f}; "
          f"all-f32 bound_ms={t['bound_ms_all_f32']:.4f}")
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
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    results["build_s"] = t_build

    pre_chain = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    oct_chain = features.octave_chain(4)
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

    def check_hist(name, descs, valids, cents):
        got = kbow.bow_quantize_hist(descs, valids, cents, normalize=False)
        want = kbow.quantize_hist_plain(descs, valids, cents)
        B, N, D = descs.shape
        ties = (near_tie_mask(descs, cents) & valids.reshape(-1)).reshape(B, N).sum(1)
        l1 = (got - want).abs().sum(1)
        check(bool((l1 <= 2 * ties).all()), f"bow_quantize_hist {name}: differs off near-ties")
        err = float((got - want).abs().max())
        print(
            f"check bow_quantize_hist {name} ({B},{N},{D}) K={cents.shape[0]}: "
            f"max_abs_err={err:.3g} near_ties={int(ties.sum())} "
            f"images_differing={int((l1 > 0).sum())}"
        )
        max_err["bow_quantize_hist"] = max(max_err["bow_quantize_hist"], err)
        results["checks"][f"bow_quantize_hist {name}"] = {
            "max_abs_err": err,
            "near_ties": int(ties.sum()),
        }

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
    imgs, labels = stream.batch(N_TRAIN, split="train")
    test_imgs, test_labels = stream.batch(N_REQUESTS * PREDICT_BATCH, split="test")
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
        name, img, chain, call = case["name"], case["img"], case["chain"], case["call"]
        want = as_tuple(stencil.fused_chain(img, chain, mode="ref"))
        planes = ref.to_planes(img)
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
                  f"max_abs_err={err}")
        for mode in ("streaming", "tiled2d"):
            if mode in outs:
                same = all(torch.equal(a, b) for a, b in zip(outs[mode], outs["window"]))
                check(same, f"{name}: {mode} differs from window")
        print(f"check {name}: window, streaming and tiled2d bit-identical "
              f"({'streaming over budget' if 'streaming' not in outs else 'all three ran'})")
        results["checks"][f"image path {name}"] = {"resolved": resolved, "max_abs_err": 0.0}
        slice_times[name] = time_image_case(case, planes, resolved, want, stencil, ref)
        t = slice_times[name]
        print(f"time {name}: stream_ms={t['ms']:.5f} ({resolved}) window_ms={t['window_ms']:.5f} "
              f"plain_ms={t['plain_ms']} library_ms={t['library_ms']} bound_ms={t['bound_ms']:.5f} "
              f"({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) card={card}")
    results["image_path"] = slice_times

    # -- 6. the LM serving path ------------------------------------------------
    lm_out = lm_phase(dev, get_config(LM_ARCH), batch=LM_BATCH, prompt_len=LM_PROMPT,
                      gen_len=LM_GEN, max_err=max_err)
    path_counts[f"generate {LM_ARCH}"] = lm_out["generate"]["counters"]
    results["lm"] = lm_out

    main_launches = {
        k: sum(p["launches"][k] for p in path_counts.values()) for k in counters.KERNELS
    }
    results["path_counts"] = path_counts
    print(f"main-path launches (training x2 + predict x2 + image path + generate): "
          f"{main_launches}")
    check(all(v > 0 for v in main_launches.values()), f"a kernel never ran: {main_launches}")

    # -- 7. the kernels on the paths' own tensors, then timing ------------------
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
            "plain": lambda: kbow.normalize_hist(kbow.quantize_hist_plain(qd, qv, cents_g)),
            "library": None,
            "bytes": f32 * (qd.numel() + qv.numel() + cents_g.numel() + hist.numel()),
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
    ]
    lib_check = torch.addmm(bg, hist, wg.T)
    ok = torch.allclose(lib_check, kbow.linear_score(hist, wg, bg), rtol=1e-5, atol=1e-5)
    check(bool(ok), "linear_score disagrees with torch.addmm")
    line = []
    for k in kernels:
        if "measured" in k:  # timed in phase 5 or 6 on its path's shape
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
